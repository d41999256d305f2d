"""Serving entry point: ``python -m repro_torch.launch.serve`` runs a gLava
:class:`repro_torch.api.GraphStream` session against a synthetic
network-traffic stream, with a mixed query workload served as ONE standing
subscription, re-evaluated every ``--every`` ingest batches, and prints
throughput stats.

Port of ``src/repro/launch/serve.py`` (same flags plus ``--device``).  The
session runs on the CUDA device unless ``--device cpu`` is given.
``--window-slices K`` serves a sliding window of K slices; ``--slice-width``
(with ``--window-slices``) gives the stream per-edge event times, drawn as
the reference draws them, so the watermark drives the window's advances and
late edges are routed or retracted; ``--max-lateness`` bounds their
out-of-orderness; ``--wal-dir`` logs every batch before its dispatch.

``--tenants T`` switches to FLEET mode: the same synthetic stream is tagged
with zipf-distributed tenant ids and served by one
:class:`repro_torch.fleet.SketchFleet` — every mixed batch is one stacked
ingest launch on the card — with standing workloads on the three hottest
tenants; the driver prints fleet-wide throughput and the stacked kernel's
launches per batch (where the reference prints its one-compile cache stat).
The backend flags apply to the fleet too; the event-time flags do not (the
fleet windows by explicit advances, as the reference's does)."""
from __future__ import annotations

import argparse
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.api import GraphStream, Query, QueryBatch, SketchConfig
from repro_torch.api.subscription import Subscription, SubscriptionEvent
from repro_torch.core.ingest import BACKENDS
from repro_torch.core.query_engine import QUERY_BACKENDS
from repro_torch.data.graphs import edge_stream
from repro_torch.fleet import SketchFleet
from repro_torch.kernels.ingest_stacked.ops import stacked_ingest


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--nodes", type=int, default=100_000)
    ap.add_argument("--edges", type=int, default=500_000)
    ap.add_argument("--batch", type=int, default=50_000)
    ap.add_argument("--window-slices", type=int, default=0)
    ap.add_argument(
        "--every",
        type=int,
        default=1,
        help="re-evaluate the standing workload every k ingest batches",
    )
    ap.add_argument(
        "--ingest-backend",
        default="auto",
        choices=["auto", *BACKENDS],
        help="auto = the CUDA scatter kernel on a CUDA device, scatter on the CPU",
    )
    ap.add_argument(
        "--query-backend",
        default="auto",
        choices=["auto", *QUERY_BACKENDS],
        help="auto = the CUDA multi-query and closure kernels on a CUDA device, "
        "plain torch on the CPU",
    )
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--tenants", type=int, default=0, help="serve T tenants as one SketchFleet (0 = single session)")
    ap.add_argument(
        "--wal-dir",
        default=None,
        help="write-ahead-log directory: every batch is durably logged before its device dispatch",
    )
    ap.add_argument(
        "--slice-width",
        type=float,
        default=0.0,
        help="event-time slice width: with --window-slices, the stream carries per-edge "
        "timestamps and the watermark drives advances",
    )
    ap.add_argument(
        "--max-lateness",
        type=float,
        default=0.0,
        help="bounded out-of-orderness: edges older than the watermark minus this are late "
        "(retracted via the turnstile-delete path)",
    )
    return ap


def open_stream(args: argparse.Namespace) -> GraphStream:
    """The session the flags describe (no traffic yet)."""
    return GraphStream.open(
        _config(args),
        device=args.device,
        window_slices=args.window_slices or None,
        ingest_backend=args.ingest_backend,
        query_backend=args.query_backend,
        wal_dir=args.wal_dir,
        slice_width=args.slice_width or None,
        max_lateness=args.max_lateness if args.slice_width else None,
    )


def _config(args: argparse.Namespace) -> SketchConfig:
    return SketchConfig(depth=args.depth, width_rows=args.width, width_cols=args.width)


def traffic(args: argparse.Namespace) -> Tuple[dict, Optional[np.ndarray], QueryBatch]:
    """The edge stream, its event times (None without ``--slice-width``) and
    the standing workload, drawn from one seeded generator in the
    reference's order."""
    rng = np.random.default_rng(0)
    data = edge_stream(args.nodes, args.edges, rng, zipf_a=1.2)
    ts_all = None
    if args.slice_width:
        # Synthetic event time: one slice per ingest batch, with bounded
        # out-of-orderness (uniform lag within --max-lateness), so the
        # watermark path and late routing run.
        base = np.arange(args.edges, dtype=np.float64) * (args.slice_width / args.batch)
        ts_all = base - rng.uniform(0.0, max(args.max_lateness, 0.0), args.edges)
        ts_all = np.maximum(ts_all, 0.0)
    # The monitoring workload is STANDING: the same mixed batch re-asked
    # after every ingest batch, compiled once by the planner.
    qs = rng.integers(0, args.nodes, 1024).astype(np.uint32)
    qd = rng.integers(0, args.nodes, 1024).astype(np.uint32)
    workload = QueryBatch(
        [
            Query.edge(qs, qd),
            Query.in_flow(qs[:256]),
            Query.heavy(qs[:64], theta=0.01),
            Query.reach(qs[:64], qd[:64]),
        ]
    )
    return data, ts_all, workload


def run(args: argparse.Namespace) -> Tuple[GraphStream, Subscription, List[SubscriptionEvent]]:
    """Drive one session: open, subscribe the standing workload, ingest the
    stream batch by batch.  Returns the session, the subscription and the
    events it emitted (in tick order)."""
    return drive(open_stream(args), args)


def drive(stream: GraphStream, args: argparse.Namespace) -> Tuple[GraphStream, Subscription, List[SubscriptionEvent]]:
    """Subscribe the standing workload on ``stream`` and ingest the flags'
    traffic into it, batch by batch (``run`` on a session opened
    elsewhere, e.g. with a checkpoint directory)."""
    data, ts_all, workload = traffic(args)
    sub = stream.subscribe(workload, every=args.every, name="mixed-workload")
    for lo in range(0, args.edges, args.batch):
        hi = min(args.edges, lo + args.batch)
        stream.ingest(
            data["src"][lo:hi],
            data["dst"][lo:hi],
            data["weight"][lo:hi],
            timestamps=None if ts_all is None else ts_all[lo:hi],
        )
    return stream, sub, sub.poll()


def open_fleet(args: argparse.Namespace) -> SketchFleet:
    """The fleet the flags describe (no traffic yet)."""
    return SketchFleet.open(
        _config(args),
        capacity=args.tenants,
        window_slices=args.window_slices or None,
        wal_dir=args.wal_dir,
        device=args.device,
        ingest_backend=args.ingest_backend,
        query_backend=args.query_backend,
    )


def fleet_traffic(args: argparse.Namespace) -> Tuple[dict, np.ndarray, QueryBatch]:
    """The edge stream, its zipf-skewed tenant ids (a few hot tenants
    dominate, as in real fleets) and the hot tenants' standing workload,
    drawn from one seeded generator in the reference's order."""
    rng = np.random.default_rng(0)
    data = edge_stream(args.nodes, args.edges, rng, zipf_a=1.2)
    ids = (rng.zipf(1.3, args.edges) - 1) % args.tenants
    qs = rng.integers(0, args.nodes, 256).astype(np.uint32)
    qd = rng.integers(0, args.nodes, 256).astype(np.uint32)
    workload = QueryBatch([Query.edge(qs[:64], qd[:64]), Query.in_flow(qs[:64]), Query.reach(qs[:16], qd[:16])])
    return data, ids, workload


def drive_fleet(fleet: SketchFleet, args: argparse.Namespace) -> Tuple[SketchFleet, List[Subscription]]:
    """Subscribe the standing workload on the three hottest tenants (0, 1,
    2) and ingest the flags' tenant-tagged traffic, one mixed batch at a
    time.  Returns the fleet and the subscriptions."""
    data, ids, workload = fleet_traffic(args)
    subs = [
        fleet.tenant(t).subscribe(workload, every=args.every, name=f"tenant-{t}")
        for t in range(min(3, args.tenants))
    ]
    for lo in range(0, args.edges, args.batch):
        hi = min(args.edges, lo + args.batch)
        fleet.ingest_mixed(ids[lo:hi], data["src"][lo:hi], data["dst"][lo:hi], data["weight"][lo:hi])
    return fleet, subs


def main_fleet(args: argparse.Namespace) -> Tuple[SketchFleet, List[Subscription]]:
    """Fleet mode: open, drive, print the ``[serve-fleet]`` lines."""
    launches = stacked_ingest.launches
    fleet, subs = drive_fleet(open_fleet(args), args)
    stats = fleet.summary()
    launches = stacked_ingest.launches - launches
    print("[serve-fleet] " + " ".join(f"{k}={v:,.1f}" for k, v in stats.items()))
    print(
        f"[serve-fleet] ingest launches={launches} ({launches / max(stats['batches'], 1):g} a batch) "
        f"dispatches={fleet._ingest.dispatches} subs={[s.ticks for s in subs]} ticks device={fleet.device}"
    )
    return fleet, subs


def main(argv: Optional[Sequence[str]] = None):
    args = build_parser().parse_args(argv)
    if args.tenants:
        return main_fleet(args)
    stream, sub, ticks = run(args)
    stats = stream.summary()
    print("[serve] " + " ".join(f"{k}={v:,.1f}" for k, v in stats.items()))
    print(
        f"[serve] subscription {sub.name!r}: {sub.ticks} ticks "
        f"({len(ticks)} events pending), last epoch {ticks[-1].epoch if ticks else '-'}, "
        f"closure full={stream.engine.closure_refreshes} "
        f"incremental={stream.engine.closure_incremental_refreshes} "
        f"device={stream.device}"
    )
    return stream, sub, ticks


if __name__ == "__main__":
    main()
