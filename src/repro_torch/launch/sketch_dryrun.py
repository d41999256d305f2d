"""Sketch-plane dry run: the paper's own structure on a mesh of ranks,
measured on the card rather than lowered.  Port of
``src/repro/launch/sketch_dryrun.py``.

One ingest batch of ``--batch`` edges (2^20) goes through
:func:`~repro_torch.core.distributed.distributed_ingest` (the stream over
the ``data`` axis, the rows over ``model``, the delta all-reduce), and
``--queries`` edge queries (65,536) through
:func:`~repro_torch.core.distributed.distributed_edge_query`.  Each call is
run once to warm up (kernel builds, a communicator's set-up), then once
under the cost counter of ``repro_torch.analysis.costlint`` (aten ops by
kind, kernel wrappers by their declared costs) with the mesh's record of
its all-reduces, which give the modelled compute, memory and collective
terms (``repro_torch.roofline.analysis``), then once more timed: device
milliseconds from the profiler's trace of the card's kernels and copies
(from CUDA events around the calls when no complete trace comes back), the
host's wall clock, and the rise of the card's peak allocation over the
call.  Each record holds the modelled terms beside the
measured times and the fraction ``bound / measured`` of each.

Run it on one rank (NCCL on the card; in this process) or on several
spawned gloo ranks (``repro_torch.distributed.spawn``), which on one card
all share it::

    python -m repro_torch.launch.sketch_dryrun --config base
    python -m repro_torch.launch.sketch_dryrun --config base --ranks 4 --mesh 2,2 --backend gloo
    python -m repro_torch.launch.sketch_dryrun --device cpu --config smoke --batch 4096 --queries 1024

Records go to ``--out`` (``results/dryrun_torch/``), one JSON file a
(config, mesh), with the reference's keys (``cell``, ``mesh``, ``sketch``,
``roofline``, ``collectives``, ``query_roofline``) and the measured ones
(``measured``, ``query_collectives``, ``device``).

WEB (d=4, 65,536², 68.7 GB of counters) is the reference's default and is
refused here: ``distributed_ingest`` clones the shard every batch
(``core/distributed.py``, the reference's delta merge), so one rank needs
twice the counters, 137 GB, and one H100 holds 80 GB.  A touched-cell
all-reduce would lift that (ROADMAP B).
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.roofline.analysis import HW

CONFIGS = ("base", "nonsquare", "web", "smoke")


def rank_bytes(config, mesh_shape: Tuple[int, int], batch: int) -> int:
    """Device bytes one rank needs: its counter shard twice (the shard and
    ``distributed_ingest``'s per-batch clone), the replicated registers, and
    the batch's hashed buckets."""
    shard = 4 * config.depth * (config.width_rows // mesh_shape[1]) * config.width_cols
    registers = 4 * config.depth * (config.width_rows + config.width_cols)
    return 2 * shard + registers + 2 * 8 * config.depth * batch


def _config(name: str):
    from repro_torch.configs import glava

    return getattr(glava, name.upper())


# Spin kernels a trace starts with, left out of its reading: a profiler
# session may come back without the records of the first kernels it saw.
PREROLL_SPINS, PREROLL_CYCLES = 8, 250_000


def _device_ms(fn, device: str, tries: int, reps: int = 5) -> Optional[float]:
    """Device milliseconds a call: the card's kernels and copies in a
    profiler trace of ``reps`` calls, counted only when the trace holds
    ``reps`` times the events of a one-call trace (a trace that lost
    launches is not read as a faster call).  None on the CPU, or when no
    complete trace came back in ``tries`` tries (one on a mesh of several
    ranks, whose calls must stay in step)."""
    if torch.device(device).type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile

    def trace(calls):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(PREROLL_SPINS):
                torch.cuda._sleep(PREROLL_CYCLES)
            torch.cuda.synchronize()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        sel = [e for e in prof.key_averages()
               if getattr(e, "device_time_total", 0.0) and "spin_kernel" not in e.key]
        return sum(e.count for e in sel), sum(e.device_time_total for e in sel)

    for _ in range(tries):
        per_call, _ = trace(1)
        count, total_us = trace(reps)
        if per_call and count == per_call * reps:
            return total_us / reps / 1e3
    return None


def _events_ms(fn, device: str, reps: int = 5) -> Optional[float]:
    """Milliseconds a call between two CUDA events around ``reps`` calls on
    the current stream (the host's gaps included where the card waits for
    it); None on the CPU."""
    if torch.device(device).type != "cuda":
        return None
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _wall_ms(fn, device: str) -> float:
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    if cuda:
        torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def _measure(fn, mesh, device: str, model_flops: float):
    """Warm up, trace (modelled terms) and time one call of ``fn``."""
    from repro_torch.analysis.costlint import CostCounter
    from repro_torch.analysis.dispatch_lint import Recorder
    from repro_torch.roofline.analysis import parse_collectives, roofline_from_cost, traced_cost_dict

    fn()
    mesh.collectives.clear()
    counter = CostCounter()
    with Recorder(counter):
        fn()
    colls = parse_collectives(list(mesh.collectives))
    rf = roofline_from_cost(traced_cost_dict(counter), colls, mesh.size(mesh.axis_names), model_flops)
    # Every rank makes the same calls: one profiler try on a mesh of several
    # ranks, and the events' timing always.
    prof_ms = _device_ms(fn, device, tries=5 if mesh.size(mesh.axis_names) == 1 else 1)
    events_ms = _events_ms(fn, device)
    dev_ms = prof_ms if prof_ms is not None else events_ms
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
    wall_ms = _wall_ms(fn, device)
    peak = torch.cuda.max_memory_allocated() - before if cuda else None
    measured_s = (dev_ms if dev_ms is not None else wall_ms) / 1e3
    measured = {
        "device_ms": dev_ms,
        "device_source": None if dev_ms is None else ("profiler" if prof_ms is not None else "events"),
        "events_ms": events_ms,
        "wall_ms": wall_ms,
        "peak_alloc_bytes": peak,
        "bound_ms": rf.step_time_lb * 1e3,
        "fraction": rf.step_time_lb / measured_s if measured_s else None,
        "fraction_of": "device" if dev_ms is not None else "wall",
        "work": counter.work,
        "bytes": counter.bytes,
        "kernels": sorted({name for name, _, _ in counter.kernels}),
    }
    return rf, colls, measured


def rank_run(rank: int, world: int, workdir, config_name: str, batch: int, queries: int,
             mesh_shape: Sequence[int], device: str, seed: int) -> Dict:
    """One rank's dry run on the default process group (initialised by the
    caller): the record, the same on every rank but for the times."""
    from repro_torch.core.distributed import distributed_edge_query, distributed_ingest, empty_shard
    from repro_torch.distributed.mesh import Mesh
    from repro_torch.roofline.analysis import model_flops_for

    if torch.device(device).type == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _config(config_name)
    mesh = Mesh(tuple(mesh_shape), ("data", "model"))
    shard = empty_shard(mesh, cfg, seed, torch.device(device))
    gen = torch.Generator().manual_seed(seed)
    src = torch.randint(0, 1 << 32, (batch,), generator=gen, dtype=torch.int64).to(device)
    dst = torch.randint(0, 1 << 32, (batch,), generator=gen, dtype=torch.int64).to(device)
    w = torch.ones(batch, dtype=torch.float32, device=device)
    qs, qd = src[:queries].clone(), dst[:queries].clone()

    rf, colls, measured = _measure(lambda: distributed_ingest(mesh, shard, src, dst, w, backend="cuda"), mesh, device,
                                   model_flops_for(config=cfg, batch=batch))
    qrf, qcolls, qmeasured = _measure(lambda: distributed_edge_query(mesh, shard, qs, qd), mesh, device,
                                      model_flops_for(config=cfg, queries=queries))
    backend = torch.distributed.get_backend()
    return {
        "cell": f"glava-{config_name}/ingest_{batch}",
        "mesh": f"{backend}{mesh_shape[0]}x{mesh_shape[1]}",
        "sketch": dict(depth=cfg.depth, wr=cfg.width_rows, wc=cfg.width_cols),
        "roofline": rf.to_dict(),
        "collectives": colls,
        "query_roofline": qrf.to_dict(),
        "query_collectives": qcolls,
        "queries": queries,
        "measured": {"ingest": measured, "query": qmeasured},
        "device": torch.cuda.get_device_name(0) if torch.device(device).type == "cuda" else "cpu",
        "rank": rank,
    }


def summary(rec: Dict) -> str:
    """One line: each call's modelled bound, measured times and fraction."""
    def part(name, rf, m):
        dev = "not measured" if m["device_ms"] is None else f"{m['device_ms']:.4f} ms ({m['device_source']})"
        frac = "—" if m["fraction"] is None else f"{m['fraction']:.3f} of {m['fraction_of']}"
        return (f"{name}: bound {m['bound_ms']:.4f} ms ({rf['dominant']}; compute {rf['compute_s'] * 1e3:.4f}, "
                f"memory {rf['memory_s'] * 1e3:.4f}, collective {rf['collective_s'] * 1e3:.4f} ms), device {dev}, "
                f"wall {m['wall_ms']:.3f} ms, fraction {frac}")

    queries = f"{rec['queries']} queries"
    return (f"[sketch-dryrun] {rec['cell']} on {rec['mesh']} ({rec['device']}): "
            f"{part('ingest', rec['roofline'], rec['measured']['ingest'])}; "
            f"{part(queries, rec['query_roofline'], rec['measured']['query'])}")


def run(config_name: str = "base", *, batch: int = 1 << 20, queries: int = 65_536, ranks: int = 1,
        mesh_shape: Optional[Sequence[int]] = None, backend: Optional[str] = None, device: str = "cuda",
        out: Optional[Path] = Path("results/dryrun_torch"), seed: int = 0) -> Dict:
    """The dry run of ``config_name`` on ``ranks`` ranks laid out as
    ``mesh_shape`` (``(ranks, 1)`` by default); rank 0's record, written to
    ``out`` unless None.  One rank runs in this process (on a process group
    of its own unless one exists); more are spawned."""
    import shutil
    import tempfile

    import torch.distributed as dist

    cfg = _config(config_name)
    mesh_shape = tuple(mesh_shape) if mesh_shape is not None else (ranks, 1)
    if mesh_shape[0] * mesh_shape[1] != ranks:
        raise ValueError(f"mesh {mesh_shape} does not hold {ranks} ranks")
    need = rank_bytes(cfg, mesh_shape, batch)
    if need > HW["hbm_bytes"]:
        raise SystemExit(
            f"sketch_dryrun: {config_name.upper()} needs {need / 1e9:.1f} GB a rank on a {mesh_shape} mesh: its "
            f"counter shard twice (distributed_ingest clones the shard every batch, the reference's delta merge; "
            f"ROADMAP B), and one H100 holds {HW['hbm_bytes'] / 1e9:.0f} GB"
        )
    cuda = torch.device(device).type == "cuda"
    backend = backend or ("nccl" if cuda and ranks == 1 else "gloo")
    args = (config_name, batch, queries, mesh_shape, device, seed)
    tmp = Path(tempfile.mkdtemp(prefix="sketch-dryrun-"))
    try:
        if ranks == 1:
            made = not dist.is_initialized()
            if made:
                if cuda:
                    torch.cuda.set_device(0)
                dist.init_process_group(backend, store=dist.FileStore(str(tmp / "store"), 1), rank=0, world_size=1)
            try:
                rec = rank_run(0, 1, tmp, *args)
            finally:
                if made:
                    dist.destroy_process_group()
        else:
            from repro_torch.distributed.spawn import run_ranks

            rec = run_ranks(rank_run, ranks, tmp, args=args, backend=backend)[0]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if out is not None:
        out = Path(out)
        out.mkdir(parents=True, exist_ok=True)
        (out / f"glava__{config_name}__{rec['mesh']}.json").write_text(json.dumps(rec, indent=2))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.sketch_dryrun")
    ap.add_argument("--config", default="base", choices=CONFIGS)
    ap.add_argument("--batch", type=int, default=1 << 20)
    ap.add_argument("--queries", type=int, default=65_536)
    ap.add_argument("--ranks", type=int, default=1)
    ap.add_argument("--mesh", default=None, help="data,model (default: ranks,1)")
    ap.add_argument("--backend", default=None, help="nccl or gloo (default: nccl for one rank on the card)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args(argv)
    mesh_shape = tuple(int(x) for x in args.mesh.split(",")) if args.mesh else None
    rec = run(args.config, batch=args.batch, queries=args.queries, ranks=args.ranks, mesh_shape=mesh_shape,
              backend=args.backend, device=args.device, out=Path(args.out), seed=args.seed)
    print(summary(rec))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
