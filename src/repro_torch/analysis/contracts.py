"""Entry-point registry and declarative hot-path contracts of the port.

Port of ``src/repro/analysis/contracts.py``.  The port's performance story
rests on invariants: register-served queries never reduce the whole counter
tensor, hot paths never wait on the device from the host, the summary is
updated in place (no per-batch copy of the counters), collectives run only
in the distributed plane, and a value-identical or additions-only workload
reuses what it built.  This module makes them DATA: every engine entry
point registers here with the contracts it must satisfy, and
:mod:`repro_torch.analysis.dispatch_lint` checks them against the aten ops
each entry runs.

Contract vocabulary (the reference's rules mapped to torch):

``no-host-sync``                no op that makes the host wait on the card:
                                ``_local_scalar_dense`` (``item``, ``bool``),
                                a copy to the host (``cpu``, ``numpy``,
                                ``tolist``), an op whose output shape
                                depends on the data (``nonzero``,
                                ``unique``, ``masked_select``, a boolean
                                index).  From ``no-host-callback``.
``no-wide-dtype``               no float64 or complex128 tensor; int64 only
                                in the index plane (see ``dispatch_lint``).
``no-counter-reduction``        no reduction reads a tensor of the full
                                counter shape: the register-served O(d·Q)
                                guarantee.
``collectives-in-distributed-plane``  c10d ops only in ``distributed.*``
                                entries.  From ``collectives-under-shard-map``.
``no-counter-copy``             a boundary that updates the summary
                                allocates nothing of the state's bytes or
                                more: the counters are updated in place.
                                From ``donation-applied``.

Each entry builds at a :class:`Fixture` (device, depth, width, batch), so
the same registry runs on the CPU at the reference's fixture size and on the
card at the fixture size and at BASE.  Entries named ``*.cuda`` and
``kernels.*`` call the kernel wrappers, which run their plain versions on
CPU tensors; the session, fleet and query entries resolve ``auto``
backends by the fixture's device.

Dynamic contracts (:data:`DYNAMIC_CHECKS`) drive the real engines and read
their counters: the closure cache keyed by value, one full closure build
then incremental refreshes over additions-only ticks, one fleet dispatch a
batch whatever the tenant mix, and each kernel library loaded once per
process (the port's counterpart of "one trace per family per shape").
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import shutil
import tempfile
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# violations + baseline
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Violation:
    """One contract breach: ``rule`` names the contract/lint rule,
    ``subject`` the entry point or ``file::function``, ``message`` the
    specifics.  ``baselined`` marks a pre-existing, justified breach."""

    rule: str
    subject: str
    message: str
    pass_name: str
    baselined: bool = False
    justification: str = ""

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        tag = "~" if self.baselined else "!"
        line = f"{tag} [{self.pass_name}] {self.rule} {self.subject}: {self.message}"
        if self.baselined:
            line += f"  (baselined: {self.justification})"
        return line


def apply_baseline(
    violations: List[Violation], baseline: Optional[Dict[Tuple[str, str], str]]
) -> List[Violation]:
    """Mark violations whose (rule, subject) carries a baseline entry."""
    if not baseline:
        return list(violations)
    out = []
    for v in violations:
        just = baseline.get((v.rule, v.subject))
        if just is not None and not v.baselined:
            v = dataclasses.replace(v, baselined=True, justification=just)
        out.append(v)
    return out


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TracedEntry:
    """What one entry point hands the dispatch checker: a callable ``fn`` and
    its ``args``, the counter-tensor shape for the reduction rule, and the
    summary's bytes for the counter-copy rule."""

    fn: Callable
    args: Tuple
    counters_shape: Optional[Tuple[int, ...]] = None
    state_bytes: int = 0


@dataclasses.dataclass(frozen=True)
class Fixture:
    """The size an entry builds at: the reference's fixture (d=2, w=64, 8
    edges) on the CPU; the card runs it and BASE (d=5, w=8,192)."""

    device: str = "cpu"
    depth: int = 2
    width: int = 64
    batch: int = 8


@dataclasses.dataclass(frozen=True)
class EntryPoint:
    name: str
    contracts: Tuple[str, ...]
    build: Callable[[Fixture], TracedEntry]


HOT = ("no-host-sync", "no-wide-dtype", "collectives-in-distributed-plane")
REGISTER_SERVED = HOT + ("no-counter-reduction",)
UPDATES = ("no-counter-copy",)

_FIXTURE_DEPTH = 2
FIXTURE = Fixture()
BASE_FIXTURE = Fixture(device="cuda", depth=5, width=8192, batch=1024)


def _counters_nbytes(shape: Tuple[int, ...]) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return 4 * n  # float32 counters


def _config(fx: Fixture):
    from repro_torch.core.sketch import SketchConfig

    return SketchConfig(depth=fx.depth, width_rows=fx.width, width_cols=fx.width)


def _keys(fx: Fixture, lo: int = 0):
    from repro_torch.core.hashing import keys_to_tensor

    return keys_to_tensor(np.arange(lo, lo + fx.batch, dtype=np.uint32), fx.device)


def _fixture_sketch(fx: Fixture):
    import torch

    from repro_torch.core.sketch import GLavaSketch

    sk = GLavaSketch.empty(_config(fx), 0, torch.device(fx.device))
    w = torch.ones(fx.batch, dtype=torch.float32, device=sk.device)
    return sk, _keys(fx), _keys(fx, fx.batch), w


def copy_sketch(sk):
    """Value-identical sketch with FRESH tensors and a fresh hash family: the
    probe for identity-keyed caches."""
    from repro_torch.core.hashing import HashFamily

    fam = HashFamily.from_host(sk.row_hash.a_host.copy(), sk.row_hash.b_host.copy(), sk.row_hash.w, sk.device)
    col = fam if sk.col_hash is sk.row_hash else HashFamily.from_host(
        sk.col_hash.a_host.copy(), sk.col_hash.b_host.copy(), sk.col_hash.w, sk.device)
    return dataclasses.replace(sk, counters=sk.counters.clone(), row_flows=sk.row_flows.clone(),
                      col_flows=sk.col_flows.clone(), row_hash=fam, col_hash=col)


def _ingest_entry(backend: str) -> Callable[[Fixture], TracedEntry]:
    def build(fx: Fixture) -> TracedEntry:
        from repro_torch.core.ingest import ingest

        sk, src, dst, w = _fixture_sketch(fx)
        rows, cols = sk.hash_edges(src, dst)
        return TracedEntry(
            fn=lambda c, r, cc, ww: ingest(c, r, cc, ww, backend=backend),
            args=(sk.counters, rows, cols, w),
        )

    return build


def _graphstream():
    from repro_torch.api.stream import GraphStream

    return GraphStream


def _session_entry(probe: str, register_served: bool = True, **kw) -> Callable[[Fixture], TracedEntry]:
    """An entry of one of ``GraphStream``'s sizing hooks (``probe``): the
    REAL session dispatch, updating the summary in place; the counter shape
    for the reduction rule when ``register_served``."""

    def build(fx: Fixture) -> TracedEntry:
        sizes = kw if probe == "cost_probe_advance" else dict(kw, batch=fx.batch)
        fn, args, shape = getattr(_graphstream(), probe)(width=fx.width, depth=fx.depth, device=fx.device, **sizes)
        return TracedEntry(fn, args, shape if register_served else None, _counters_nbytes(shape))

    return build


def _preagg_entry(fx: Fixture) -> TracedEntry:
    """The device-side, static-shape pre-aggregation (sort + segment sums)."""
    from repro_torch.core.ingest import preaggregate_edges

    _, src, dst, w = _fixture_sketch(fx)
    return TracedEntry(lambda s, d, ww: preaggregate_edges(s, d, ww, out_size=4), (src, dst, w))


def _preagg_update_entry(fx: Fixture) -> TracedEntry:
    """The device-collapsed update: :func:`preaggregate_edges` at the batch's
    own length (so the collapse always fits; the reference's ``lax.cond``
    takes the collapsed branch then), then the in-place update."""
    from repro_torch.core.ingest import preaggregate_edges

    sk, src, dst, w = _fixture_sketch(fx)

    def update(s, d, ww):
        s_rep, d_rep, w_agg, _ = preaggregate_edges(s, d, ww, out_size=s.shape[0])
        return sk.update_(s_rep, d_rep, w_agg, backend="cuda").counters

    return TracedEntry(update, (src, dst, w), tuple(sk.counters.shape))


def _preagg_jit_boundary(fx: Fixture) -> TracedEntry:
    """The session's device dispatch of a host-collapsed batch
    (``GraphStream._update_pre``, the seven padded arrays), in place."""
    from repro_torch.core.ingest import pad_bucket, preaggregate_host

    gs = _graphstream()._probe_session(fx.width, fx.depth, fx.device, "auto")
    src = np.arange(fx.batch, dtype=np.uint32)
    pre = preaggregate_host(src, src + np.uint32(fx.batch), np.ones(fx.batch, np.float32))
    args = tuple(gs._tensor(pad_bucket(x)) for x in (
        pre.src, pre.dst, pre.weights, pre.src_unique, pre.src_totals, pre.dst_unique, pre.dst_totals))
    shape = tuple(gs._sketch.counters.shape)
    return TracedEntry(gs._update_pre, args, state_bytes=_counters_nbytes(shape))


def _fused_update_entry(fx: Fixture) -> TracedEntry:
    """The fused one-pass update in place (counters, registers, bitmap)."""
    sk, src, dst, w = _fixture_sketch(fx)
    return TracedEntry(lambda s, d, ww: sk.update_fused_(s, d, ww)[0].counters, (src, dst, w),
                       tuple(sk.counters.shape))


def _query_entry(family: str) -> Callable[[Fixture], TracedEntry]:
    def build(fx: Fixture) -> TracedEntry:
        import torch

        from repro_torch.core import queries, reach
        from repro_torch.core.query_engine import QueryEngine, _cuda_edge_query

        sk, src, dst, w = _fixture_sketch(fx)
        shape = tuple(sk.counters.shape)
        theta = torch.tensor(10.0, dtype=torch.float32).to(sk.device, non_blocking=True)
        thetas = torch.full(src.shape, 0.5, dtype=torch.float32, device=sk.device)
        engine = QueryEngine("auto")
        if family == "edge":
            return TracedEntry(queries.edge_query, (sk, src, dst), shape)
        if family == "edge.cuda":
            return TracedEntry(_cuda_edge_query, (sk, src, dst), shape)
        if family in ("in_flow", "out_flow", "flow"):
            return TracedEntry(getattr(queries, f"node_{family}"), (sk, src), shape)
        if family == "heavy":
            return TracedEntry(queries.check_heavy_keys, (sk, src, theta), shape)
        if family == "heavy_vec":
            return TracedEntry(queries.check_heavy_keys_vec, (sk, src, thetas), shape)
        if family == "heavy_rel_vec":
            return TracedEntry(queries.check_heavy_keys_rel_vec, (sk, src, thetas), shape)
        if family == "monitor_step":
            return TracedEntry(
                lambda s, a, b, ww, watch: queries.monitor_step(s, a, b, ww, watch, theta=100.0),
                (sk, src, dst, w, src[0]), shape,
            )
        if family == "subgraph":
            return TracedEntry(queries.subgraph_query, (sk, src[:3], dst[:3]), shape)
        if family == "subgraph_batch":
            half = fx.batch // 2
            s2 = torch.stack([src[:half], src[half:2 * half]])
            d2 = torch.stack([dst[:half], dst[half:2 * half]])
            mask = torch.ones(s2.shape, dtype=torch.bool, device=sk.device)
            return TracedEntry(queries.subgraph_query_batch, (sk, s2, d2, mask), shape)
        closure_fn = engine._fn("closure", sk.device)
        if family == "reach_pre":
            return TracedEntry(reach.reach_query_precomputed, (sk, closure_fn(sk.counters), src, src), shape)
        if family == "closure":
            return TracedEntry(closure_fn, (sk.counters,), shape)
        if family == "closure_refresh":
            # The engine's touched-row refresh, given the fused ingest's
            # (d, w_r) bitmap of touched rows: one incremental refresh a call.
            engine.closure_for(sk, epoch=0)
            epochs = itertools.count(1)
            bitmap = torch.zeros(shape[:2], dtype=torch.bool, device=sk.device)
            bitmap[:, :2] = True
            return TracedEntry(lambda s, b: engine.refresh_closure(s, b, epoch=next(epochs)), (sk, bitmap), shape)
        raise ValueError(f"no fixture for query family {family!r}")

    return build


def _kernel_entry(name: str) -> Callable[[Fixture], TracedEntry]:
    def build(fx: Fixture) -> TracedEntry:
        import torch

        sk, src, dst, w = _fixture_sketch(fx)
        rows, cols = sk.hash_edges(src, dst)
        if name == "ingest":
            from repro_torch.kernels.ingest import ops

            return TracedEntry(ops.ingest_scatter, (sk.counters, rows, cols, w))
        if name == "ingest.keys":
            from repro_torch.kernels.ingest import ops

            return TracedEntry(ops.ingest_keys, (sk.counters, src, dst, w, sk.row_hash, sk.col_hash))
        if name == "query":
            from repro_torch.kernels.query import ops

            return TracedEntry(ops.edge_query_min, (sk.counters, rows, cols))
        if name == "closure":
            from repro_torch.kernels.closure import ops

            return TracedEntry(ops.transitive_closure, (sk.counters,))
        if name == "boolmm":
            from repro_torch.kernels.boolmm import ops
            from repro_torch.kernels.closure.ops import transitive_closure

            # The card's touched-row refresh on the fixture's batch of rows.
            plan = ops.pad_rows(rows)
            delta = sk.counters[torch.arange(fx.depth, device=sk.device)[:, None], plan] > 0
            return TracedEntry(ops.closure_refresh, (transitive_closure(sk.counters), delta, plan))
        if name == "flow":
            from repro_torch.kernels.flow import ops

            return TracedEntry(ops.flows, (sk.counters,))
        if name == "ingest_fused":
            from repro_torch.kernels.ingest_fused import ops

            return TracedEntry(ops.fused_ingest, (sk.counters, sk.row_flows, sk.col_flows, rows, cols, w))
        if name == "ingest_stacked":
            from repro_torch.fleet.stack import FleetSketch
            from repro_torch.kernels.ingest_stacked import ops

            st = FleetSketch.empty(_config(fx), 4, 0, device=sk.device)
            t, k, d, wr, wc = st.counters.shape
            plane = torch.arange(fx.batch, device=sk.device) % t
            return TracedEntry(ops.stacked_ingest, (
                st.counters.view(t * k, d, wr, wc), st.row_flows.view(t * k, d, wr),
                st.col_flows.view(t * k, d, wc), plane, rows, cols, w))
        if name == "preagg":
            from repro_torch.kernels.preagg import ops

            batch = torch.stack([src.int(), dst.int(), w.view(torch.int32)])
            touched = torch.empty(sk.row_flows.shape, dtype=torch.bool, device=sk.device)
            tables = ops.CollapseTables()
            return TracedEntry(lambda b: ops.preagg_collapse(b, sk.row_flows, sk.col_flows, touched, sk.row_hash,
                                                             sk.col_hash, False, tables)[2], (batch,))
        if name == "sequential":
            from repro_torch.kernels.sequential import ops

            return TracedEntry(lambda c, r, cc, ww: ops.sequential_update(c, r, cc, ww, True),
                               (sk.counters, rows, cols, w))
        if name in ("countsketch", "countsketch.median"):
            from repro_torch.kernels.countsketch import ops

            vec = torch.arange(512, dtype=torch.float32, device=sk.device)
            if name == "countsketch":
                return TracedEntry(ops.countsketch_family, (vec, sk.row_hash))
            table = ops.countsketch_family(vec, sk.row_hash)
            return TracedEntry(ops.countsketch_median, (table, sk.row_hash, vec.shape[0]))
        raise ValueError(f"no fixture for kernel {name!r}")

    return build


@contextlib.contextmanager
def one_rank_group(device: str = "cpu"):
    """A one-rank default process group for the distributed entries (gloo on
    the CPU, NCCL on the card) unless one exists; destroyed on exit if made
    here."""
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        yield
        return
    tmp = tempfile.mkdtemp(prefix="repro-torch-analysis-")
    backend = "gloo" if torch.device(device).type == "cpu" else "nccl"
    if backend == "nccl":
        torch.cuda.set_device(torch.device(device).index or 0)
    dist.init_process_group(backend, store=dist.FileStore(f"{tmp}/store", 1), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def _mesh_shard(fx: Fixture):
    from repro_torch.core.distributed import empty_shard
    from repro_torch.distributed.mesh import make_host_mesh

    mesh = make_host_mesh(1, 1)
    import torch

    return mesh, empty_shard(mesh, _config(fx), 0, torch.device(fx.device))


def _distributed_ingest_entry(fx: Fixture) -> TracedEntry:
    """``distributed_ingest`` on a one-rank (1, 1) mesh: the shard updated in place."""
    from repro_torch.core.distributed import distributed_ingest

    mesh, shard = _mesh_shard(fx)
    _, src, dst, w = _fixture_sketch(fx)
    shape = tuple(shard.counters.shape)
    return TracedEntry(
        lambda s, d, ww: distributed_ingest(mesh, shard, s, d, ww).counters,
        (src, dst, w), state_bytes=_counters_nbytes(shape),
    )


def _distributed_point_entry(fx: Fixture) -> TracedEntry:
    from repro_torch.core.distributed import distributed_point_query

    mesh, shard = _mesh_shard(fx)
    _, src, _, _ = _fixture_sketch(fx)
    return TracedEntry(lambda keys: distributed_point_query(mesh, shard, keys, use_registers=False), (src,))


def _fleet_fixture(fx: Fixture):
    """A 4-slot fleet stack plus mixed query lanes (slot as a DATA lane)."""
    import torch

    from repro_torch.fleet.stack import FleetSketch

    st = FleetSketch.empty(_config(fx), 4, 0, device=torch.device(fx.device))
    slots = torch.arange(fx.batch, device=st.device) % 4
    w = torch.ones(fx.batch, dtype=torch.float32, device=st.device)
    return st, slots, _keys(fx), _keys(fx, fx.batch), w


def _fleet_ingest_entry(fx: Fixture) -> TracedEntry:
    """The stacked scatter in place: T tenants folded by ONE update."""
    st, slots, src, dst, w = _fleet_fixture(fx)
    return TracedEntry(lambda sl, s, d, ww: st.update_(sl, s, d, ww).counters, (slots, src, dst, w),
                       tuple(st.counters.shape))


def _fleet_ingest_jit_boundary(fx: Fixture) -> TracedEntry:
    """The REAL ``FleetIngestEngine.dispatch`` of a mixed batch, in place."""
    from repro_torch.fleet.ingest import FleetIngestEngine

    fn, args, shape = FleetIngestEngine.cost_probe(tenants=4, width=fx.width, depth=fx.depth, batch=fx.batch,
                                                   device=fx.device, backend="auto")
    return TracedEntry(fn, args, state_bytes=_counters_nbytes(shape))


def _fleet_query_entry(family: str) -> Callable[[Fixture], TracedEntry]:
    def build(fx: Fixture) -> TracedEntry:
        import torch

        from repro_torch.fleet import query as fq

        eng = fq.FleetQueryEngine("auto")
        st, slots, src, dst, w = _fleet_fixture(fx)
        shape = tuple(st.counters.shape)
        if family == "edge":
            return TracedEntry(fq.fleet_edge_query, (st, slots, src, dst), shape)
        if family in ("in_flow", "out_flow", "flow"):
            return TracedEntry(getattr(fq, f"fleet_{family}"), (st, slots, src), shape)
        if family == "heavy_rel_vec":
            thetas = torch.full(src.shape, 0.5, dtype=torch.float32, device=st.device)
            return TracedEntry(fq.fleet_heavy_rel_vec, (st, slots, src, thetas), shape)
        if family == "subgraph_batch":
            half = fx.batch // 2
            s2 = torch.stack([src[:half], src[half:2 * half]])
            d2 = torch.stack([dst[:half], dst[half:2 * half]])
            mask = torch.ones(s2.shape, dtype=torch.bool, device=st.device)
            return TracedEntry(fq.fleet_subgraph_batch, (st, slots[:2], s2, d2, mask), shape)
        sel = [0, 1, 2, 3]
        build_fn = eng._fn("closure", st.device)
        if family == "reach_pre":
            return TracedEntry(fq.fleet_reach_pre, (st, build_fn(st.counters, sel), slots, src, dst), shape)
        if family == "closure":
            return TracedEntry(build_fn, (st.counters, sel), shape)
        if family == "closure_refresh":
            rows = st.row_hash(src[:4])[None].expand(4, -1, -1).contiguous()
            return TracedEntry(eng._fn("closure_refresh", st.device), (build_fn(st.counters, sel), st.counters, sel, rows),
                               shape)
        raise ValueError(f"no fixture for fleet query family {family!r}")

    return build


# The step builder's cells, at SMOKE size (launch/steps.py): a serving
# step answers one request; a train step is the body of launch/train.py's
# loop.  (family entry name, arch, shape)
STEP_CELLS = (
    ("lm.train", "olmo-1b", "train_4k"),
    ("lm.train_moe", "mixtral-8x22b", "train_4k"),
    ("lm.prefill", "qwen3-4b", "prefill_32k"),
    ("lm.decode", "qwen3-4b", "decode_32k"),
    ("gnn.train", "gat-cora", "full_graph_sm"),
    ("gnn.train_molecule", "dimenet", "molecule"),
    ("recsys.train", "bert4rec", "train_batch"),
    ("recsys.serve", "bert4rec", "serve_p99"),
    ("recsys.retrieval", "bert4rec", "retrieval_cand"),
)


def _step_entry(arch: str, shape: str) -> Callable[[Fixture], TracedEntry]:
    """One ``build_step`` bundle's step at its SMOKE size on the fixture's
    device (the sketch fixture's sizes do not apply)."""

    def build(fx: Fixture) -> TracedEntry:
        import torch

        from repro_torch.launch.steps import build_step

        bundle = build_step(arch, shape, smoke=True, device=fx.device)
        state = bundle.init_state(torch.Generator().manual_seed(0))
        batch = bundle.to_tensors(bundle.make_batch(np.random.default_rng(0)))
        return TracedEntry(bundle.step, (state, batch))

    return build


ENTRY_POINTS: Tuple[EntryPoint, ...] = (
    # -- every IngestEngine backend dispatch (the reference's onehot is not ported)
    EntryPoint("ingest.scatter", HOT, _ingest_entry("scatter")),
    EntryPoint("ingest.cuda", HOT, _ingest_entry("cuda")),
    # -- the session's ingest boundary (the summary updated in place) -----
    EntryPoint("ingest.jit_boundary", HOT + UPDATES, _session_entry("cost_probe_update", register_served=False)),
    # -- the heavy-tail fast path: pre-aggregation + fused one-pass ingest --
    EntryPoint("ingest.preagg", HOT, _preagg_entry),
    EntryPoint("ingest.preagg_update", HOT, _preagg_update_entry),
    EntryPoint("ingest.preagg_boundary", HOT + UPDATES, _preagg_jit_boundary),
    EntryPoint("ingest.fused_update", HOT, _fused_update_entry),
    # -- the turnstile delete, the window advance, the event-time slot ------
    EntryPoint("ingest.delete_boundary", REGISTER_SERVED + UPDATES, _session_entry("cost_probe_update", negative=True)),
    EntryPoint("window.advance_boundary", REGISTER_SERVED + UPDATES,
               _session_entry("cost_probe_advance", slices=4, backend="auto")),
    EntryPoint("stream.update_slice_boundary", REGISTER_SERVED + UPDATES,
               _session_entry("cost_probe_update_slice", slices=4, backend="auto")),
    # -- every QueryEngine family -----------------------------------------
    EntryPoint("query.edge", HOT, _query_entry("edge")),
    EntryPoint("query.edge.cuda", HOT, _query_entry("edge.cuda")),
    EntryPoint("query.in_flow", REGISTER_SERVED, _query_entry("in_flow")),
    EntryPoint("query.out_flow", REGISTER_SERVED, _query_entry("out_flow")),
    EntryPoint("query.flow", REGISTER_SERVED, _query_entry("flow")),
    EntryPoint("query.heavy", REGISTER_SERVED, _query_entry("heavy")),
    EntryPoint("query.heavy_vec", REGISTER_SERVED, _query_entry("heavy_vec")),
    EntryPoint("query.heavy_rel_vec", REGISTER_SERVED, _query_entry("heavy_rel_vec")),
    EntryPoint("query.monitor_step", REGISTER_SERVED, _query_entry("monitor_step")),
    EntryPoint("query.subgraph", HOT, _query_entry("subgraph")),
    EntryPoint("query.subgraph_batch", HOT, _query_entry("subgraph_batch")),
    EntryPoint("query.reach_pre", REGISTER_SERVED, _query_entry("reach_pre")),
    EntryPoint("query.closure", HOT, _query_entry("closure")),
    EntryPoint("query.closure_refresh", HOT, _query_entry("closure_refresh")),
    # -- every kernels/*/ops.py wrapper (the plain version on CPU tensors) --
    EntryPoint("kernels.ingest.ops", HOT, _kernel_entry("ingest")),
    EntryPoint("kernels.ingest.keys", HOT, _kernel_entry("ingest.keys")),
    EntryPoint("kernels.ingest_fused.ops", HOT, _kernel_entry("ingest_fused")),
    EntryPoint("kernels.ingest_stacked.ops", HOT, _kernel_entry("ingest_stacked")),
    EntryPoint("kernels.query.ops", HOT, _kernel_entry("query")),
    EntryPoint("kernels.closure.ops", HOT, _kernel_entry("closure")),
    EntryPoint("kernels.boolmm.ops", HOT, _kernel_entry("boolmm")),
    EntryPoint("kernels.flow.ops", HOT, _kernel_entry("flow")),
    EntryPoint("kernels.countsketch.ops", HOT, _kernel_entry("countsketch")),
    EntryPoint("kernels.countsketch.median", HOT, _kernel_entry("countsketch.median")),
    EntryPoint("kernels.sequential.ops", HOT, _kernel_entry("sequential")),
    EntryPoint("kernels.preagg.ops", HOT, _kernel_entry("preagg")),
    # -- the distributed plane (collectives belong here alone) -------------
    EntryPoint("distributed.ingest", HOT + UPDATES, _distributed_ingest_entry),
    EntryPoint("distributed.point_query", HOT, _distributed_point_entry),
    # -- the fleet plane: T tenants, one dispatch ---------------------------
    EntryPoint("fleet.ingest.update", HOT, _fleet_ingest_entry),
    EntryPoint("fleet.ingest.jit_boundary", HOT + UPDATES, _fleet_ingest_jit_boundary),
    EntryPoint("fleet.query.edge", HOT, _fleet_query_entry("edge")),
    EntryPoint("fleet.query.in_flow", REGISTER_SERVED, _fleet_query_entry("in_flow")),
    EntryPoint("fleet.query.out_flow", REGISTER_SERVED, _fleet_query_entry("out_flow")),
    EntryPoint("fleet.query.flow", REGISTER_SERVED, _fleet_query_entry("flow")),
    EntryPoint("fleet.query.heavy_rel_vec", REGISTER_SERVED, _fleet_query_entry("heavy_rel_vec")),
    EntryPoint("fleet.query.subgraph_batch", HOT, _fleet_query_entry("subgraph_batch")),
    EntryPoint("fleet.query.reach_pre", REGISTER_SERVED, _fleet_query_entry("reach_pre")),
    EntryPoint("fleet.query.closure", HOT, _fleet_query_entry("closure")),
    EntryPoint("fleet.query.closure_refresh", HOT, _fleet_query_entry("closure_refresh")),
    # -- the step builder (launch/steps.py) --------------------------------
    *(EntryPoint(f"steps.{name}", HOT, _step_entry(arch, shape)) for name, arch, shape in STEP_CELLS),
)


# ---------------------------------------------------------------------------
# the cost pass's contracts (costlint)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AxisContract:
    """Declared scaling ceiling along ONE problem-size axis: the log-log
    least-squares slope of ``metric`` over the geometric ``sizes`` ladder
    must stay within ``exponent + tol``.  ``metric`` is the cost counter's
    ``"work"`` (the reference's XLA "flops") or ``"bytes"``."""

    axis: str                   # "B" | "Q" | "T" | "w" | "S" | "K"
    exponent: float             # declared upper-bound exponent
    sizes: Tuple[int, ...]      # geometrically spaced probe sizes
    tol: float = 0.35
    metric: str = "work"        # "work" | "bytes"


@dataclasses.dataclass(frozen=True)
class CostProbe:
    """One cost entry at ONE size point: a callable ``fn`` and its ``args``
    plus the summary's bytes at this size, which the memory proof of an
    updating boundary compares its fresh allocations against."""

    fn: Callable
    args: Tuple
    state_bytes: int = 0


@dataclasses.dataclass(frozen=True)
class CostEntryPoint:
    """One cost contract.  ``build(**sizes, device=)`` instantiates the probe
    at a size point (the kwargs are the axis names); costlint traces every
    point on each axis's ladder (the base point, every axis at its smallest
    size, is shared), fits per-axis exponents and checks them against the
    declared ceilings, the memory proof (``donated=True``: the summary is
    updated in place), and the committed budgets (``budgets.json``).
    ``edges_axis`` names the axis whose largest point normalizes the budgets
    to work and bytes an edge."""

    name: str
    axes: Tuple[AxisContract, ...]
    build: Callable[..., CostProbe]
    donated: bool = False
    edges_axis: Optional[str] = None


def _cost_ingest_scatter(B: int = 64, w: int = 64, device: str = "cpu") -> CostProbe:
    """B1's bucket entry on a hashed batch (the kernel scope: d adds a slot)."""
    from repro_torch.core.ingest import ingest

    sk, src, dst, wts = _fixture_sketch(Fixture(device=device, depth=_FIXTURE_DEPTH, width=w, batch=B))
    dst = src + B
    rows, cols = sk.hash_edges(src, dst)
    return CostProbe(
        fn=lambda c, r, cc, ww: ingest(c, r, cc, ww, backend="cuda"),
        args=(sk.counters, rows, cols, wts),
        state_bytes=_counters_nbytes(tuple(sk.counters.shape)),
    )


def _cost_ingest_boundary(B: int = 64, w: int = 64, device: str = "cpu") -> CostProbe:
    fn, args, shape = _graphstream().cost_probe_update(width=w, depth=_FIXTURE_DEPTH, batch=B, device=device)
    return CostProbe(fn=fn, args=args, state_bytes=_counters_nbytes(shape))


def _cost_update_slice_boundary(B: int = 64, w: int = 64, K: int = 4, device: str = "cpu") -> CostProbe:
    fn, args, shape = _graphstream().cost_probe_update_slice(
        width=w, depth=_FIXTURE_DEPTH, slices=K, batch=B, device=device)
    return CostProbe(fn=fn, args=args, state_bytes=_counters_nbytes(shape))


def _cost_fleet_ingest_boundary(B: int = 64, T: int = 2, w: int = 64, device: str = "cpu") -> CostProbe:
    from repro_torch.fleet.ingest import FleetIngestEngine

    fn, args, shape = FleetIngestEngine.cost_probe(tenants=T, width=w, depth=_FIXTURE_DEPTH, batch=B,
                                                   device=device)
    return CostProbe(fn=fn, args=args, state_bytes=_counters_nbytes(shape))


def _cost_query(family: str) -> Callable[..., CostProbe]:
    def build(Q: int = 32, w: int = 64, device: str = "cpu") -> CostProbe:
        from repro_torch.core.query_engine import QueryEngine

        fn, args, shape = QueryEngine.family_probe(family, width=w, depth=_FIXTURE_DEPTH, n_queries=Q,
                                                   device=device)
        return CostProbe(fn=fn, args=args, state_bytes=_counters_nbytes(shape))

    return build


def _cost_closure(family: str) -> Callable[..., CostProbe]:
    def build(w: int = 64, device: str = "cpu") -> CostProbe:
        from repro_torch.core.query_engine import QueryEngine

        fn, args, shape = QueryEngine.family_probe(family, width=w, depth=_FIXTURE_DEPTH, device=device)
        return CostProbe(fn=fn, args=args, state_bytes=_counters_nbytes(shape))

    return build


def _cost_fleet_query(family: str) -> Callable[..., CostProbe]:
    def build(Q: int = 32, T: int = 2, w: int = 64, S: int = 2, device: str = "cpu") -> CostProbe:
        from repro_torch.fleet.query import FleetQueryEngine

        fn, args, shape = FleetQueryEngine.family_probe(
            family, tenants=T, width=w, depth=_FIXTURE_DEPTH, n_queries=Q, touched=S, device=device)
        return CostProbe(fn=fn, args=args, state_bytes=_counters_nbytes(shape))

    return build


_B3 = (64, 128, 256)
_Q2 = (32, 128)
_T3 = (2, 4, 8)
_T2 = (2, 8)
_W2 = (32, 128)
_W3 = (32, 64, 128)
_S2 = (2, 8)

COST_ENTRY_POINTS: Tuple[CostEntryPoint, ...] = (
    # Paper Thm 1 / Section 3.2: maintenance is O(B·d) per batch and free
    # of the width: the hash and the scatter never touch w-many cells.
    CostEntryPoint(
        "cost.ingest.scatter",
        (AxisContract("B", 1.0, _B3), AxisContract("w", 0.0, _W2)),
        _cost_ingest_scatter,
        edges_axis="B",
    ),
    CostEntryPoint(
        "cost.ingest.jit_boundary",
        (AxisContract("B", 1.0, _B3),),
        _cost_ingest_boundary,
        donated=True,
        edges_axis="B",
    ),
    # Event-time slice routing: O(B·d) scatter work into ONE slot; the ring
    # length K stays out of the per-batch cost entirely (a K exponent > 0
    # would mean the boundary touches the whole ring).
    CostEntryPoint(
        "cost.stream.update_slice",
        (
            AxisContract("B", 1.0, _B3),
            AxisContract("w", 2.0, _W2, tol=0.4),
            AxisContract("K", 0.0, (4, 8, 16)),
        ),
        _cost_update_slice_boundary,
        donated=True,
        edges_axis="B",
    ),
    # Fleet arrivals: the tenant axis rides the scatter INDEX, so T tenants
    # cost O(1) in T.
    CostEntryPoint(
        "cost.fleet.ingest_boundary",
        (AxisContract("B", 1.0, _B3), AxisContract("T", 0.0, _T3)),
        _cost_fleet_ingest_boundary,
        donated=True,
        edges_axis="B",
    ),
    # Register-served query families: O(d·Q) gathers, exponent ≈ 0 in w.
    CostEntryPoint(
        "cost.query.edge",
        (AxisContract("Q", 1.0, _Q2), AxisContract("w", 0.0, _W2)),
        _cost_query("edge"),
    ),
    CostEntryPoint(
        "cost.query.in_flow",
        (AxisContract("Q", 1.0, _Q2), AxisContract("w", 0.0, _W2)),
        _cost_query("in_flow"),
    ),
    CostEntryPoint(
        "cost.query.heavy_rel_vec",
        (AxisContract("Q", 1.0, _Q2), AxisContract("w", 0.0, _W2)),
        _cost_query("heavy_rel_vec"),
    ),
    # Fleet query families: the slot is a DATA lane, exponent ≈ 0 in T.
    CostEntryPoint(
        "cost.fleet.query.in_flow",
        (AxisContract("Q", 1.0, _Q2), AxisContract("T", 0.0, _T2)),
        _cost_fleet_query("in_flow"),
    ),
    CostEntryPoint(
        "cost.fleet.query.heavy_rel_vec",
        (AxisContract("Q", 1.0, _Q2), AxisContract("T", 0.0, _T2)),
        _cost_fleet_query("heavy_rel_vec"),
    ),
    # Closure maintenance: the touched-row refresh is O(T_touched·w²); only
    # the full rebuild may pay O(w³ log w).
    CostEntryPoint(
        "cost.query.closure_refresh",
        (AxisContract("w", 2.0, _W3, tol=0.4),),
        _cost_closure("closure_refresh"),
    ),
    CostEntryPoint(
        "cost.query.closure",
        (AxisContract("w", 3.0, _W3, tol=0.5),),
        _cost_closure("closure"),
    ),
    CostEntryPoint(
        "cost.fleet.closure_refresh",
        (AxisContract("w", 2.0, _W3, tol=0.4), AxisContract("S", 1.0, _S2)),
        _cost_fleet_query("closure_refresh"),
    ),
)


# ---------------------------------------------------------------------------
# dynamic contracts: caches, rebuilds and dispatches
# ---------------------------------------------------------------------------


def _retrace(subject: str, message: str) -> Violation:
    return Violation(rule="retrace", subject=subject, message=message, pass_name="dispatch")


def check_kernel_libraries(device: str = "cpu") -> List[Violation]:
    """Each kernel library is built and loaded ONCE per process
    (``kernels/build.py``): every register and edge family dispatched twice,
    the second time with value-identical but object-fresh sketch and keys,
    then no library may show more than one load.  The port's counterpart of
    the reference's one trace per family per shape signature (on the CPU no
    library loads; the card's run is the one that loads them)."""
    import torch

    from repro_torch.core.query_engine import QueryEngine
    from repro_torch.kernels import build

    eng = QueryEngine("auto", pad_q=8)
    sk, src, dst, _ = _fixture_sketch(Fixture(device=device))
    thetas = torch.full(src.shape, 0.5, dtype=torch.float32, device=sk.device)
    for s, a, b, t in ((sk, src, dst, thetas), (copy_sketch(sk), src.clone(), dst.clone(), thetas.clone())):
        eng.edge(s, a, b)
        eng.in_flow(s, a)
        eng.out_flow(s, a)
        eng.flow(s, a)
        eng.heavy_rel_vec(s, a, t)
    return [
        _retrace(f"kernels.{name}", f"library {name!r} loaded {n} times in one process (want 1)")
        for name, n in sorted(build.load_counts.items()) if n > 1
    ]


def check_closure_cache_value_keyed(device: str = "cpu") -> List[Violation]:
    """The epoch-tagged closure cache must key the hash family BY VALUE: a
    value-identical sketch with fresh tensors and a fresh family at the
    same epoch must not rebuild the O(w³ log w) closure."""
    from repro_torch.core.query_engine import QueryEngine

    eng = QueryEngine("auto", pad_q=8)
    sk, src, _, _ = _fixture_sketch(Fixture(device=device))
    q = src[:2]
    eng.reach(sk, q, q, epoch=0)
    builds = eng.closure_refreshes
    eng.reach(copy_sketch(sk), q.clone(), q, epoch=0)
    if eng.closure_refreshes != builds:
        return [_retrace(
            "query.reach.closure_cache",
            "closure cache MISSED on a value-identical sketch at the same epoch: the cache key depends on "
            "object identity instead of the hash family's value",
        )]
    return []


def check_subscription_tick(device: str = "cpu") -> List[Violation]:
    """Over N additions-only mutations a standing reach+flow+edge batch
    performs exactly ONE full closure build and N-1 incremental touched-row
    refreshes."""
    from repro_torch.api.query import Query

    gs = _graphstream().open(_config(FIXTURE), device=device)
    gs.subscribe(Query.reach(1, 2), Query.in_flow(2), Query.edge(1, 2), every=1)
    rng = np.random.default_rng(0)
    n_ticks = 3
    for _ in range(n_ticks):
        gs.ingest(rng.integers(0, 30, 6).astype(np.uint32), rng.integers(0, 30, 6).astype(np.uint32))
    out: List[Violation] = []
    if gs.engine.closure_refreshes != 1:
        out.append(_retrace("subscription.tick", (
            f"{gs.engine.closure_refreshes} full closure builds over {n_ticks} additions-only ticks (want "
            "exactly 1: later ticks must ride the touched-row incremental refresh)")))
    if gs.engine.closure_incremental_refreshes != n_ticks - 1:
        out.append(_retrace("subscription.tick", (
            f"{gs.engine.closure_incremental_refreshes} incremental refreshes over {n_ticks} ticks "
            f"(want {n_ticks - 1})")))
    return out


def check_fleet_permutation(device: str = "cpu") -> List[Violation]:
    """Tenant ids are DATA: replaying a same-shape mixed workload under
    permuted tenant assignments takes one ingest dispatch a batch and the
    same query dispatches every round."""
    from repro_torch.fleet import SketchFleet

    fleet = SketchFleet.open(_config(FIXTURE), capacity=4, device=device)
    rng = np.random.default_rng(0)
    rounds = ([0, 1, 2, 3], [0, 1, 2, 3], [3, 0, 1, 2], [1, 3, 0, 2])
    out: List[Violation] = []
    first = None
    for i, perm in enumerate(rounds):
        ingest_before = fleet._ingest.dispatches
        query_before = dict(fleet.engine.dispatches)
        ids = np.asarray(perm)[rng.integers(0, 4, 64)]
        src = rng.integers(0, 100, 64).astype(np.uint32)
        dst = rng.integers(0, 100, 64).astype(np.uint32)
        fleet.ingest_mixed(ids, src, dst)
        # A small delete per tenant poisons touched-tracking, so reach takes
        # the full-build path every round: this check is about dispatches,
        # not the refresh ladder.
        fleet.ingest_mixed(np.asarray(perm), src[:4], dst[:4], -np.ones(4, np.float32))
        for t in perm:
            sess = fleet.tenant(t)
            sess.edge_frequency(src[:8], dst[:8])
            sess.in_flow(src[:8])
            sess.reachable(src[:4], dst[:4])
        ingests = fleet._ingest.dispatches - ingest_before
        if ingests != 2:
            out.append(_retrace("fleet.ingest", (
                f"round {i}: {ingests} ingest dispatches for 2 mixed batches (want one a batch: the tenant "
                "axis must ride the scatter index)")))
            break
        queries = {f: n - query_before.get(f, 0) for f, n in fleet.engine.dispatches.items()}
        queries = {f: n for f, n in queries.items() if n}
        if first is None:
            first = queries
        elif queries != first:
            out.append(_retrace("fleet.query", (
                f"query dispatches changed under a tenant-id permutation (round {i}: {queries}, round 0: "
                f"{first})")))
            break
    return out


def check_fleet_subscription_tick(device: str = "cpu") -> List[Violation]:
    """A standing reach+flow+edge batch on one tenant over N additions-only
    mixed batches performs exactly ONE full closure build, N-1 batched
    incremental refreshes and ONE ingest dispatch a batch."""
    from repro_torch.api.query import Query
    from repro_torch.fleet import SketchFleet

    fleet = SketchFleet.open(_config(FIXTURE), capacity=4, device=device)
    sess = fleet.tenant("hot")
    sess.subscribe(Query.reach(1, 2), Query.in_flow(2), Query.edge(1, 2), every=1)
    rng = np.random.default_rng(0)
    n_ticks = 3
    before = fleet._ingest.dispatches
    for _ in range(n_ticks):
        sess.ingest(rng.integers(0, 30, 6).astype(np.uint32), rng.integers(0, 30, 6).astype(np.uint32))
    out: List[Violation] = []
    if fleet.engine.closure_builds != 1:
        out.append(_retrace("fleet.subscription.tick", (
            f"{fleet.engine.closure_builds} full closure builds over {n_ticks} additions-only ticks (want "
            "exactly 1: later ticks must ride the batched incremental refresh)")))
    if fleet.engine.closure_incremental_refreshes != n_ticks - 1:
        out.append(_retrace("fleet.subscription.tick", (
            f"{fleet.engine.closure_incremental_refreshes} incremental refreshes over {n_ticks} ticks "
            f"(want {n_ticks - 1})")))
    if fleet._ingest.dispatches - before != n_ticks:
        out.append(_retrace("fleet.subscription.tick", (
            f"{fleet._ingest.dispatches - before} ingest dispatches over {n_ticks} ticks (want one a tick)")))
    return out


DYNAMIC_CHECKS: Dict[str, Callable[..., List[Violation]]] = {
    "retrace.kernel_libraries": check_kernel_libraries,
    "retrace.closure_cache": check_closure_cache_value_keyed,
    "retrace.subscription_tick": check_subscription_tick,
    "retrace.fleet_permutation": check_fleet_permutation,
    "retrace.fleet_subscription_tick": check_fleet_subscription_tick,
}
