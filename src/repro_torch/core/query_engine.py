"""QueryEngine — the ONE dispatch point for sketch queries.

Port of ``src/repro/core/query_engine.py``.  One engine serves every query
family (edge, point/flow, heavy-hitter, subgraph, reachability) and owns

- **query-batch padding/chunking**: key batches are right-padded to a
  multiple of ``pad_q`` and processed in ``chunk_q``-sized pieces, as the
  reference does for its jit cache (here it bounds the shapes the CUDA
  allocator and kernels see);
- the **epoch-tagged closure cache**: reachability needs the transitive
  closure of the counters, O(w³ log w) to build and O(d·Q) to query.  The
  engine caches one closure tagged with the caller's epoch and the hash
  family's VALUE (read from the family's host copy, so the key costs no
  device sync), and refreshes it incrementally from touched rows (given as
  node keys or as the fused ingest's touched-row bitmap);
- the **backend convention**: ``torch`` (plain PyTorch) or ``cuda`` (the
  hand-written multi-query kernel, ``repro_torch.kernels.query``, the
  closure squaring kernel, ``repro_torch.kernels.closure``, and the
  refresh's boolean product, ``repro_torch.kernels.boolmm``).  ``auto``
  means ``cuda`` for a sketch on a CUDA device and ``torch`` on the CPU;
  there is no environment override.
"""
from __future__ import annotations

import collections
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import telemetry
from repro_torch.core import queries, reach
from repro_torch.core.hashing import keys_to_tensor
from repro_torch.core.sketch import GLavaSketch, SketchConfig
from repro_torch.kernels.boolmm import ops as boolmm
from repro_torch.kernels.closure.ops import transitive_closure as cuda_transitive_closure
from repro_torch.kernels.query.ops import edge_query as cuda_edge_query

QUERY_BACKENDS = ("torch", "cuda")
DEFAULT_PAD_Q = 256
DEFAULT_CHUNK_Q = 16384
# Incremental-closure hygiene: touched-row batches pad to multiples of this,
# refreshes fall back to a full rebuild when a batch touches more than
# CLOSURE_REFRESH_FRAC of the rows or after CLOSURE_STALENESS_BUDGET
# incremental refreshes since the last full build.
CLOSURE_REFRESH_PAD_T = 64
CLOSURE_REFRESH_FRAC = 0.25
CLOSURE_STALENESS_BUDGET = 256


def resolve_query_backend(backend: Optional[str], device: torch.device) -> str:
    """Resolve "auto"/None for a sketch on ``device`` to a concrete name."""
    if backend in (None, "auto"):
        return "cuda" if torch.device(device).type == "cuda" else "torch"
    if backend not in QUERY_BACKENDS:
        raise ValueError(f"unknown query backend: {backend!r} (want {QUERY_BACKENDS})")
    return backend


def _cuda_edge_query(sketch: GLavaSketch, src, dst):
    # The kernel computes in fp32; the cast back to the counter dtype keeps
    # both backends dtype-identical.
    est = cuda_edge_query(sketch, src, dst).to(sketch.counters.dtype)
    if not sketch.config.directed:
        est = queries.undirected_selfloop_correction(est, src, dst)
    return est


def _cuda_closure_refresh(closure: torch.Tensor, counters: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``reach.closure_refresh`` on the 8-bit tensor cores
    (``kernels/boolmm``): only the T touched rows of the counters are read,
    as bytes; no float copy of the closure."""
    rows = boolmm.pad_rows(rows)
    d_idx = torch.arange(closure.shape[0], device=closure.device)[:, None]
    return boolmm.closure_refresh(closure, counters[d_idx, rows, :] > 0, rows)


# family -> (torch fn, cuda fn); point/flow families are O(d·Q) register
# gathers either way, so both backends share the torch path.
_FAMILIES: Dict[str, Tuple[Callable, Callable]] = {
    "edge": (queries.edge_query, _cuda_edge_query),
    "in_flow": (queries.node_in_flow, queries.node_in_flow),
    "out_flow": (queries.node_out_flow, queries.node_out_flow),
    "flow": (queries.node_flow, queries.node_flow),
    "heavy": (queries.check_heavy_keys, queries.check_heavy_keys),
    "heavy_vec": (queries.check_heavy_keys_vec, queries.check_heavy_keys_vec),
    "heavy_rel_vec": (queries.check_heavy_keys_rel_vec, queries.check_heavy_keys_rel_vec),
    "subgraph": (queries.subgraph_query, queries.subgraph_query),
    "subgraph_opt": (queries.subgraph_query_opt, queries.subgraph_query_opt),
    "subgraph_batch": (queries.subgraph_query_batch, queries.subgraph_query_batch),
    "reach_pre": (reach.reach_query_precomputed, reach.reach_query_precomputed),
    "closure": (reach.transitive_closure, cuda_transitive_closure),
    "closure_refresh": (reach.closure_refresh, _cuda_closure_refresh),
}


def _map(fn, out):
    return tuple(fn(o) for o in out) if isinstance(out, tuple) else fn(out)


def run_padded(fn: Callable, head: Tuple, keys, tail: Tuple, pad_q: int, chunk_q: int):
    """``fn(*head, *keys, *tail)`` over key arrays (each (Q,)): pad Q up to a
    multiple of ``pad_q`` with zeros, chunk beyond ``chunk_q``, slice the
    answers back (the padded lanes' answers are dropped)."""
    q = keys[0].shape[0]
    outs = []
    for lo in range(0, max(q, 1), chunk_q):
        hi = min(q, lo + chunk_q)
        part = [k[lo:hi] for k in keys]
        n = hi - lo
        pad = (-n) % pad_q
        if pad:
            part = [F.pad(k, (0, pad)) for k in part]
        out = fn(*head, *part, *tail)
        outs.append(_map(lambda o: o[:n], out) if pad else out)
    if len(outs) == 1:
        return outs[0]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(xs) for xs in zip(*outs))
    return torch.cat(outs)


class QueryEngine:
    """A query backend with query padding/chunking and an epoch-tagged
    transitive-closure cache."""

    def __init__(
        self,
        backend: str = "auto",
        pad_q: int = DEFAULT_PAD_Q,
        chunk_q: int = DEFAULT_CHUNK_Q,
        closure_staleness_budget: int = CLOSURE_STALENESS_BUDGET,
        closure_refresh_frac: float = CLOSURE_REFRESH_FRAC,
    ):
        if backend not in (None, "auto", *QUERY_BACKENDS):
            raise ValueError(f"unknown query backend: {backend!r} (want {QUERY_BACKENDS})")
        self.backend = backend
        self.pad_q = pad_q
        self.chunk_q = max(chunk_q, pad_q)
        self.closure_staleness_budget = closure_staleness_budget
        self.closure_refresh_frac = closure_refresh_frac
        self._closure: Optional[torch.Tensor] = None
        self._closure_epoch: Optional[int] = None
        self._closure_family: Optional[bytes] = None
        self.closure_refreshes = 0              # full O(w³ log w) builds
        self.closure_incremental_refreshes = 0  # touched-row O(T·w²) refreshes
        self._incremental_since_full = 0
        # Engine dispatches per family (one per padded/chunked batch call).
        self.dispatches: collections.Counter = collections.Counter()

    def _fn(self, family: str, device: torch.device) -> Callable:
        torch_fn, cuda_fn = _FAMILIES[family]
        return cuda_fn if resolve_query_backend(self.backend, device) == "cuda" else torch_fn

    @staticmethod
    def family_probe(family: str, *, width: int = 64, depth: int = 2, n_queries: int = 32,
                     device="cpu", backend: str = "cuda"):
        """The cost plane's sizing hook (``repro_torch.analysis``; the
        reference's ``QueryEngine.family_probe``,
        ``src/repro/core/query_engine.py:157``): ``family``'s estimator on
        ``backend`` and its arguments on an empty sketch at (w, d, Q).
        ``cuda`` takes the kernel wrappers, which run their plain versions
        on CPU tensors.  Returns ``(fn, args, counters_shape)``."""
        cfg = SketchConfig(depth=depth, width_rows=width, width_cols=width)
        sk = GLavaSketch.empty(cfg, 0, torch.device(device))
        keys = keys_to_tensor(np.arange(n_queries, dtype=np.uint32), sk.device)
        shape = tuple(sk.counters.shape)
        cuda = resolve_query_backend(backend, sk.device) == "cuda"
        fn = _FAMILIES[family][cuda]
        if family == "edge":
            return fn, (sk, keys, keys + 1), shape
        if family in ("in_flow", "out_flow", "flow"):
            return fn, (sk, keys), shape
        if family in ("heavy_vec", "heavy_rel_vec"):
            thetas = torch.full((n_queries,), 0.5, dtype=torch.float32, device=sk.device)
            return fn, (sk, keys, thetas), shape
        if family == "closure":
            return fn, (sk.counters,), shape
        if family == "closure_refresh":
            closure = _FAMILIES["closure"][cuda](sk.counters)
            return fn, (closure, sk.counters, sk.row_hash(keys[: min(8, n_queries)])), shape
        raise ValueError(f"no cost probe for query family {family!r}")

    # -- padding/chunking ----------------------------------------------------

    def _run_padded(self, family: str, sketch_args, keys, tail_args: Tuple = ()):
        """Run a per-query family over key arrays (each (Q,)): pad Q up to a
        multiple of pad_q, chunk beyond chunk_q, slice the answers back."""
        self.dispatches[family] += 1
        fn = self._fn(family, sketch_args[0].device)
        return run_padded(fn, sketch_args, keys, tail_args, self.pad_q, self.chunk_q)

    # -- query families ------------------------------------------------------

    def edge(self, sketch: GLavaSketch, src, dst):
        return self._run_padded("edge", (sketch,), (src, dst))

    def in_flow(self, sketch: GLavaSketch, keys):
        return self._run_padded("in_flow", (sketch,), (keys,))

    def out_flow(self, sketch: GLavaSketch, keys):
        return self._run_padded("out_flow", (sketch,), (keys,))

    def flow(self, sketch: GLavaSketch, keys):
        return self._run_padded("flow", (sketch,), (keys,))

    def heavy(self, sketch: GLavaSketch, keys, theta: float):
        theta_t = torch.tensor(theta, dtype=torch.float32).to(sketch.device, non_blocking=True)
        return self._run_padded("heavy", (sketch,), (keys,), (theta_t,))

    def heavy_vec(self, sketch: GLavaSketch, keys, thetas):
        """Heavy-hitter check with a PER-QUERY θ array (padded with zeros
        alongside the keys; padded lanes are sliced away)."""
        return self._run_padded("heavy_vec", (sketch,), (keys, thetas.to(torch.float32)))

    def heavy_rel_vec(self, sketch: GLavaSketch, keys, thetas):
        """Per-query RELATIVE-θ heavy-hitter check (flows against θ·F̃)."""
        return self._run_padded("heavy_rel_vec", (sketch,), (keys, thetas.to(torch.float32)))

    def subgraph(self, sketch: GLavaSketch, src, dst, optimized: bool = False):
        # Subgraph queries reduce over the WHOLE edge set — zero padding
        # would change the answer — so they run at their exact shape.
        family = "subgraph_opt" if optimized else "subgraph"
        self.dispatches[family] += 1
        return self._fn(family, sketch.device)(sketch, src, dst)

    def subgraph_batch(self, sketch: GLavaSketch, src, dst, mask):
        """n subgraph queries padded to a common k with a validity mask."""
        self.dispatches["subgraph_batch"] += 1
        return self._fn("subgraph_batch", sketch.device)(sketch, src, dst, mask)

    # -- reachability + closure cache ----------------------------------------

    @staticmethod
    def _family_key(sketch: GLavaSketch) -> bytes:
        """Hash-family identity BY VALUE, from the family's host copy."""
        return sketch.row_hash.a_host.tobytes()

    def _closure_fresh(self, sketch: GLavaSketch, epoch: Optional[int]) -> bool:
        return (
            self._closure is not None
            and epoch is not None
            and epoch == self._closure_epoch
            and self._closure_family == self._family_key(sketch)
        )

    def closure_for(self, sketch: GLavaSketch, epoch: Optional[int] = None) -> torch.Tensor:
        """The transitive closure of ``sketch.counters``, rebuilt only when
        ``epoch`` differs from the cached tag (``None`` always rebuilds) or
        the cached closure belongs to another hash family.  One stream per
        engine: same-family callers must keep their epochs disjoint."""
        if not self._closure_fresh(sketch, epoch):
            self._closure = self._fn("closure", sketch.device)(sketch.counters)
            self._closure_epoch = epoch
            self._closure_family = self._family_key(sketch)
            self.closure_refreshes += 1
            self._incremental_since_full = 0
        return self._closure

    def refresh_closure(
        self, sketch: GLavaSketch, touched_keys, epoch: Optional[int] = None
    ) -> torch.Tensor:
        """Bring the cached closure up to ``epoch`` INCREMENTALLY from the
        rows the mutations since the cached epoch touched
        (``reach.closure_refresh``, exact for additions-only histories).

        ``touched_keys`` is a unique (U,) uint32 node-key array, OR a
        (d, w_r) bool BITMAP of touched row buckets (numpy or a torch
        tensor: the fused ingest kernel's form, ``GLavaSketch.update_fused_``),
        or ``None`` meaning unknown or not additions-only (deletes, merges),
        which — like a missing or foreign cached closure, a refresh past the
        staleness budget, or more than ``closure_refresh_frac`` of the rows
        touched (for a bitmap: in the most-touched depth) — falls back to a
        full :meth:`closure_for` build."""
        if self._closure_fresh(sketch, epoch):
            return self._closure
        can_incremental = (
            self._closure is not None
            and touched_keys is not None
            and epoch is not None
            and self._closure_family == self._family_key(sketch)
            and self._incremental_since_full < self.closure_staleness_budget
        )
        if can_incremental:
            if isinstance(touched_keys, torch.Tensor):
                touched_keys = touched_keys.cpu().numpy()  # a bitmap's one host copy
            touched_keys = np.atleast_1d(np.asarray(touched_keys))
            is_bitmap = touched_keys.ndim == 2
            # A bitmap is judged by its most-touched depth.
            touched_size = int(touched_keys.sum(axis=1).max()) if is_bitmap else touched_keys.size
            if touched_size > self.closure_refresh_frac * sketch.counters.shape[1]:
                can_incremental = False
        if not can_incremental:
            return self.closure_for(sketch, epoch)
        if touched_size == 0:
            # Nothing touched: the counters are unchanged, only retag.
            self._closure_epoch = epoch
            return self._closure
        with telemetry.span("tick.refresh"):
            if is_bitmap:
                # Per-depth touched row indices, right-padded with row 0 to a
                # shared T (idempotent under the union).
                t_pad = touched_size + (-touched_size) % CLOSURE_REFRESH_PAD_T
                rows_np = np.zeros((touched_keys.shape[0], t_pad), np.int64)
                for i, row_bits in enumerate(touched_keys):
                    idx = np.flatnonzero(row_bits)
                    rows_np[i, : idx.size] = idx
                rows = torch.from_numpy(rows_np).to(sketch.device)
            else:
                rows = sketch.row_hash(keys_to_tensor(touched_keys, sketch.device))  # (d, U)
                pad = (-rows.shape[1]) % CLOSURE_REFRESH_PAD_T
                if pad:
                    # Padding with row 0 is exact: an untouched row only restates
                    # paths the cached closure already contains.
                    rows = F.pad(rows, (0, pad))
            self._closure = self._fn("closure_refresh", sketch.device)(
                self._closure, sketch.counters, rows
            )
        self._closure_epoch = epoch
        self.closure_incremental_refreshes += 1
        self._incremental_since_full += 1
        return self._closure

    def reach(self, sketch: GLavaSketch, src, dst, epoch: Optional[int] = None):
        """Batched r̃(a, b) against the epoch-cached closure."""
        closure = self.closure_for(sketch, epoch)
        return self._run_padded("reach_pre", (sketch, closure), (src, dst))

    def invalidate(self):
        """Drop the cached closure (e.g. the sketch object was swapped)."""
        self._closure = None
        self._closure_epoch = None
        self._closure_family = None
        self._incremental_since_full = 0
