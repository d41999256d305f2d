"""FleetQueryEngine — every query family batched across the tenant axis.

Port of ``src/repro/fleet/query.py``.  Each family function is the fleet twin
of its :mod:`repro_torch.core.queries` estimator: queries carry a per-query
``slots`` lane beside the key lanes, the gather picks up the tenant as one
more advanced index, and the window axis (K slices) is summed ON THE
GATHERED CELLS — O(K·d·Q) work, never a T-wide reduction — so answers are
bit-identical to the plain estimator on that tenant's window-summed
``GLavaSketch`` (fp32 integer addition is order-independent in the exact
regime).  These are plain torch gathers on either device: the fleet families
reach no query kernel, and the single-session kernels take no slot lane.

Reachability keeps the per-tenant epoch-tagged closure cache, but builds and
refreshes are BATCHED: the stale tenants' window-summed counter stacks go
through one ``transitive_closure`` call over ``(S, d, w, w)`` — on the card
the CUDA closure kernel (``kernels/closure``, ``ceil(log2 w)`` launches a
build whatever S is), on the CPU the plain version, as ``QueryEngine``'s
backend table routes ``"closure"`` — or one ``closure_refresh`` with S folded
into the sketch axis (each plane is independent, so no loop over S): on the
card the byte refresh of ``kernels/boolmm``, which reads only the touched
rows of the counters, on the CPU ``reach.closure_refresh``.  The
reference pads S to a power of two for its jit cache; the port builds S
planes, and ``closure_builds`` / ``closure_incremental_refreshes`` count the
tenants as the reference's do.  The cache is keyed by SLOT, and per-tenant
epochs restart at 0 for every slot occupant, so every residency change
(eviction, admission, session close, reach-subscription cancel) must
``drop_closure(slot)``, or a readmitted tenant could be served the previous
occupant's closure at a colliding epoch.
"""
from __future__ import annotations

import collections
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.core import reach
from repro_torch.core.hashing import affine_hash_np
from repro_torch.core.queries import undirected_selfloop_correction
from repro_torch.core.query_engine import (
    CLOSURE_REFRESH_FRAC,
    CLOSURE_REFRESH_PAD_T,
    CLOSURE_STALENESS_BUDGET,
    DEFAULT_CHUNK_Q,
    DEFAULT_PAD_Q,
    QUERY_BACKENDS,
    resolve_query_backend,
    run_padded,
)
from repro_torch.fleet.stack import FleetSketch
from repro_torch.kernels.boolmm import ops as boolmm
from repro_torch.kernels.closure.ops import transitive_closure as cuda_transitive_closure


# ---------------------------------------------------------------------------
# Fleet family functions (slot-indexed twins of repro_torch.core.queries)
# ---------------------------------------------------------------------------


def _window_cells(state: FleetSketch, slots, r, c):
    """(K, d, Q) counter cells at per-query (slot, row, col)."""
    k, d = state.counters.shape[1], state.counters.shape[2]
    k_idx = torch.arange(k, device=r.device)[:, None, None]
    d_idx = torch.arange(d, device=r.device)[None, :, None]
    return state.counters[slots[None, None, :], k_idx, d_idx, r[None], c[None]]


def fleet_edge_query(state: FleetSketch, slots, src, dst):
    """f̃_e(a, b) per (tenant, edge) query: min over d of window-summed cells."""
    r, c = state.row_hash(src), state.col_hash(dst)
    est = _window_cells(state, slots, r, c).sum(dim=0).amin(dim=0)
    if not state.config.directed:
        est = undirected_selfloop_correction(est, src, dst)
    return est


def _register_gather(register, slots, h):
    """(T, K, d, w) register -> (Q,) min over d of window-summed gathers."""
    k, d = register.shape[1], register.shape[2]
    k_idx = torch.arange(k, device=h.device)[:, None, None]
    d_idx = torch.arange(d, device=h.device)[None, :, None]
    return register[slots[None, None, :], k_idx, d_idx, h[None]].sum(dim=0).amin(dim=0)


def fleet_in_flow(state: FleetSketch, slots, keys):
    return _register_gather(state.col_flows, slots, state.col_hash(keys))


def fleet_out_flow(state: FleetSketch, slots, keys):
    return _register_gather(state.row_flows, slots, state.row_hash(keys))


def fleet_flow(state: FleetSketch, slots, keys):
    if state.config.directed:
        return fleet_in_flow(state, slots, keys) + fleet_out_flow(state, slots, keys)
    return fleet_out_flow(state, slots, keys)


def fleet_stream_totals(state: FleetSketch, slots):
    """Per-query F̃ (Q,): min over d of the queried tenant's row-flow mass.
    The slot gather comes FIRST, so the reduction runs on the (Q, K, d, w_r)
    gathered rows, never over the whole stack."""
    return state.row_flows[slots].sum(dim=(1, 3)).amin(dim=1)


def fleet_heavy_rel_vec(state: FleetSketch, slots, keys, thetas):
    """Relative-θ heavy check against the QUERY'S OWN tenant total F̃."""
    cut = thetas.to(torch.float32) * fleet_stream_totals(state, slots).to(torch.float32)
    return fleet_in_flow(state, slots, keys) > cut, fleet_out_flow(state, slots, keys) > cut


def fleet_subgraph_batch(state: FleetSketch, slots, src, dst, mask):
    """n masked subgraph queries, each against its own tenant's window."""
    r, c = state.row_hash(src), state.col_hash(dst)  # (d, n, k)
    kk = state.counters.shape[1]
    k_idx = torch.arange(kk, device=r.device)[:, None, None, None]
    d_idx = torch.arange(r.shape[0], device=r.device)[None, :, None, None]
    cells = state.counters[slots[None, None, :, None], k_idx, d_idx, r[None], c[None]].sum(dim=0)  # (d, n, k)
    live = mask[None, :, :]
    present = torch.where(live, cells > 0, torch.ones_like(live)).all(dim=2)
    zero = torch.zeros((), device=cells.device)
    wsum = torch.where(live, cells, zero).sum(dim=2)
    return torch.where(present, wsum, zero).amin(dim=0)


def fleet_reach_pre(state: FleetSketch, closures, pos, src, dst):
    """Batched r̃(a, b) against a stacked (S, d, w, w) closure plane; ``pos``
    maps each query to its tenant's stack position."""
    r, c = state.row_hash(src), state.row_hash(dst)
    d_idx = torch.arange(r.shape[0], device=r.device)[:, None]
    return closures[pos[None, :], d_idx, r, c].all(dim=0)


def _window_sum(counters: torch.Tensor, sel: List[int]) -> torch.Tensor:
    """The selected tenants' window-summed counters, (S, d, w, w), summed
    slot by slot (no (S, K, d, w, w) gather)."""
    if counters.shape[1] == 1:
        return counters[torch.tensor(sel).to(counters.device, non_blocking=True), 0]
    return torch.stack([counters[s].sum(dim=0) for s in sel])


def _closure_build(closure_fn):
    def build(counters, sel: List[int]):
        """Batched full closure of the selected slots' window-summed
        adjacencies: one ``transitive_closure`` call over (S, d, w, w)."""
        return closure_fn(_window_sum(counters, sel))

    return build


def fleet_closure_refresh(closures, counters, sel: List[int], rows):
    """Batched incremental refresh: ``closure_refresh`` over the (S, d, w, w)
    closure stack, the selected slots' window-summed counters and the
    per-tenant touched-row plans (S, d, T), with S folded into the sketch
    axis."""
    s, d, w, _ = closures.shape
    out = reach.closure_refresh(
        closures.reshape(s * d, w, w), _window_sum(counters, sel).reshape(s * d, w, w), rows.reshape(s * d, -1)
    )
    return out.reshape(s, d, w, w)


def cuda_fleet_closure_refresh(closures, counters, sel: List[int], rows):
    """:func:`fleet_closure_refresh` on the 8-bit tensor cores
    (``kernels/boolmm``), S folded into the sketch axis: only the T touched
    rows of each selected slot's slices are read and window-summed (never
    the (S, d, w, w) window sum), as bytes; no float copy of a closure."""
    s, d, w, _ = closures.shape
    rows = boolmm.pad_rows(rows)
    t = rows.shape[2]
    sel_t = torch.tensor(sel).to(counters.device, non_blocking=True)[:, None, None]
    d_idx = torch.arange(d, device=counters.device)[None, :, None]
    if counters.shape[1] == 1:
        delta = counters[sel_t, 0, d_idx, rows] > 0                    # (S, d, T, w)
    else:
        delta = counters[sel_t, :, d_idx, rows].sum(dim=3) > 0         # (S, d, T, K, w) summed over K
    out = boolmm.closure_refresh(closures.reshape(s * d, w, w), delta.reshape(s * d, t, w), rows.reshape(s * d, t))
    return out.reshape(s, d, w, w)


# family -> (torch fn, cuda fn): the closure build and refresh have kernels.
_FLEET_FAMILIES: Dict[str, Tuple[Callable, Callable]] = {
    "edge": (fleet_edge_query, fleet_edge_query),
    "in_flow": (fleet_in_flow, fleet_in_flow),
    "out_flow": (fleet_out_flow, fleet_out_flow),
    "flow": (fleet_flow, fleet_flow),
    "heavy_rel_vec": (fleet_heavy_rel_vec, fleet_heavy_rel_vec),
    "subgraph_batch": (fleet_subgraph_batch, fleet_subgraph_batch),
    "reach_pre": (fleet_reach_pre, fleet_reach_pre),
    "closure": (_closure_build(reach.transitive_closure), _closure_build(cuda_transitive_closure)),
    "closure_refresh": (fleet_closure_refresh, cuda_fleet_closure_refresh),
}


class FleetQueryEngine:
    """Query padding/chunking and the slot-keyed, epoch-tagged batched
    closure cache: the ``QueryEngine`` surface, fleet-wide.  ``backend`` is
    ``torch``, ``cuda`` or ``auto`` (the closure kernel for a stack on a
    CUDA device)."""

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
        # slot -> (closure (d, w, w) bool, epoch); per-slot staleness count.
        self._closures: Dict[int, Tuple[torch.Tensor, int]] = {}
        self._since_full: Dict[int, int] = {}
        self.closure_builds = 0
        self.closure_incremental_refreshes = 0
        self.dispatches: collections.Counter = collections.Counter()

    def _fn(self, family: str, device: torch.device) -> Callable:
        torch_fn, cuda_fn = _FLEET_FAMILIES[family]
        return cuda_fn if resolve_query_backend(self.backend, device) == "cuda" else torch_fn

    @staticmethod
    def family_probe(family: str, *, tenants: int = 4, width: int = 64, depth: int = 2, n_queries: int = 32,
                     touched: int = 2, device="cpu", backend: str = "cuda"):
        """The cost plane's sizing hook (the reference's
        ``FleetQueryEngine.family_probe``, ``src/repro/fleet/query.py:221``):
        the fleet family's estimator on ``backend`` and its arguments on an
        empty stack at (T, w, d, Q, S), ``touched`` being S, the number of
        tenants a closure build or refresh takes.  Returns ``(fn, args,
        counters_shape)``."""
        from repro_torch.core.hashing import keys_to_tensor
        from repro_torch.core.sketch import SketchConfig

        cfg = SketchConfig(depth=depth, width_rows=width, width_cols=width)
        state = FleetSketch.empty(cfg, tenants, 0, device=torch.device(device))
        dev = state.device
        slots = torch.arange(n_queries, device=dev) % tenants
        keys = keys_to_tensor(np.arange(n_queries, dtype=np.uint32), dev)
        shape = tuple(state.counters.shape)
        cuda = resolve_query_backend(backend, dev) == "cuda"
        fn = _FLEET_FAMILIES[family][cuda]
        sel = [i % tenants for i in range(touched)]
        if family == "edge":
            return fn, (state, slots, keys, keys + 1), shape
        if family in ("in_flow", "out_flow", "flow"):
            return fn, (state, slots, keys), shape
        if family == "heavy_rel_vec":
            return fn, (state, slots, keys, torch.full((n_queries,), 0.5, dtype=torch.float32, device=dev)), shape
        if family == "closure":
            return fn, (state.counters, sel), shape
        if family == "closure_refresh":
            closures = _FLEET_FAMILIES["closure"][cuda](state.counters, sel)
            rows = state.row_hash(keys[: min(8, n_queries)])[None].expand(touched, -1, -1).contiguous()
            return fn, (closures, state.counters, sel, rows), shape
        raise ValueError(f"no cost probe for fleet family {family!r}")

    # -- padding/chunking (QueryEngine's) -----------------------------------------

    def _run_padded(self, family: str, head, keys, tail=()):
        # Slot/pos lanes pad with 0: they gather slot 0, and the padded
        # answers are sliced away.
        self.dispatches[family] += 1
        return run_padded(self._fn(family, head[0].device), head, keys, tail, self.pad_q, self.chunk_q)

    # -- query families ------------------------------------------------------

    def edge(self, state: FleetSketch, slots, src, dst):
        return self._run_padded("edge", (state,), (slots, src, dst))

    def in_flow(self, state: FleetSketch, slots, keys):
        return self._run_padded("in_flow", (state,), (slots, keys))

    def out_flow(self, state: FleetSketch, slots, keys):
        return self._run_padded("out_flow", (state,), (slots, keys))

    def flow(self, state: FleetSketch, slots, keys):
        return self._run_padded("flow", (state,), (slots, keys))

    def heavy_rel_vec(self, state: FleetSketch, slots, keys, thetas):
        return self._run_padded("heavy_rel_vec", (state,), (slots, keys, thetas.to(torch.float32)))

    def subgraph_batch(self, state: FleetSketch, slots, src, dst, mask):
        # Subgraph batches run at their exact (n, k) shape: zero-padding the
        # edge axis would change absent-edge semantics.
        self.dispatches["subgraph_batch"] += 1
        return self._fn("subgraph_batch", state.device)(state, slots, src, dst, mask)

    # -- batched closure plane ----------------------------------------------

    def drop_closure(self, slot: int) -> None:
        """Forget one slot's closure — REQUIRED on every slot occupancy
        change (evict / admit / close / reach-subscription cancel): epochs
        restart per occupant, so a stale entry could otherwise satisfy the
        next occupant's epoch tag."""
        self._closures.pop(slot, None)
        self._since_full.pop(slot, None)

    def invalidate(self) -> None:
        self._closures.clear()
        self._since_full.clear()

    def refresh_closures(self, state: FleetSketch, items) -> None:
        """Bring many tenants' closures up to their epochs in at most one
        full-build dispatch plus one incremental-refresh dispatch.

        ``items`` is ``[(slot, delta, epoch)]`` with ``delta`` the unique
        touched-key array accumulated since the slot's cached epoch, or
        ``None`` for "unknown / not additions-only" (deletes, window advance,
        fault-in), which forces a full rebuild — the escalation ladder of
        ``QueryEngine.refresh_closure`` (fraction and staleness-budget
        fallbacks, empty-delta retag)."""
        w_r = state.config.width_rows
        build: List[Tuple[int, int]] = []
        refresh: List[Tuple[int, np.ndarray, int]] = []
        for slot, delta, epoch in items:
            cached = self._closures.get(slot)
            if cached is not None and cached[1] == epoch:
                continue
            if cached is None or delta is None or self._since_full.get(slot, 0) >= self.closure_staleness_budget:
                build.append((slot, epoch))
                continue
            delta = np.atleast_1d(np.asarray(delta))
            if delta.size > self.closure_refresh_frac * w_r:
                build.append((slot, epoch))
                continue
            if delta.size == 0:
                # Nothing touched: counters unchanged, only retag.
                self._closures[slot] = (cached[0], epoch)
                continue
            refresh.append((slot, delta, epoch))
        if build:
            self._build(state, build)
        if refresh:
            self._refresh(state, refresh)

    def _build(self, state: FleetSketch, items) -> None:
        closures = self._fn("closure", state.device)(state.counters, [s for s, _ in items])
        self.dispatches["closure"] += 1
        for i, (slot, epoch) in enumerate(items):
            self._closures[slot] = (closures[i], epoch)
            self._since_full[slot] = 0
            self.closure_builds += 1

    def _refresh(self, state: FleetSketch, items) -> None:
        with telemetry.span("tick.refresh"):
            a, b = state.row_hash.a_host, state.row_hash.b_host
            w_r = state.config.width_rows
            t_max = max(delta.size for _, delta, _ in items)
            t_pad = t_max + (-t_max) % CLOSURE_REFRESH_PAD_T
            # Row plans on the host by the exact hash twin; padding with row 0 is
            # exact (an untouched row restates paths the closure already holds).
            rows_np = np.zeros((len(items), a.shape[0], t_pad), np.int64)
            for i, (_, delta, _) in enumerate(items):
                rows_np[i, :, : delta.size] = affine_hash_np(
                    delta.astype(np.uint32, copy=False)[None, :], a[:, None], b[:, None], w_r
                )
            slots = [slot for slot, _, _ in items]
            closures = torch.stack([self._closures[s][0] for s in slots])
            rows = torch.from_numpy(rows_np).to(state.device, non_blocking=True)
            out = self._fn("closure_refresh", state.device)(closures, state.counters, slots, rows)
        self.dispatches["closure_refresh"] += 1
        for i, (slot, _, epoch) in enumerate(items):
            self._closures[slot] = (out[i], epoch)
            self._since_full[slot] = self._since_full.get(slot, 0) + 1
            self.closure_incremental_refreshes += 1

    def reach(
        self,
        state: FleetSketch,
        slots,
        src,
        dst,
        epochs: Dict[int, int],
        touched: Optional[Dict[int, Optional[np.ndarray]]] = None,
    ):
        """Batched r̃(a, b) with a per-query tenant lane (``slots`` as numpy):
        ensure every distinct tenant's closure is at its epoch (one batched
        build and/or refresh), stack the fresh closures (a view when one
        tenant is asked), and answer all queries in one gather."""
        slots_np = np.asarray(slots)
        uniq = np.unique(slots_np)
        self.refresh_closures(
            state, [(int(s), (touched or {}).get(int(s)), epochs[int(s)]) for s in uniq]
        )
        if uniq.size == 1:
            closures = self._closures[int(uniq[0])][0][None]
        else:
            closures = torch.stack([self._closures[int(s)][0] for s in uniq])
        pos = torch.from_numpy(np.searchsorted(uniq, slots_np).astype(np.int64)).to(state.device)
        return self._run_padded("reach_pre", (state, closures), (pos, src, dst))
