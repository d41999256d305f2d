"""Query estimators over gLava sketches (paper Sections 3.4 and 4).

Port of ``src/repro/core/queries.py`` (the families ``QueryEngine``
registers).  Every estimator follows the paper's map/reduce recipe:
evaluate on each of the d sketches, merge with Γ (min for weights, AND for
booleans).  All are batched over queries.
"""
from __future__ import annotations

import torch

from repro_torch.core import reach as reach_mod
from repro_torch.core.sketch import GLavaSketch
from repro_torch.kernels.query.ref import edge_query_min_ref


# ---------------------------------------------------------------------------
# Edge queries (Section 4.1)
# ---------------------------------------------------------------------------


def edge_query(sketch: GLavaSketch, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """f̃_e(a, b) = min_i ω_i(h_i(a), h_i(b)) for a batch of (a, b) pairs."""
    r, c = sketch.hash_edges(src, dst)
    est = edge_query_min_ref(sketch.counters, r, c)
    if not sketch.config.directed:
        est = undirected_selfloop_correction(est, src, dst)
    return est


def undirected_selfloop_correction(est, src, dst):
    """Undirected ingest doubled every edge; guard the self-loop double
    count.  Self-loop mass is always even, so integer counters halve
    exactly; divide in the counter dtype to keep the estimate dtype-stable.
    Shared by the torch and CUDA query backends."""
    if est.is_floating_point():
        half = est * 0.5
    else:
        half = torch.div(est, 2, rounding_mode="floor")
    return torch.where(src == dst, half, est)


# ---------------------------------------------------------------------------
# Point queries (Sections 4.2 / 5.2) — register gathers
# ---------------------------------------------------------------------------


def node_in_flow(sketch: GLavaSketch, keys: torch.Tensor) -> torch.Tensor:
    """f̃_v(a, ←) = min_i colsum(M_i[:, h_i(a)]), served from ``col_flows``
    (an O(d·Q) gather; the counters are never reduced)."""
    h = sketch.col_hash(keys)
    return torch.gather(sketch.col_flows, 1, h).amin(dim=0)


def node_out_flow(sketch: GLavaSketch, keys: torch.Tensor) -> torch.Tensor:
    """f̃_v(a, →) = min_i rowsum(M_i[h_i(a), :]), served from ``row_flows``."""
    h = sketch.row_hash(keys)
    return torch.gather(sketch.row_flows, 1, h).amin(dim=0)


def node_flow(sketch: GLavaSketch, keys: torch.Tensor) -> torch.Tensor:
    """f̃_v(a, ⊥): total incident weight (in + out for directed streams;
    undirected row sums already count every incident edge)."""
    if sketch.config.directed:
        return node_in_flow(sketch, keys) + node_out_flow(sketch, keys)
    return node_out_flow(sketch, keys)


# ---------------------------------------------------------------------------
# Path queries (Section 4.3)
# ---------------------------------------------------------------------------

reach_query = reach_mod.reach_query
reach_query_precomputed = reach_mod.reach_query_precomputed
transitive_closure = reach_mod.transitive_closure


# ---------------------------------------------------------------------------
# Aggregate subgraph queries (Sections 3.4 / 4.4)
# ---------------------------------------------------------------------------


def subgraph_query(sketch: GLavaSketch, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """f̃(Q) for Q = {(x_1,y_1)..(x_k,y_k)}: per sketch, the sum of the k
    cells if every edge is present in it, else 0; then min over sketches."""
    r, c = sketch.hash_edges(src, dst)
    d_idx = torch.arange(r.shape[0], device=r.device)[:, None]
    cells = sketch.counters[d_idx, r, c]                 # (d, k)
    present = (cells > 0).all(dim=1)
    weight_i = torch.where(present, cells.sum(dim=1), torch.zeros((), device=cells.device))
    return weight_i.amin()


def subgraph_query_opt(sketch: GLavaSketch, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """The paper's optimized f̃'(Q) = Σ_k f̃_e(x_k, y_k), zero if any edge
    estimate is zero."""
    per_edge = edge_query(sketch, src, dst)
    total = per_edge.sum()
    return torch.where((per_edge == 0).any(), torch.zeros((), device=total.device), total)


def subgraph_query_batch(sketch: GLavaSketch, src, dst, mask) -> torch.Tensor:
    """Batched f̃(Q) for n subgraph queries padded to a common edge count k:
    ``src``/``dst`` (n, k) keys, ``mask`` (n, k) marks REAL edges; padded
    slots count as present with weight 0 (exact under the revised
    absent-edge semantics)."""
    r = sketch.row_hash(src)                              # (d, n, k)
    c = sketch.col_hash(dst)
    d_idx = torch.arange(r.shape[0], device=r.device)[:, None, None]
    cells = sketch.counters[d_idx, r, c]                 # (d, n, k)
    live = mask[None, :, :]
    present = torch.where(live, cells > 0, torch.ones_like(live)).all(dim=2)
    wsum = torch.where(live, cells, torch.zeros((), device=cells.device)).sum(dim=2)
    weight_i = torch.where(present, wsum, torch.zeros((), device=cells.device))
    return weight_i.amin(dim=0)


# ---------------------------------------------------------------------------
# Heavy hitters
# ---------------------------------------------------------------------------


def check_heavy_keys(sketch: GLavaSketch, keys, theta):
    """Boolean monitor f̃_v(a,←) > θ and f̃_v(a,→) > θ for a key batch."""
    return node_in_flow(sketch, keys) > theta, node_out_flow(sketch, keys) > theta


def check_heavy_keys_vec(sketch: GLavaSketch, keys, thetas):
    """Per-query-threshold form of :func:`check_heavy_keys` (``thetas`` (Q,))."""
    return node_in_flow(sketch, keys) > thetas, node_out_flow(sketch, keys) > thetas


def stream_total_weight(sketch: GLavaSketch) -> torch.Tensor:
    """F̃, the total stream weight estimate: min over sketches of the row
    register's sum (an O(d·w_r) reduction)."""
    return sketch.row_flows.sum(dim=1).amin()


def check_heavy_keys_rel_vec(sketch: GLavaSketch, keys, thetas):
    """RELATIVE heavy-hitter check (the API plane's θ): heavy when the flow
    exceeds the fraction θ ∈ (0, 1] of F̃."""
    cut = thetas.to(torch.float32) * stream_total_weight(sketch).to(torch.float32)
    return node_in_flow(sketch, keys) > cut, node_out_flow(sketch, keys) > cut
