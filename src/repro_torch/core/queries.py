"""Query estimators over gLava sketches (paper Sections 3.4 and 4).

Port of ``src/repro/core/queries.py``: the families ``QueryEngine``
registers, the Section-4.2 monitor, the wildcard, bound-wildcard and
triangle queries of Examples 6-7, and the analytics run on the summary as a
graph (global triangle mass, PageRank).  Every estimator follows the
paper's map/reduce recipe: evaluate on each of the d sketches, merge with Γ
(min for weights, AND for booleans).  All but the triangle queries are
batched over queries.

The float32 products here (``global_triangle_estimate``,
``sketch_pagerank``) are ``torch`` calls, as the reference leaves them to
XLA.  The port never enables TF32: its 10-bit mantissa would round counter
values above 2,048.
"""
from __future__ import annotations

import torch

from typing import Optional, Tuple

from repro_torch import telemetry
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


def monitor_step(
    sketch: GLavaSketch,
    src: torch.Tensor,
    dst: torch.Tensor,
    weight: torch.Tensor,
    watch_key: torch.Tensor,
    theta: float,
) -> Tuple[torch.Tensor, GLavaSketch]:
    """Paper Section 4.2's 3-step real-time monitor for f̃_v(a,←) > θ
    (reference ``monitor_step``, ``src/repro/core/queries.py:81``): estimate
    the watched key's in-flow, alarm if the batch's edges into it push it
    over θ, then update.  Functional, as the reference: returns ``(alarm,
    new_sketch)`` and leaves ``sketch`` as it was."""
    inflow = node_in_flow(sketch, watch_key[None])[0]
    hits = (dst == watch_key).to(torch.float32) * weight
    alarm = inflow + hits.sum() > theta
    return alarm, sketch.update(src, dst, weight)


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
    return subgraph_from_cells(sketch.counters[d_idx, r, c])  # (d, k) cells


def subgraph_from_cells(cells: torch.Tensor) -> torch.Tensor:
    """f̃(Q) from the (d, k) cells of Q's edges: per sketch, their sum if
    every cell is nonzero, else 0; then the min over sketches."""
    present = (cells > 0).all(dim=1)
    weight_i = torch.where(present, cells.sum(dim=1), torch.zeros((), device=cells.device))
    return weight_i.amin()


def subgraph_query_opt(sketch: GLavaSketch, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """The paper's optimized f̃'(Q) = Σ_k f̃_e(x_k, y_k), zero if any edge
    estimate is zero."""
    return subgraph_from_estimates(edge_query(sketch, src, dst))


def subgraph_from_estimates(per_edge: torch.Tensor) -> torch.Tensor:
    """f̃'(Q) from Q's (k,) edge estimates."""
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
    return subgraph_batch_from_cells(sketch.counters[d_idx, r, c], mask)  # (d, n, k) cells


def subgraph_batch_from_cells(cells: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Batched f̃(Q) from the (d, n, k) cells of n padded queries and their
    (n, k) mask of real edges."""
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


# ---------------------------------------------------------------------------
# Wildcard, bound-wildcard and triangle queries (Section 3.4, Examples 6-7)
# ---------------------------------------------------------------------------


def wildcard_edge_query(
    sketch: GLavaSketch, src: Optional[torch.Tensor], dst: Optional[torch.Tensor]
) -> torch.Tensor:
    """f̃_e with wildcard endpoints (reference ``wildcard_edge_query``,
    ``src/repro/core/queries.py:196``): f̃_e(x, *) = f̃_v(x, →),
    f̃_e(*, y) = f̃_v(y, ←), and (*, *) the total stream weight, a (1,)
    tensor read from the row register."""
    if src is None and dst is None:
        return stream_total_weight(sketch)[None]
    if dst is None:
        return node_out_flow(sketch, src)
    if src is None:
        return node_in_flow(sketch, dst)
    return edge_query(sketch, src, dst)


def bound_wildcard_path2(sketch: GLavaSketch, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Bound-wildcard query f̃({(*_1, b), (c, *_1)}), the common-neighbour /
    triangle-closing count of Example 7 (reference ``bound_wildcard_path2``,
    ``src/repro/core/queries.py:215``): per sketch the dot product of row
    h(c) with column h(b), min over the d sketches.  Square sketches only."""
    if not sketch.config.is_square:
        raise ValueError("bound wildcards require a square sketch")
    hb = sketch.col_hash(b)  # (d, Q)
    hc = sketch.row_hash(c)
    d_idx = torch.arange(sketch.depth, device=hb.device)[:, None]
    col_b = sketch.counters[d_idx, :, hb]  # (d, Q, w): column h(b), as rows
    row_c = sketch.counters[d_idx, hc, :]  # (d, Q, w)
    return torch.einsum("dqw,dqw->dq", col_b, row_c).amin(dim=0)


def triangle_query(sketch: GLavaSketch, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f̃ of the labeled 3-clique {(a,b),(b,c),(c,a)} (Example 7, Q4;
    reference ``triangle_query``, ``src/repro/core/queries.py:235``), for
    one triple of 0-d keys."""
    return subgraph_query(sketch, torch.stack([a, b, c]), torch.stack([b, c, a]))


def global_triangle_estimate(sketch: GLavaSketch) -> torch.Tensor:
    """Global directed-triangle mass, min over sketches of trace(M_i³), the weighted closed
    3-walks (reference ``global_triangle_estimate``, ``src/repro/core/queries.py:244``).
    Computed as ``min_d Σ_ij (M²)_ij · M_ji``: one batched float32 product and an
    elementwise reduction, with no (d, w, w, w) temporary."""
    with telemetry.span("analytics.triangles"):
        m = sketch.counters
        return (torch.bmm(m, m) * m.transpose(1, 2)).sum(dim=(1, 2)).amin()


# ---------------------------------------------------------------------------
# Heavy hitters & analytics on the summary
# ---------------------------------------------------------------------------


def heavy_hitter_buckets(sketch: GLavaSketch, theta: float):
    """Buckets whose out/in flow exceeds θ, per sketch (reference
    ``heavy_hitter_buckets``, ``src/repro/core/queries.py:258``): candidate
    heavy-hitter node sets from the registers, ``((d, w_r), (d, w_c))``
    bool."""
    return sketch.row_flows > theta, sketch.col_flows > theta


def sketch_pagerank(sketch: GLavaSketch, damping: float = 0.85, iters: int = 32) -> torch.Tensor:
    """PageRank run directly on each sketch graph (paper Section 3.3 Remark;
    reference ``sketch_pagerank``, ``src/repro/core/queries.py:271``):
    ``iters`` batched vector–matrix steps over the row-stochastic counters,
    dangling mass spread uniformly.  Returns (d, w) bucket ranks."""
    m = sketch.counters
    out = m.sum(dim=2, keepdim=True)
    p = torch.where(out > 0, m / out.clamp_min(1e-9), torch.zeros((), device=m.device))
    w = m.shape[-1]
    rank = torch.full((m.shape[0], 1, w), 1.0 / w, device=m.device)
    for _ in range(iters):
        step = torch.bmm(rank, p)  # (d, 1, w): one propagation
        leaked = 1.0 - damping * step.sum(-1, keepdim=True)
        rank = damping * step + leaked / w
    return rank[:, 0, :]
