"""Reachability on graph sketches via transitive closure.

Port of ``src/repro/core/reach.py``.  The paper (Section 4.3) runs a
black-box ``reach()`` on each sketch and ANDs the d answers; the
accelerator-shaped equivalent is transitive closure by repeated boolean
matrix squaring, ``A <- A OR (A @ A > 0)``, ``ceil(log2 w)`` times.  One
closure answers all-pairs reachability, so its cost amortizes over query
batches (DESIGN.md Section 2).

The functions here are the plain PyTorch path; the card's squaring step
lives in ``repro_torch.kernels.closure``, and its :func:`closure_refresh`,
every product on the 8-bit tensor cores, in ``repro_torch.kernels.boolmm``
(the reference leaves the refresh's products to XLA).
"""
from __future__ import annotations

import math

import torch


def transitive_closure(adj: torch.Tensor, include_self: bool = True) -> torch.Tensor:
    """Boolean transitive closure of (..., w, w) adjacency (float/bool in,
    bool out), batched over the leading dims (the d sketches)."""
    a = adj > 0
    w = adj.shape[-1]
    if include_self:
        a = a | torch.eye(w, dtype=torch.bool, device=adj.device)
    n_steps = max(1, math.ceil(math.log2(max(2, w))))
    for _ in range(n_steps):
        af = a.to(torch.float32)
        a = a | (torch.matmul(af, af) > 0)
    return a


def k_hop_reach(adj: torch.Tensor, k: int) -> torch.Tensor:
    """Nodes reachable within at most ``k`` hops (reference ``k_hop_reach``,
    ``src/repro/core/reach.py:110``), bool, batched over the leading dims:
    ``(adj > 0) | I``, then ``k - 1`` steps ``out | (out · a > 0)``.  The
    0/1 product runs in bfloat16 (``torch.matmul``, float32 accumulation on
    the card): a sum of non-negative products is positive exactly when one
    product is, so the answer is exact at any width."""
    a = adj > 0
    out = a | torch.eye(adj.shape[-1], dtype=torch.bool, device=adj.device)
    ab = a.to(torch.bfloat16)
    for _ in range(max(0, k - 1)):
        out = out | (torch.matmul(out.to(torch.bfloat16), ab) > 0)
    return out


def closure_refresh(
    closure: torch.Tensor, counters: torch.Tensor, rows: torch.Tensor
) -> torch.Tensor:
    """Incrementally refresh a cached (d, w, w) bool closure from touched
    rows ``rows`` (d, T) — exact when ``counters`` was reached from the
    closure's state by ADDITIONS ONLY (a superset of touched rows, with
    duplicates or padding, is fine).

    With B = closure, Δ = the touched rows of the new adjacency and S the
    touched-row to touched-row hop graph, the new closure is
    ``B ∨ B[:, R] · S* · (Δ·B)``; element-identical to a from-scratch
    :func:`transitive_closure` of ``counters`` (DESIGN.md Section 8)."""
    d, w, _ = closure.shape
    t = rows.shape[1]
    rows = rows.long()
    b = closure.to(torch.float32)                                   # (d, w, w)
    d_idx = torch.arange(d, device=closure.device)[:, None]
    delta = (counters[d_idx, rows, :] > 0).to(torch.float32)        # (d, T, w)
    # One touched-row departure followed by any old path (B includes self).
    u = torch.matmul(delta, b) > 0                                  # (d, T, w)
    # Touched-row to touched-row hop graph and its small closure.
    s = torch.gather(u, 2, rows[:, None, :].expand(d, t, t))        # (d, T, T)
    s_star = transitive_closure(s, include_self=True)               # (d, T, T)
    # Any number of touched-row departures, ending anywhere.
    w_reach = torch.matmul(s_star.to(torch.float32), u.to(torch.float32)) > 0
    # Old path into a touched row, then the touched-row path machinery.
    g = torch.gather(b, 2, rows[:, None, :].expand(d, w, t))        # (d, w, T)
    add = torch.matmul(g, w_reach.to(torch.float32)) > 0
    return closure | add


def reach_query(sketch, src_keys: torch.Tensor, dst_keys: torch.Tensor) -> torch.Tensor:
    """Batched r̃(a, b): AND over the d sketches of per-sketch reachability
    (paper Section 4.3).  Requires a square sketch."""
    if not sketch.config.is_square:
        raise ValueError("reachability requires a square gLava sketch")
    return reach_query_precomputed(
        sketch, transitive_closure(sketch.counters), src_keys, dst_keys
    )


def reach_query_precomputed(sketch, closure: torch.Tensor, src_keys, dst_keys):
    """:func:`reach_query` against a cached closure (the serving path)."""
    r = sketch.row_hash(src_keys)
    c = sketch.row_hash(dst_keys)
    d_idx = torch.arange(r.shape[0], device=r.device)[:, None]
    return closure[d_idx, r, c].all(dim=0)
