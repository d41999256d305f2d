"""Plain PyTorch version of the order-dependent sketch updates: the
reference's ``lax.scan`` bodies of ``GLavaSketch.update_sequential`` and
``update_conservative`` (``src/repro/core/sketch.py:399`` and ``:420``), one
edge at a time, in place."""
from __future__ import annotations

import torch


def sequential_update_ref(
    counters: torch.Tensor,   # (d, wr, wc) float32, updated in place
    rows: torch.Tensor,       # (d, B) int — row buckets in [0, wr)
    cols: torch.Tensor,       # (d, B) int — column buckets in [0, wc)
    weights: torch.Tensor,    # (B,) float32
    conservative: bool,
) -> torch.Tensor:
    """For e = 0..B-1 in order: add ``weights[e]`` to the edge's d cells, or
    (``conservative``) raise each cell to ``max(cell, min of the d cells +
    weights[e])``.  Raises on a bucket out of range."""
    d, wr, wc = counters.shape
    r, c = rows.long(), cols.long()
    if r.numel() and (r.min() < 0 or r.max() >= wr or c.min() < 0 or c.max() >= wc):
        raise ValueError(f"buckets must lie in [0, {wr}) x [0, {wc})")
    d_idx = torch.arange(d, device=counters.device)
    for e in range(r.shape[1]):
        idx = (d_idx, r[:, e], c[:, e])
        cur = counters[idx]
        if conservative:
            counters[idx] = torch.maximum(cur, cur.amin() + weights[e])
        else:
            counters[idx] = cur + weights[e]
    return counters
