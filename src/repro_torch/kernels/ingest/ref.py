"""Plain PyTorch version of the ingest scatter (port of
``src/repro/kernels/ingest/ref.py``): the paper's per-edge scatter
``M_i[r_i(b), c_i(b)] += w(b)``, vectorized, in place."""
from __future__ import annotations

import torch


def ingest_scatter_ref(
    counters: torch.Tensor,   # (d, wr_local, wc) float32, updated in place
    rows: torch.Tensor,       # (d, B) int — GLOBAL row buckets, -1 inert
    cols: torch.Tensor,       # (d, B) int — column buckets
    weights: torch.Tensor,    # (B,) float32
    row_offset: int = 0,
) -> torch.Tensor:
    """Rows outside ``[row_offset, row_offset + wr_local)`` contribute
    nothing: they are masked by INDEX (weight 0 at a safe cell), never by
    rounding the weight, as ``repro.core.ingest._scatter`` does."""
    d, wr, wc = counters.shape
    local_r = rows.long() - int(row_offset)
    in_shard = (local_r >= 0) & (local_r < wr)
    w = weights.to(counters.dtype)[None, :].expand(local_r.shape)
    w = torch.where(in_shard, w, torch.zeros((), dtype=counters.dtype, device=w.device))
    safe_r = torch.where(in_shard, local_r, torch.zeros_like(local_r))
    d_idx = torch.arange(d, device=counters.device)[:, None]
    flat = ((d_idx * wr + safe_r) * wc + cols.long()).reshape(-1)
    counters.view(-1).index_add_(0, flat, w.reshape(-1))
    return counters
