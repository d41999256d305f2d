"""Plain PyTorch version of the one-pass fused ingest (port of
``src/repro/kernels/ingest_fused/ref.py``): the counter scatter, the scatter
into both flow registers, and the touched-row bitmap, in place.

Semantics shared with the kernel (``csrc/ingest_fused.cu``):
  * rows == -1 (padding) contribute NOTHING: not to the counters, not to
    either flow register, not to the bitmap;
  * ``touched[i, r]`` is True iff some valid slot hashes to row r, even
    with weight 0 (a superset of the changed rows is all the incremental
    closure refresh needs).
"""
from __future__ import annotations

from typing import Optional

import torch


def fused_ingest_ref(
    counters: torch.Tensor,    # (d, wr, wc) float32, updated in place
    row_flows: torch.Tensor,   # (d, wr) float32, updated in place
    col_flows: torch.Tensor,   # (d, wc) float32, updated in place
    rows: torch.Tensor,        # (d, B) int — row buckets, -1 inert
    cols: torch.Tensor,        # (d, B) int — column buckets in [0, wc)
    weights: torch.Tensor,     # (B,) float
    touched: Optional[torch.Tensor] = None,  # (d, wr) bool, ORed into
):
    """Returns ``(counters, row_flows, col_flows, touched)`` with touched a
    new (d, wr) bool tensor, or the given one with this batch's rows ORed in
    (the second launch of an undirected sketch)."""
    d, wr, wc = counters.shape
    valid = rows >= 0
    safe_r = torch.where(valid, rows.long(), torch.zeros((), dtype=torch.long, device=rows.device))
    c = cols.long()
    w = weights.to(counters.dtype)[None, :].expand(rows.shape)
    w = torch.where(valid, w, torch.zeros((), dtype=counters.dtype, device=w.device)).reshape(-1)
    d_idx = torch.arange(d, device=counters.device)[:, None]
    counters.view(-1).index_add_(0, ((d_idx * wr + safe_r) * wc + c).reshape(-1), w)
    row_flows.view(-1).index_add_(0, (d_idx * wr + safe_r).reshape(-1), w)
    col_flows.view(-1).index_add_(0, (d_idx * wc + c).reshape(-1), w)
    if touched is None:
        touched = torch.zeros((d, wr), dtype=torch.bool, device=counters.device)
    touched.view(-1)[(d_idx * wr + safe_r)[valid]] = True
    return counters, row_flows, col_flows, touched
