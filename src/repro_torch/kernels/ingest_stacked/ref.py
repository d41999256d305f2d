"""Plain PyTorch version of the stacked ingest (the reference's
``src/repro/core/sketch.py::scatter_stacked``): flat int64 offsets into the
stack, then three ``index_put_(accumulate=True)`` calls, in place."""
from __future__ import annotations

from typing import Tuple

import torch


def stacked_offsets(
    shape: Tuple[int, int, int, int],  # (N, d, wr, wc) of the stacked counters
    plane: torch.Tensor,               # (B,) int — target plane per edge
    rows: torch.Tensor,                # (d, B) int — row buckets
    cols: torch.Tensor,                # (d, B) int — column buckets
):
    """The flat int64 offsets of every slot (i, b) into the counters, the
    row register and the column register of an (N, d, wr, wc) stack, and the
    (d, B) mask of the slots that add (row in [0, wr), plane in [0, N)).
    Masked slots point at offset 0.  Every offset is int64, so a stack past
    2^31 cells is addressed exactly (the reference's int32 index wraps)."""
    n, d, wr, wc = shape
    p = plane.long()[None, :]
    r, c = rows.long(), cols.long()
    valid = (r >= 0) & (r < wr) & (p >= 0) & (p < n)
    zero = torch.zeros((), dtype=torch.int64, device=r.device)
    base = torch.where(valid, p * d + torch.arange(d, device=r.device)[:, None], zero)  # (d, B)
    r, c = torch.where(valid, r, zero), torch.where(valid, c, zero)
    flat_r = base * wr + r
    return valid, flat_r * wc + c, flat_r, base * wc + c


def stacked_ingest_ref(
    counters: torch.Tensor,   # (N, d, wr, wc) float32, updated in place
    row_flows: torch.Tensor,  # (N, d, wr) float32, updated in place
    col_flows: torch.Tensor,  # (N, d, wc) float32, updated in place
    plane: torch.Tensor,      # (B,) int — target plane per edge
    rows: torch.Tensor,       # (d, B) int — row buckets, -1 inert
    cols: torch.Tensor,       # (d, B) int — column buckets
    weights: torch.Tensor,    # (B,) float32
):
    """Add ``weights[b]`` to ``counters[plane[b], i, rows[i,b], cols[i,b]]``,
    ``row_flows[plane[b], i, rows[i,b]]`` and ``col_flows[plane[b], i,
    cols[i,b]]`` for every slot that adds; returns the three tensors."""
    valid, flat_c, flat_r, flat_col = stacked_offsets(tuple(counters.shape), plane, rows, cols)
    vals = torch.where(valid, weights.to(counters.dtype)[None, :], torch.zeros((), dtype=counters.dtype,
                                                                            device=counters.device))
    vals = vals.reshape(-1)
    for target, flat in ((counters, flat_c), (row_flows, flat_r), (col_flows, flat_col)):
        target.view(-1).index_put_((flat.reshape(-1),), vals, accumulate=True)
    return counters, row_flows, col_flows
