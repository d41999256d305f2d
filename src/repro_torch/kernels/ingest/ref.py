"""Plain PyTorch versions of the ingest scatter (port of
``src/repro/kernels/ingest/ref.py``): the paper's per-edge scatter
``M_i[r_i(b), c_i(b)] += w(b)``, vectorized, in place, on buckets hashed
before (:func:`ingest_scatter_ref`) or on the keys, hashed here
(:func:`ingest_keys_ref`)."""
from __future__ import annotations

import torch

from repro_torch.core.hashing import HashFamily


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


def ingest_keys_ref(
    counters: torch.Tensor,   # (d, wr_local, wc) float32, updated in place
    src: torch.Tensor,        # (B,) int64 holding uint32 keys
    dst: torch.Tensor,        # (B,) int64 holding uint32 keys
    weights: torch.Tensor,    # (B,) float32
    row_hash: HashFamily,     # d hashes onto the GLOBAL rows
    col_hash: HashFamily,     # d hashes onto [0, wc)
    row_offset: int = 0,
    mirror: bool = False,
) -> torch.Tensor:
    """The reference's route: hash ``(src, dst)`` by both families, then
    :func:`ingest_scatter_ref`; with ``mirror`` (an undirected sketch) the
    mirrored edges ``(dst, src)`` too, by a second scatter."""
    ingest_scatter_ref(counters, row_hash(src), col_hash(dst), weights, row_offset)
    if mirror:
        ingest_scatter_ref(counters, row_hash(dst), col_hash(src), weights, row_offset)
    return counters
