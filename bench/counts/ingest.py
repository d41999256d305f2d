"""Bytes the ingest kernels need, frozen copies of the bound functions of
``chip_smoke.py`` (``ingest_bound_bytes``, ``key_bound_bytes``,
``stacked_bound_bytes``) written on counts instead of tensors.

A slot is one entry of the batch a kernel reads; a weighted slot adds into
the counters.  Each add reads and writes one 32-byte sector of counters; the
indices, keys and weights are read once.  The callers pass the slots the
inputs need (the distinct pairs of a pre-aggregated batch), never a padding."""
from __future__ import annotations

import torch


def bucket_bound_bytes(depth: int, adds: int, slots: int, index_bytes: int) -> int:
    """B1's bucket entry: ``adds`` weighted (slot, sketch) adds, the (d, B)
    row and column buckets and the (B,) float32 weights of ``slots`` slots."""
    return adds * 64 + depth * slots * 2 * index_bytes + slots * 4


def key_bound_bytes(depth: int, weighted: int, slots: int, mirror: bool) -> int:
    """B1's key entry: d adds a weighted slot (2d mirrored), two int64 keys
    and a float32 weight read a slot."""
    return depth * weighted * (2 if mirror else 1) * 64 + slots * (8 + 8 + 4)


def stacked_bound_bytes(shape, plane: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
                        index_bytes: int = 8, plane_bytes: int = 4) -> int:
    """The fleet's stacked ingest on an (N, d, w_r, w_c) stack: a sector read
    and written for every distinct counter and register sector the batch adds
    into, the (d, B) rows and columns, and the (B,) plane and float32 weights
    read once.  ``plane`` (B,), ``rows`` and ``cols`` (d, B), all weighted."""
    n, d, wr, wc = shape
    base = plane.long()[None, :] * d + torch.arange(d, device=rows.device)[:, None]
    flat_r = base * wr + rows.long()
    flats = (flat_r * wc + cols.long(), flat_r, base * wc + cols.long())
    sectors = sum(int(torch.unique(f // 8).numel()) for f in flats)
    b = plane.shape[0]
    return sectors * 64 + d * b * 2 * index_bytes + b * (plane_bytes + 4)


def distinct_pairs(src: torch.Tensor, dst: torch.Tensor) -> int:
    """Distinct (src, dst) pairs of a batch of uint32 keys."""
    return int(torch.unique((src.long() << 32) | dst.long()).numel())
