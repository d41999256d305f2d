"""Plain PyTorch version of the CountSketch (port of
``src/repro/kernels/countsketch/ref.py``)."""
from __future__ import annotations

import torch


def countsketch_ref(
    vec: torch.Tensor,
    h: torch.Tensor,
    s: torch.Tensor,
    width: int,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """vec (n,), h (d, n) buckets, s (d, n) ±1 -> (d, width) table in
    ``dtype``: ``table[i, h[i,j]] += s[i,j] * vec[j]``, one ``index_add_``
    over the flattened (d·width) table."""
    d = h.shape[0]
    vals = s.to(dtype) * vec.to(dtype)[None, :]
    flat = (torch.arange(d, device=h.device)[:, None] * width + h.long()).reshape(-1)
    table = torch.zeros(d * width, dtype=dtype, device=vec.device)
    return table.index_add_(0, flat, vals.reshape(-1)).view(d, width)
