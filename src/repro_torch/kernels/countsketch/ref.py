"""Plain PyTorch versions of the CountSketch and of its median decode (port
of ``src/repro/kernels/countsketch/ref.py`` and of the gather + median in
``src/repro/train/compression.py::_unsketch``)."""
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


def median_ref(vals: torch.Tensor) -> torch.Tensor:
    """Median over dim 0 by ``jnp.median``'s rule: NaN wherever any of the
    d values is NaN, else ``(lo + hi) * 0.5`` of the two middle values (one
    and the same value when d is odd; ``torch.median`` would return the
    lower one when d is even)."""
    d = vals.shape[0]
    srt = vals.sort(dim=0).values  # NaN sorts last
    mid = (srt[(d - 1) // 2] + srt[d // 2]) * 0.5
    return torch.where(srt[-1].isnan(), srt[-1], mid)


def median_of_cells_ref(table: torch.Tensor, h: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """table (d, w), buckets h (d, n), signs s (d, n) -> (n,)
    ``median_i(s[i,j] * table[i, h[i,j]])``."""
    return median_ref(torch.gather(table, 1, h.long()) * s.to(table.dtype))


def countsketch_median_ref(table: torch.Tensor, family, n: int) -> torch.Tensor:
    """The decode of a (d, w) CountSketch ``table`` under ``family`` for the
    coordinates ``0..n-1`` -> (n,): hash, gather, sign, median."""
    from repro_torch.kernels.countsketch.ops import hash_indices

    return median_of_cells_ref(table, *hash_indices(family, n))
