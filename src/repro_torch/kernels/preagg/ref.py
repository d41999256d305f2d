"""Plain PyTorch version of the batch collapse (``csrc/preagg.cu``):
:func:`collapse_ref` sums a batch by distinct (src, dst) pair, source and
destination (``torch.unique`` and ``index_add_``), and
:func:`preagg_collapse_ref` adds the totals into the flow registers, marks
the touched rows and hands the pairs over as B1's key entry takes them.

Semantics shared with the kernel: every distinct source (and, mirrored,
destination) is marked, whatever its total; the pairs come first in the
(bucket_size(B),) arrays, then slots of key 0 and weight 0.  In the integer
regime the sums equal ``core/ingest.py::preaggregate_host``'s bit for bit."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.hashing import HashFamily

KEY_MASK = 0xFFFFFFFF


def unpack_batch(batch: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A (3, B) int32 batch (src and dst uint32 bits, the weights' float32
    bits) as int64 keys and float32 weights."""
    return batch[0].long() & KEY_MASK, batch[1].long() & KEY_MASK, batch[2].view(torch.float32)


def _sums(keys: torch.Tensor, weights: torch.Tensor):
    uniq, inverse = torch.unique(keys, return_inverse=True)
    return uniq, torch.zeros(uniq.shape, dtype=torch.float32, device=keys.device).index_add_(0, inverse, weights)


def collapse_ref(src: torch.Tensor, dst: torch.Tensor, weights: torch.Tensor):
    """``(src, dst, weights, src_unique, src_totals, dst_unique, dst_totals)``
    of a batch of (B,) int64 keys holding uint32 values and (B,) float32
    weights: one entry per distinct pair, source and destination, sorted."""
    pairs, pair_w = _sums((src << 32) | dst, weights)
    src_unique, src_totals = _sums(src, weights)
    dst_unique, dst_totals = _sums(dst, weights)
    return (pairs >> 32) & KEY_MASK, pairs & KEY_MASK, pair_w, src_unique, src_totals, dst_unique, dst_totals


def _scatter(register: torch.Tensor, buckets: torch.Tensor, totals: torch.Tensor) -> None:
    """``register[i, buckets[i, u]] += totals[u]`` for every depth i, in place."""
    d, w = register.shape
    flat = (torch.arange(d, device=register.device)[:, None] * w + buckets).reshape(-1)
    register.view(-1).index_add_(0, flat, totals.expand(buckets.shape).reshape(-1))


def preagg_collapse_ref(
    batch: torch.Tensor,                # (3, B) int32
    row_flows: torch.Tensor,            # (d, wr) float32, updated in place
    col_flows: torch.Tensor,            # (d, wc) float32, updated in place
    touched: Optional[torch.Tensor],    # (d, wr) bool, overwritten, or None
    row_hash: HashFamily,
    col_hash: HashFamily,
    mirror: bool,
    out_size: int,
):
    """The card pass's function: the totals into the registers, the rows
    into ``touched``, and the pairs as ``(src, dst, weights)`` of
    ``out_size`` slots (the pairs, then key 0 and weight 0)."""
    src, dst, w = unpack_batch(batch)
    ps, pd, pw, su, st, du, dt = collapse_ref(src, dst, w)
    _scatter(row_flows, row_hash(su), st)
    _scatter(col_flows, col_hash(du), dt)
    if mirror:
        _scatter(row_flows, row_hash(du), dt)
        _scatter(col_flows, col_hash(su), st)
    if touched is not None:
        rows = row_hash(torch.cat([su, du]) if mirror else su)
        touched.zero_()
        flat = (torch.arange(rows.shape[0], device=rows.device)[:, None] * touched.shape[1] + rows).reshape(-1)
        touched.view(-1)[flat] = True
    pad = out_size - ps.shape[0]
    return tuple(torch.cat([x, x.new_zeros(pad)]) for x in (ps, pd, pw))
