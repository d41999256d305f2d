"""Wrapper of the batch collapse on the card (``csrc/preagg.cu``), a
port-only kernel that takes the place of the host's
``core/ingest.py::preaggregate_host`` for a session whose summary is on a
CUDA device.

:func:`preagg_collapse` takes the raw batch as one (3, B) int32 tensor (the
uint32 keys of both columns and the float32 bits of the weights: one copy
from the host), adds every distinct source's and destination's total into
the flow registers, marks the touched rows in a (d, w_r) bitmap, and returns
the distinct pairs as B1's key entry takes them (``kernels/ingest/ops.py::
ingest_keys``): ``bucket_size(B)`` slots, the pairs first in any order, then
weight 0.  On the card it is one call of the C function, which makes two
launches (the collapse, then the emit) on the current stream, and reads one
packed record (:data:`RECORD`) with the key entry's coefficient tail.  Its
open-addressing tables and the pair arrays live in a :class:`CollapseTables`
the caller keeps between batches: each batch leaves the tables empty, and
the stream orders B1's read of one batch's pairs before the next batch's
collapse writes them.  CPU tensors take the plain version and need no
tables.

``preagg_collapse.launches`` counts the calls that launched (two kernels
each)."""
from __future__ import annotations

import struct
from typing import Optional

import torch

from repro_torch.core.hashing import HashFamily
from repro_torch.core.ingest import bucket_size
from repro_torch.kernels import build
from repro_torch.kernels.ingest.ops import ADD_BYTES, _coefficients, check_state
from repro_torch.kernels.preagg.ref import preagg_collapse_ref

# csrc/preagg.cu's Record: the batch, the tables (pair keys, node keys, sums,
# the marker's sums, the counts), the pair arrays, both registers, the
# bitmap (0 for none) and the two families' (d,) a and b on the device; d,
# wr, wc, B, the tables' slots this batch and allocated, the pair slots and
# the mirror flag; the stream.  Then d x (row a, row b, column a, column b).
RECORD = struct.Struct("=16Q8qQ")
# Bytes of a pair written for B1: two int64 keys and a float32 weight.
PAIR_BYTES = 20


class CollapseTables:
    """The card pass's state on one device, kept between batches: three
    open-addressing tables of ``slots`` each (pairs, sources,
    destinations), which every batch leaves empty, and the (slots / 2,) pair
    arrays B1 reads.  A batch of B edges uses the first 2 * bucket_size(B)
    slots (load factor at most 0.5); a larger batch reallocates, empty."""

    def __init__(self):
        self.slots = 0
        self.device: Optional[torch.device] = None

    def reserve(self, batch: int, device: torch.device) -> int:
        """The table slots a batch of ``batch`` edges uses, allocating on
        ``device`` if they do not fit yet."""
        cap = 2 * bucket_size(batch)
        if cap > self.slots or self.device != device:
            self.pair_keys = torch.full((cap,), -1, dtype=torch.int64, device=device)
            self.node_keys = torch.full((2, cap), -1, dtype=torch.int32, device=device)
            self.sums = torch.zeros((3, cap), dtype=torch.float32, device=device)
            self.marker_sums = torch.zeros(3, dtype=torch.float32, device=device)
            self.counts = torch.zeros(4, dtype=torch.int32, device=device)
            self.src = torch.zeros(cap // 2, dtype=torch.int64, device=device)
            self.dst = torch.zeros(cap // 2, dtype=torch.int64, device=device)
            self.weights = torch.zeros(cap // 2, dtype=torch.float32, device=device)
            self.slots, self.device = cap, device
        return cap


def _collapse_cost(batch, row_flows, col_flows, touched, row_hash, col_hash, mirror=False, tables=None):
    """Three inserts an edge and, at most, d register adds a distinct source
    and destination (twice mirrored); the bytes the function must move, at
    most (every edge distinct): the batch read once, a pair written an edge,
    a sector a register add, the bitmap written.  The tables' own traffic is
    the design's, not the function's, and is left out."""
    b = batch.shape[1]
    adds = 2 * row_flows.shape[0] * b * (2 if mirror else 1)
    bitmap = touched.numel() if touched is not None else 0
    return 3 * b + adds, 12 * b + b * PAIR_BYTES + adds * ADD_BYTES + bitmap


def check_collapse(batch: torch.Tensor, row_flows: torch.Tensor, col_flows: torch.Tensor,
                   touched: Optional[torch.Tensor], row_hash: HashFamily, col_hash: HashFamily) -> int:
    """Check a packed batch, the registers, the bitmap and the families, the
    same on either device; return the device index (-1 on the CPU)."""
    if batch.dtype is not torch.int32 or batch.dim() != 2 or batch.shape[0] != 3 or not batch.is_contiguous():
        raise ValueError(f"batch must be a contiguous (3, B) int32 tensor, got {tuple(batch.shape)} {batch.dtype}")
    dev = batch.get_device()
    if dev < 0 and not batch.is_cpu:
        raise ValueError(f"preagg_collapse runs on CUDA or CPU, got {batch.device}")
    d, wr, wc = row_flows.shape[0], row_hash.w, col_hash.w
    check_state("row_flows", row_flows, torch.float32, (d, wr), dev)
    check_state("col_flows", col_flows, torch.float32, (d, wc), dev)
    if touched is not None:
        check_state("touched", touched, torch.bool, (d, wr), dev)
    if row_hash.depth != d or col_hash.depth != d or row_hash.a.get_device() != dev or col_hash.a.get_device() != dev:
        raise ValueError(f"the families must hash d={d} rows on the batch's device, got depths {row_hash.depth}, "
                         f"{col_hash.depth} on {row_hash.device}, {col_hash.device}")
    return dev


@build.costed(_collapse_cost)
def preagg_collapse(
    batch: torch.Tensor,                 # (3, B) int32: src, dst, the weights' float32 bits
    row_flows: torch.Tensor,             # (d, wr) float32, updated in place
    col_flows: torch.Tensor,             # (d, wc) float32, updated in place
    touched: Optional[torch.Tensor],     # (d, wr) bool, overwritten with the batch's rows, or None
    row_hash: HashFamily,                # d hashes onto [0, wr)
    col_hash: HashFamily,                # d hashes onto [0, wc)
    mirror: bool = False,
    tables: Optional[CollapseTables] = None,
):
    """Collapse a raw batch: each distinct source's total into ``row_flows``
    at its d rows (and into ``touched``), each distinct destination's into
    ``col_flows``, with ``mirror`` (an undirected sketch) the mirrored roles
    too.  Returns the distinct pairs and their sums as ``(src, dst,
    weights)``: (bucket_size(B),) int64, int64, float32, weight 0 past the
    pairs.  On the card the arrays belong to ``tables`` and hold until its
    next batch."""
    dev = check_collapse(batch, row_flows, col_flows, touched, row_hash, col_hash)
    b = batch.shape[1]
    if dev < 0:
        return preagg_collapse_ref(batch, row_flows, col_flows, touched, row_hash, col_hash, mirror, bucket_size(b))
    if tables is None:
        raise ValueError("preagg_collapse on the card needs the caller's CollapseTables")
    cap = tables.reserve(b, batch.device)
    n_out = cap // 2
    d, wr = row_flows.shape
    record = RECORD.pack(
        batch.data_ptr(), tables.pair_keys.data_ptr(), tables.node_keys.data_ptr(), tables.sums.data_ptr(),
        tables.marker_sums.data_ptr(), tables.counts.data_ptr(), tables.src.data_ptr(), tables.dst.data_ptr(),
        tables.weights.data_ptr(), row_flows.data_ptr(), col_flows.data_ptr(),
        0 if touched is None else touched.data_ptr(),
        row_hash.a.data_ptr(), row_hash.b.data_ptr(), col_hash.a.data_ptr(), col_hash.b.data_ptr(),
        d, wr, col_flows.shape[1], b, cap, tables.slots, n_out, int(bool(mirror)),
        torch._C._cuda_getCurrentRawStream(dev),
    ) + _coefficients(row_hash, col_hash)
    build.launch("preagg", "glava_preagg", dev, record)
    preagg_collapse.launches += 1
    return tables.src[:n_out], tables.dst[:n_out], tables.weights[:n_out]


preagg_collapse.launches = 0
