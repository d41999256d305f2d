"""Wrapper of the CUDA one-pass fused ingest (``csrc/ingest_fused.cu``), the
port of ``src/repro/kernels/ingest_fused/kernel.py::fused_ingest_pallas``, on
the ingest scatter's launch path (``kernels/ingest/ops.py``): the same
checks, int32 or int64 buckets as they come and nothing else, float32
weights, one packed launch record.  The C function zeroes a new bitmap
itself (``cudaMemsetAsync`` on the launch's stream), or ORs into the one
the caller passes.

Unlike the reference's ``ops.py`` there is no width cap: the reference fell
back to its plain twin above a padded width of 2,048 because the TPU kernel's
stripe had to fit in VMEM; the CUDA kernel keeps nothing on chip, so a CUDA
tensor launches it at every width.

``fused_ingest.launches`` counts the kernel launches."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ingest.ops import ADD_BYTES, INDEX_BYTES, RECORD, check_batch, check_state
from repro_torch.kernels.ingest_fused.ref import fused_ingest_ref

# The record's flag: OR into the caller's bitmap instead of zeroing a new one.
KEEP_TOUCHED = 1


def _fused_cost(counters, row_flows, col_flows, rows, cols, weights, touched=None):
    """Three adds a (sketch, slot): a counter and both registers; the
    (d, wr) bitmap written once, the indices and weights read once."""
    adds = 3 * rows.numel()
    return adds, adds * ADD_BYTES + row_flows.numel() + 2 * rows.numel() * rows.element_size() + 4 * weights.numel()


@build.costed(_fused_cost)
def fused_ingest(
    counters: torch.Tensor,    # (d, wr, wc) float32, contiguous, updated in place
    row_flows: torch.Tensor,   # (d, wr) float32, contiguous, updated in place
    col_flows: torch.Tensor,   # (d, wc) float32, contiguous, updated in place
    rows: torch.Tensor,        # (d, B) int32 or int64 — row buckets, -1 inert
    cols: torch.Tensor,        # (d, B) same dtype as rows — column buckets in [0, wc)
    weights: torch.Tensor,     # (B,) float32
    touched: Optional[torch.Tensor] = None,  # (d, wr) bool, contiguous, ORed into
):
    """Fold one hashed batch into the counters and both flow registers in
    place and mark its rows; returns ``(counters, row_flows, col_flows,
    touched)`` with touched a new (d, wr) bool tensor, or the given one with
    this batch's rows ORed in.  CPU tensors take the plain version."""
    dev = check_batch("fused_ingest", counters, rows, cols, weights)
    cshape = counters.shape
    d, wr, wc = cshape
    check_state("row_flows", row_flows, torch.float32, cshape[:2], dev)
    check_state("col_flows", col_flows, torch.float32, cshape[::2], dev)
    if touched is not None:
        check_state("touched", touched, torch.bool, cshape[:2], dev)
    if dev < 0:
        return fused_ingest_ref(counters, row_flows, col_flows, rows, cols, weights, touched)
    if not rows.is_contiguous():
        rows = rows.contiguous()
    if not cols.is_contiguous():
        cols = cols.contiguous()
    if not weights.is_contiguous():
        weights = weights.contiguous()
    flags = KEEP_TOUCHED
    if touched is None:
        touched = counters.new_empty(d, wr, dtype=torch.bool)  # zeroed by the C function
        flags = 0
    record = RECORD.pack(
        counters.data_ptr(), row_flows.data_ptr(), col_flows.data_ptr(), touched.data_ptr(),
        rows.data_ptr(), cols.data_ptr(), weights.data_ptr(),
        d, wr, wc, rows.shape[1], 0, INDEX_BYTES[rows.dtype], flags,
        torch._C._cuda_getCurrentRawStream(dev),
    )
    build.launch("ingest_fused", "glava_fused_ingest", dev, record)
    fused_ingest.launches += 1
    return counters, row_flows, col_flows, touched


fused_ingest.launches = 0
