"""Wrapper of the CUDA stacked ingest (``csrc/ingest_stacked.cu``), a
port-only kernel for the reference's flat XLA scatter
``src/repro/core/sketch.py::scatter_stacked`` (the fleet's one ingest
dispatch per batch).

It takes the ingest scatter's launch path (``kernels/ingest/ops.py``): the
same checks on either device, generalised to stacked counters
(``check_batch(..., stacked=True)``); int32 and int64 buckets and planes as
they come (any other dtype raises, nothing is cast); float32 weights; one
packed launch record in :data:`~repro_torch.kernels.ingest.ops.RECORD`'s
layout, launched by ``kernels/build.py::launch`` on the raw handle of the
device's current stream.

``stacked_ingest.launches`` counts the kernel launches."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ingest.ops import ADD_BYTES, INDEX_BYTES, RECORD, check_batch, check_state
from repro_torch.kernels.ingest_stacked.ref import stacked_ingest_ref


def _stacked_cost(counters, row_flows, col_flows, plane, rows, cols, weights):
    """Three adds a (sketch, slot), whatever the number of planes; the
    indices, planes and weights read once."""
    adds = 3 * rows.numel()
    b = weights.numel()
    return adds, adds * ADD_BYTES + 2 * rows.numel() * rows.element_size() + b * (plane.element_size() + 4)


@build.costed(_stacked_cost)
def stacked_ingest(
    counters: torch.Tensor,   # (N, d, wr, wc) float32, contiguous, updated in place
    row_flows: torch.Tensor,  # (N, d, wr) float32, contiguous, updated in place
    col_flows: torch.Tensor,  # (N, d, wc) float32, contiguous, updated in place
    plane: torch.Tensor,      # (B,) int32 or int64 — target plane per edge
    rows: torch.Tensor,       # (d, B) int32 or int64 — row buckets, -1 inert
    cols: torch.Tensor,       # (d, B) same dtype as rows — column buckets in [0, wc)
    weights: torch.Tensor,    # (B,) float32
):
    """Fold one hashed batch into the stacked counters and both stacked
    registers in place, each edge into its plane; returns ``(counters,
    row_flows, col_flows)``.  CPU tensors take the plain version."""
    dev = check_batch("stacked_ingest", counters, rows, cols, weights, stacked=True)
    n, d, wr, wc = counters.shape
    check_state("row_flows", row_flows, torch.float32, (n, d, wr), dev)
    check_state("col_flows", col_flows, torch.float32, (n, d, wc), dev)
    if plane.dtype not in INDEX_BYTES or plane.shape != weights.shape:
        raise ValueError(f"plane must be a (B={weights.shape[0]},) int32 or int64 tensor, got "
                         f"{tuple(plane.shape)} {plane.dtype}")
    if plane.get_device() != dev:
        raise ValueError(f"plane must be on the counters' device, got {plane.device}")
    if dev < 0:
        return stacked_ingest_ref(counters, row_flows, col_flows, plane, rows, cols, weights)
    if not plane.is_contiguous():
        plane = plane.contiguous()
    if not rows.is_contiguous():
        rows = rows.contiguous()
    if not cols.is_contiguous():
        cols = cols.contiguous()
    if not weights.is_contiguous():
        weights = weights.contiguous()
    record = RECORD.pack(
        counters.data_ptr(), row_flows.data_ptr(), col_flows.data_ptr(), plane.data_ptr(),
        rows.data_ptr(), cols.data_ptr(), weights.data_ptr(),
        n, d, wr, wc, rows.shape[1], INDEX_BYTES[rows.dtype], INDEX_BYTES[plane.dtype],
        torch._C._cuda_getCurrentRawStream(dev),
    )
    build.launch("ingest_stacked", "glava_ingest_stacked", dev, record)
    stacked_ingest.launches += 1
    return counters, row_flows, col_flows


stacked_ingest.launches = 0
