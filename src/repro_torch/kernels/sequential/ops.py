"""Wrapper of the order-dependent sketch updates (``csrc/sequential.cu``),
a port-only kernel: the reference runs ``GLavaSketch.update_sequential`` and
``update_conservative`` (``src/repro/core/sketch.py:399`` and ``:420``) as a
``lax.scan`` over the edges, which it leaves to XLA, with no Pallas kernel.

The launch path is the ingest kernels' (``kernels/ingest/ops.py``): the same
checks (int32 or int64 buckets as they come, nothing else, float32 weights),
the same packed launch record, launched by ``kernels/build.py::launch``.
One launch runs the whole batch in one warp, lane i owning sketch i, so the
depth is at most 32 on either device.

``sequential_update.launches`` counts the kernel launches."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ingest.ops import INDEX_BYTES, RECORD, check_batch
from repro_torch.kernels.sequential.ref import sequential_update_ref

# One warp, one lane a sketch.
MAX_DEPTH = 32
# The record's flag: conservative mode.
CONSERVATIVE = 1


def _sequential_cost(counters, rows, cols, weights, conservative):
    """An update a (sketch, edge), each cell read and written (8 bytes);
    the indices and weights read once."""
    n = rows.numel()
    return n, 8 * n + 2 * n * rows.element_size() + 4 * weights.numel()


@build.costed(_sequential_cost)
def sequential_update(
    counters: torch.Tensor,   # (d, wr, wc) float32, contiguous, updated in place
    rows: torch.Tensor,       # (d, B) int32 or int64 — row buckets in [0, wr)
    cols: torch.Tensor,       # (d, B) same dtype as rows — column buckets in [0, wc)
    weights: torch.Tensor,    # (B,) float32
    conservative: bool,
) -> torch.Tensor:
    """Fold the batch in edge by edge, in stream order, in place; returns
    ``counters``.  Sequential mode adds each edge's weight to its d cells;
    conservative mode raises each of them to ``max(cell, min of the d cells
    + weight)``.  CPU tensors take the plain version; on the card an edge
    with a bucket out of range is left out (the plain version raises)."""
    dev = check_batch("sequential_update", counters, rows, cols, weights)
    d, wr, wc = counters.shape
    if d > MAX_DEPTH:
        raise ValueError(f"sequential_update takes at most {MAX_DEPTH} sketches, got {d}")
    if dev < 0:
        return sequential_update_ref(counters, rows, cols, weights, conservative)
    if not rows.is_contiguous():
        rows = rows.contiguous()
    if not cols.is_contiguous():
        cols = cols.contiguous()
    if not weights.is_contiguous():
        weights = weights.contiguous()
    record = RECORD.pack(
        counters.data_ptr(), 0, 0, 0, rows.data_ptr(), cols.data_ptr(), weights.data_ptr(),
        d, wr, wc, rows.shape[1], 0, INDEX_BYTES[rows.dtype], CONSERVATIVE if conservative else 0,
        torch._C._cuda_getCurrentRawStream(dev),
    )
    build.launch("sequential", "glava_sequential_update", dev, record)
    sequential_update.launches += 1
    return counters


sequential_update.launches = 0
