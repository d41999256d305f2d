"""Wrapper of the CUDA ingest scatter (``csrc/ingest.cu``), the port of
``src/repro/kernels/ingest/kernel.py::ingest_pallas``, and the launch path it
shares with the fused ingest (``kernels/ingest_fused/ops.py``) and the
fleet's stacked ingest (``kernels/ingest_stacked/ops.py``).

The launch path is ``kernels/query/ops.py``'s: one helper checks the
operands the same way on either device (it builds no tensors and no
``torch.device`` objects); int32 and int64 buckets go to the kernel as they
come (each has its own instantiation; any other dtype, and rows and columns
of different dtypes, raise, nothing is cast); weights are float32 (both
callers, ``core/ingest.py::ingest`` and ``GLavaSketch.update_fused_``,
convert before they call); both kernels read one packed launch record
(:data:`RECORD`), launched by ``kernels/build.py::launch``; the stream is
the raw handle of the device's current stream.

``ingest_scatter.launches`` counts the kernel launches."""
from __future__ import annotations

import struct

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ingest.ref import ingest_scatter_ref

# csrc/ingest.cu's and csrc/ingest_fused.cu's Record: the counters, row_flows,
# col_flows, touched, rows, cols and weights pointers; d, wr, wc, B, the row
# offset, the index size in bytes and the flags; the stream.
RECORD = struct.Struct("=7Q7qQ")
# The index dtypes the kernels take, with their size in bytes.
INDEX_BYTES = {torch.int32: 4, torch.int64: 8}


def check_batch(what: str, counters: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
                weights: torch.Tensor, stacked: bool = False) -> int:
    """Check a hashed batch against its counters, the same on either device;
    return the device index (-1 on the CPU).  ``stacked`` counters carry a
    leading plane axis, (N, d, wr, wc)."""
    cshape = counters.shape
    lead = int(stacked)
    if counters.dtype is not torch.float32 or len(cshape) != 3 + lead or not counters.is_contiguous():
        raise ValueError(f"counters must be a contiguous {'(N, d, wr, wc)' if stacked else '(d, wr, wc)'} "
                         f"float32 tensor")
    shape = rows.shape
    if shape != cols.shape or len(shape) != 2 or shape[0] != cshape[lead]:
        raise ValueError(f"rows/cols must be (d={cshape[lead]}, B), got {tuple(shape)}, {tuple(cols.shape)}")
    if rows.dtype not in INDEX_BYTES or cols.dtype is not rows.dtype:
        raise ValueError(f"rows/cols must both be int32 or both int64, got {rows.dtype}, {cols.dtype}")
    if weights.dtype is not torch.float32 or weights.shape != shape[1:]:
        raise ValueError(f"weights must be a (B={shape[1]},) float32 tensor, got {tuple(weights.shape)} {weights.dtype}")
    dev = counters.get_device()
    if rows.get_device() != dev or cols.get_device() != dev or weights.get_device() != dev:
        raise ValueError(f"all operands must be on {counters.device}, got {rows.device}, {cols.device}, "
                         f"{weights.device}")
    if dev < 0 and not (counters.is_cpu and rows.is_cpu and cols.is_cpu and weights.is_cpu):
        raise ValueError(f"{what} runs on CUDA or CPU, got {counters.device}")
    return dev


def check_state(name: str, t: torch.Tensor, dtype, shape, dev: int) -> None:
    """Check one state tensor beside the counters (a register, a bitmap)."""
    if t.dtype is not dtype or t.shape != shape or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {tuple(shape)} {dtype} tensor, got {tuple(t.shape)} {t.dtype}")
    if t.get_device() != dev:
        raise ValueError(f"{name} must be on the counters' device, got {t.device}")


def ingest_scatter(
    counters: torch.Tensor,   # (d, wr_local, wc) float32, contiguous, updated in place
    rows: torch.Tensor,       # (d, B) int32 or int64 — global row buckets, -1 inert
    cols: torch.Tensor,       # (d, B) same dtype as rows — column buckets in [0, wc)
    weights: torch.Tensor,    # (B,) float32
    row_offset: int = 0,
) -> torch.Tensor:
    """``counters[i, rows[i,b] - row_offset, cols[i,b]] += weights[b]`` in
    place; returns ``counters``.  CPU tensors take the plain version."""
    dev = check_batch("ingest_scatter", counters, rows, cols, weights)
    if dev < 0:
        return ingest_scatter_ref(counters, rows, cols, weights, row_offset)
    if not rows.is_contiguous():
        rows = rows.contiguous()
    if not cols.is_contiguous():
        cols = cols.contiguous()
    if not weights.is_contiguous():
        weights = weights.contiguous()
    d, wr, wc = counters.shape
    record = RECORD.pack(
        counters.data_ptr(), 0, 0, 0, rows.data_ptr(), cols.data_ptr(), weights.data_ptr(),
        d, wr, wc, rows.shape[1], int(row_offset), INDEX_BYTES[rows.dtype], 0,
        torch._C._cuda_getCurrentRawStream(dev),
    )
    build.launch("ingest", "glava_ingest_scatter", dev, record)
    ingest_scatter.launches += 1
    return counters


ingest_scatter.launches = 0
