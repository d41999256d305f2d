"""Wrapper of the CUDA ingest scatter (``csrc/ingest.cu``), the port of
``src/repro/kernels/ingest/kernel.py::ingest_pallas``.

``ingest_scatter.launches`` counts the kernel launches."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ingest.ref import ingest_scatter_ref

_C = ctypes.c_int64
_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, _P, _P, _C, _C, _C, _C, _C, _P]


def ingest_scatter(
    counters: torch.Tensor,   # (d, wr_local, wc) float32, contiguous, updated in place
    rows: torch.Tensor,       # (d, B) int — global row buckets, -1 inert
    cols: torch.Tensor,       # (d, B) int — column buckets in [0, wc)
    weights: torch.Tensor,    # (B,) float
    row_offset: int = 0,
) -> torch.Tensor:
    """``counters[i, rows[i,b] - row_offset, cols[i,b]] += weights[b]`` in
    place; returns ``counters``.  CPU tensors take the plain version."""
    if counters.device.type == "cpu":
        return ingest_scatter_ref(counters, rows, cols, weights, row_offset)
    if counters.device.type != "cuda":
        raise ValueError(f"ingest_scatter runs on CUDA or CPU, got {counters.device}")
    if counters.dtype != torch.float32 or counters.dim() != 3 or not counters.is_contiguous():
        raise ValueError("counters must be a contiguous (d, wr, wc) float32 tensor")
    d, wr, wc = counters.shape
    if rows.shape != cols.shape or rows.dim() != 2 or rows.shape[0] != d:
        raise ValueError(
            f"rows/cols must be (d={d}, B), got {tuple(rows.shape)}, {tuple(cols.shape)}"
        )
    if weights.shape != (rows.shape[1],):
        raise ValueError(f"weights must be (B={rows.shape[1]},), got {tuple(weights.shape)}")
    for t in (rows, cols, weights):
        if t.device != counters.device:
            raise ValueError(f"all operands must be on {counters.device}, got {t.device}")
    r = rows.to(torch.int32).contiguous()
    c = cols.to(torch.int32).contiguous()
    w = weights.to(torch.float32).contiguous()
    with torch.cuda.device(counters.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = build.function("ingest", "glava_ingest_scatter", _ARGTYPES)(
            counters.data_ptr(), r.data_ptr(), c.data_ptr(), w.data_ptr(),
            d, wr, wc, r.shape[1], int(row_offset), stream,
        )
    build.check(status, "ingest_scatter")
    ingest_scatter.launches += 1
    return counters


ingest_scatter.launches = 0
