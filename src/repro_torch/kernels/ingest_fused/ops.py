"""Wrapper of the CUDA one-pass fused ingest (``csrc/ingest_fused.cu``), the
port of ``src/repro/kernels/ingest_fused/kernel.py::fused_ingest_pallas``.

Unlike the reference's ``ops.py`` there is no width cap: the reference fell
back to its plain twin above a padded width of 2,048 because the TPU kernel's
stripe had to fit in VMEM; the CUDA kernel keeps nothing on chip, so a CUDA
tensor launches it at every width.

``fused_ingest.launches`` counts the kernel launches."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ingest_fused.ref import fused_ingest_ref

_C = ctypes.c_int64
_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P, _C, _C, _C, _C, _P]


def _check_state(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} must be on {device}, got {t.device}")
    if t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {shape} float32 tensor")


def fused_ingest(
    counters: torch.Tensor,    # (d, wr, wc) float32, contiguous, updated in place
    row_flows: torch.Tensor,   # (d, wr) float32, contiguous, updated in place
    col_flows: torch.Tensor,   # (d, wc) float32, contiguous, updated in place
    rows: torch.Tensor,        # (d, B) int — row buckets, -1 inert
    cols: torch.Tensor,        # (d, B) int — column buckets in [0, wc)
    weights: torch.Tensor,     # (B,) float
):
    """Fold one hashed batch into the counters and both flow registers in
    place and mark its rows; returns ``(counters, row_flows, col_flows,
    touched)`` with touched a new (d, wr) bool tensor.  CPU tensors take
    the plain version."""
    if counters.device.type == "cpu":
        return fused_ingest_ref(counters, row_flows, col_flows, rows, cols, weights)
    if counters.device.type != "cuda":
        raise ValueError(f"fused_ingest runs on CUDA or CPU, got {counters.device}")
    if counters.dim() != 3:
        raise ValueError("counters must be a (d, wr, wc) tensor")
    d, wr, wc = counters.shape
    _check_state("counters", counters, (d, wr, wc), counters.device)
    _check_state("row_flows", row_flows, (d, wr), counters.device)
    _check_state("col_flows", col_flows, (d, wc), counters.device)
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
    touched = torch.zeros((d, wr), dtype=torch.uint8, device=counters.device)
    with torch.cuda.device(counters.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = build.function("ingest_fused", "glava_fused_ingest", _ARGTYPES)(
            counters.data_ptr(), row_flows.data_ptr(), col_flows.data_ptr(),
            touched.data_ptr(), r.data_ptr(), c.data_ptr(), w.data_ptr(),
            d, wr, wc, r.shape[1], stream,
        )
    build.check(status, "fused_ingest")
    fused_ingest.launches += 1
    return counters, row_flows, col_flows, touched.view(torch.bool)


fused_ingest.launches = 0
