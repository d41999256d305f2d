"""Wrappers of the CUDA edge-query kernels (``csrc/query.cu``): the fused
multi-query :func:`edge_query_min`, the port of
``src/repro/kernels/query/kernel.py::multi_query_pallas``, and the
per-sketch gather :func:`edge_query_cells`, the port of ``query_pallas``.

``edge_query_min.launches`` and ``edge_query_cells.launches`` count the
kernel launches."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.query.ref import edge_query_cells_ref, edge_query_min_ref

_C = ctypes.c_int64
_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, _P, _P, _C, _C, _C, _C, _P]


def _check(name: str, counters: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor):
    """Validate the operands of a query kernel; returns int32 (rows, cols)."""
    if counters.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU, got {counters.device}")
    if counters.dtype != torch.float32 or counters.dim() != 3 or not counters.is_contiguous():
        raise ValueError("counters must be a contiguous (d, wr, wc) float32 tensor")
    d = counters.shape[0]
    if rows.shape != cols.shape or rows.dim() != 2 or rows.shape[0] != d:
        raise ValueError(
            f"rows/cols must be (d={d}, Q), got {tuple(rows.shape)}, {tuple(cols.shape)}"
        )
    for t in (rows, cols):
        if t.device != counters.device:
            raise ValueError(f"all operands must be on {counters.device}, got {t.device}")
    return rows.to(torch.int32).contiguous(), cols.to(torch.int32).contiguous()


def _launch(symbol: str, counters, r, c, out) -> None:
    d, wr, wc = counters.shape
    with torch.cuda.device(counters.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = build.function("query", symbol, _ARGTYPES)(
            counters.data_ptr(), r.data_ptr(), c.data_ptr(), out.data_ptr(),
            d, wr, wc, r.shape[1], stream,
        )
    build.check(status, symbol)


def edge_query_min(counters: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """(d, wr, wc) float32 counters + (d, Q) in-range buckets -> (Q,) float32
    ``min_i counters[i, rows[i,q], cols[i,q]]``.  CPU tensors take the plain
    version."""
    if counters.device.type == "cpu":
        return edge_query_min_ref(counters, rows, cols)
    r, c = _check("edge_query_min", counters, rows, cols)
    out = torch.empty(r.shape[1], dtype=torch.float32, device=counters.device)
    _launch("glava_multi_query_min", counters, r, c, out)
    edge_query_min.launches += 1
    return out


edge_query_min.launches = 0


def edge_query_cells(counters: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """(d, wr, wc) float32 counters + (d, Q) in-range buckets -> (d, Q)
    float32 per-sketch cell values ``counters[i, rows[i,q], cols[i,q]]``
    (no min).  CPU tensors take the plain version."""
    if counters.device.type == "cpu":
        return edge_query_cells_ref(counters, rows, cols)
    r, c = _check("edge_query_cells", counters, rows, cols)
    out = torch.empty(r.shape, dtype=torch.float32, device=counters.device)
    _launch("glava_query_cells", counters, r, c, out)
    edge_query_cells.launches += 1
    return out


edge_query_cells.launches = 0


def edge_query(sketch, src_keys: torch.Tensor, dst_keys: torch.Tensor) -> torch.Tensor:
    """Full f̃_e path on the fused kernel: hash, then gather+min in one pass."""
    r, c = sketch.hash_edges(src_keys, dst_keys)
    return edge_query_min(sketch.counters, r, c)
