"""Wrapper of the CUDA flow reductions (``csrc/flow.cu``), the port of
``src/repro/kernels/flow/kernel.py::flows_pallas``, and the point-flow
queries of ``src/repro/kernels/flow/ops.py`` built on it.

These compute the flows from the counters; a session serves flow queries
from its maintained registers instead (``core/queries.py``), which must
give the same answers.  ``flows.launches`` counts the kernel launches."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flow.ref import flows_ref

_C = ctypes.c_int64
_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, _P, _C, _C, _C, _P]


def _flows_cost(counters):
    """Every counter read once (a reduction's input elements); both sums
    written once."""
    d, wr, wc = counters.shape
    return counters.numel(), 4 * counters.numel() + 4 * d * (wr + wc)


@build.costed(_flows_cost)
def flows(counters: torch.Tensor):
    """(d, wr, wc) float32 counters -> (row sums (d, wr), column sums
    (d, wc)) in one pass.  CPU tensors take the plain version."""
    if counters.device.type == "cpu":
        return flows_ref(counters)
    if counters.device.type != "cuda":
        raise ValueError(f"flows runs on CUDA or CPU, got {counters.device}")
    if counters.dtype != torch.float32 or counters.dim() != 3 or not counters.is_contiguous():
        raise ValueError("counters must be a contiguous (d, wr, wc) float32 tensor")
    d, wr, wc = counters.shape
    row_sums = torch.empty((d, wr), dtype=torch.float32, device=counters.device)
    col_sums = torch.zeros((d, wc), dtype=torch.float32, device=counters.device)
    with torch.cuda.device(counters.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = build.function("flow", "glava_flows", _ARGTYPES)(
            counters.data_ptr(), row_sums.data_ptr(), col_sums.data_ptr(), d, wr, wc, stream,
        )
    build.check(status, "flows")
    flows.launches += 1
    return row_sums, col_sums


flows.launches = 0


def node_in_flow(sketch, keys: torch.Tensor) -> torch.Tensor:
    """f̃_v(a, ←) = min_i colsum(M_i[:, h_i(a)]) from the column sums."""
    _, col_sums = flows(sketch.counters)
    return torch.gather(col_sums, 1, sketch.col_hash(keys)).amin(dim=0)


def node_out_flow(sketch, keys: torch.Tensor) -> torch.Tensor:
    """f̃_v(a, →) = min_i rowsum(M_i[h_i(a), :]) from the row sums."""
    row_sums, _ = flows(sketch.counters)
    return torch.gather(row_sums, 1, sketch.row_hash(keys)).amin(dim=0)
