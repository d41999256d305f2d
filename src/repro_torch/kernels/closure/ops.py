"""Wrapper of the CUDA closure squaring step (``csrc/closure.cu``), the port
of ``src/repro/kernels/closure/kernel.py::closure_step_pallas``, and the
full-closure loop of ``src/repro/kernels/closure/ops.py``.

``closure_step.launches`` counts the kernel launches."""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.closure.ref import closure_step_ref

TILE = 128  # the kernel's output tile; w is padded to a multiple of it

_C = ctypes.c_int64
_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, _C, _C, _P]


def closure_step(a: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One step ``a OR (a @ a > 0)`` over (n, w, w) float32 0/1 matrices,
    w % TILE == 0, written into ``out`` (a separate buffer, allocated when
    not given).  CPU tensors take the plain version."""
    if a.device.type == "cpu":
        res = closure_step_ref(a)
        return res if out is None else out.copy_(res)
    if a.device.type != "cuda":
        raise ValueError(f"closure_step runs on CUDA or CPU, got {a.device}")
    if a.dtype != torch.float32 or a.dim() != 3 or not a.is_contiguous():
        raise ValueError("a must be a contiguous (n, w, w) float32 tensor")
    n, w, w2 = a.shape
    if w != w2 or w % TILE:
        raise ValueError(f"a must be square with w % {TILE} == 0, got {tuple(a.shape)}")
    if out is None:
        out = torch.empty_like(a)
    elif (
        out.shape != a.shape or out.dtype != a.dtype or out.device != a.device
        or not out.is_contiguous() or out.data_ptr() == a.data_ptr()
    ):
        raise ValueError("out must be a separate contiguous buffer shaped like a")
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        launch = build.function("closure", "glava_closure_step", _ARGTYPES)
        status = launch(a.data_ptr(), out.data_ptr(), n, w, stream)
    build.check(status, "closure_step")
    closure_step.launches += 1
    return out


closure_step.launches = 0


def closure_steps(w: int) -> int:
    """Squarings that saturate any path of a w-node graph: ceil(log2 w)."""
    return max(1, math.ceil(math.log2(max(2, w))))


def transitive_closure(adj: torch.Tensor, include_self: bool = True) -> torch.Tensor:
    """(..., w, w) weighted adjacency -> bool closure, by ``ceil(log2 w)``
    fixed squaring steps of :func:`closure_step`, batched over the leading
    dims (the d sketches) and ping-ponging between two buffers."""
    w = adj.shape[-1]
    lead = adj.shape[:-2]
    a = (adj > 0).to(torch.float32)
    if include_self:
        a.diagonal(dim1=-2, dim2=-1).fill_(1.0)
    pad = (-w) % TILE
    if pad:
        a = F.pad(a, (0, pad, 0, pad))
    wp = w + pad
    a = a.reshape(-1, wp, wp).contiguous()
    b = torch.empty_like(a)
    for _ in range(closure_steps(w)):
        closure_step(a, out=b)
        a, b = b, a
    return a.reshape(*lead, wp, wp)[..., :w, :w] > 0
