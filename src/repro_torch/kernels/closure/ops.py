"""Wrapper of the CUDA closure squaring step, the port of
``src/repro/kernels/closure/kernel.py::closure_step_pallas``, and the
full-closure loop of ``src/repro/kernels/closure/ops.py``.  The step is the
kernel ``closure_step_wgmma_kernel`` of ``csrc/closure.cu``, the port's one
source of the 8-bit boolean product: the same device body runs the
refresh's ``bool_product_wgmma_kernel`` (``kernels/boolmm``) under its own
name.

The closure is kept one byte an entry from the first step to the last, with
each matrix's transpose beside it: the kernel's 8-bit tensor-core product
reads its B operand from the transpose's rows.

``closure_step.launches`` counts the kernel launches."""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.closure.ref import closure_step_ref

TILE = 128  # the kernel's output tile height; w is padded to a multiple of it

_C = ctypes.c_int64
_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, _P, _P, _C, _C, _P]


def _transpose(a: torch.Tensor) -> torch.Tensor:
    return a.transpose(-1, -2).contiguous()


def check_bytes(t: torch.Tensor, shape, name: str, device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous, 16-byte aligned uint8 tensor of
    ``shape`` on ``device``: an operand of the kernels of ``csrc/closure.cu``."""
    if (
        tuple(t.shape) != tuple(shape) or t.dtype != torch.uint8 or t.device != device
        or not t.is_contiguous() or t.data_ptr() % 16
    ):
        raise ValueError(f"{name} must be a contiguous, 16-byte aligned {tuple(shape)} uint8 tensor on {device}")


def _step_cost(a, a_t, out=None, out_t=None):
    """2·n·w³ operations (an (n, w, w) product); a and a_t read, out and
    out_t written, a byte an entry."""
    n, w = a.shape[0], a.shape[-1]
    return 2 * n * w ** 3, 4 * n * w * w


@build.costed(_step_cost)
def closure_step(
    a: torch.Tensor,
    a_t: torch.Tensor,
    out: Optional[torch.Tensor] = None,
    out_t: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step ``a OR (a @ a > 0)`` over (n, w, w) uint8 0/1 matrices,
    w % TILE == 0, given ``a_t``, each matrix of ``a`` transposed.  Returns
    ``(out, out_t)``, the step and its transpose, written into the given
    buffers (separate from ``a``, ``a_t`` and each other) or new ones.  CPU
    tensors take the plain version, which does not read ``a_t``."""
    if a.device.type == "cpu":
        res = closure_step_ref(a)
        res_t = _transpose(res)
        if out is not None:
            res = out.copy_(res)
        if out_t is not None:
            res_t = out_t.copy_(res_t)
        return res, res_t
    if a.device.type != "cuda":
        raise ValueError(f"closure_step runs on CUDA or CPU, got {a.device}")
    if a.dim() != 3:
        raise ValueError(f"a must be (n, w, w), got {tuple(a.shape)}")
    check_bytes(a, a.shape, "a", a.device)
    n, w, w2 = a.shape
    if w != w2 or w % TILE:
        raise ValueError(f"a must be square with w % {TILE} == 0, got {tuple(a.shape)}")
    out = torch.empty_like(a) if out is None else out
    out_t = torch.empty_like(a) if out_t is None else out_t
    for t, name in ((a_t, "a_t"), (out, "out"), (out_t, "out_t")):
        check_bytes(t, a.shape, name, a.device)
    if len({t.data_ptr() for t in (a, a_t, out, out_t)}) != 4:
        raise ValueError("a, a_t, out and out_t must be four separate buffers")
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        launch = build.function("closure", "glava_closure_step", _ARGTYPES)
        status = launch(a.data_ptr(), a_t.data_ptr(), out.data_ptr(), out_t.data_ptr(), n, w, stream)
    build.check(status, "closure_step")
    closure_step.launches += 1
    return out, out_t


closure_step.launches = 0


def closure_steps(w: int) -> int:
    """Squarings that saturate any path of a w-node graph: ceil(log2 w)."""
    return max(1, math.ceil(math.log2(max(2, w))))


def _closure_cost(adj, include_self: bool = True):
    """:func:`closure_steps` steps at the matrices' own width (not the
    padded one); the adjacency read once, the bool closure written once."""
    w = adj.shape[-1]
    n = adj.numel() // (w * w)
    steps = closure_steps(w)
    return steps * 2 * n * w ** 3, steps * 4 * n * w * w + adj.numel() * (adj.element_size() + 1)


@build.costed(_closure_cost)
def transitive_closure(adj: torch.Tensor, include_self: bool = True) -> torch.Tensor:
    """(..., w, w) weighted adjacency -> bool closure, by ``ceil(log2 w)``
    fixed squaring steps of :func:`closure_step`, batched over the leading
    dims (the d sketches).  Bytes throughout: two ping-pong pairs of
    (matrix, transpose), and the result is the last matrix viewed as bool."""
    w = adj.shape[-1]
    lead = adj.shape[:-2]
    a = (adj > 0).view(torch.uint8)
    if include_self:
        a.diagonal(dim1=-2, dim2=-1).fill_(1)
    pad = (-w) % TILE
    if pad:
        a = F.pad(a, (0, pad, 0, pad))
    wp = w + pad
    a = a.reshape(-1, wp, wp).contiguous()
    a_t = _transpose(a)
    b, b_t = torch.empty_like(a), torch.empty_like(a)
    for _ in range(closure_steps(w)):
        closure_step(a, a_t, out=b, out_t=b_t)
        a, a_t, b, b_t = b, b_t, a, a_t
    del a_t, b, b_t
    res = a.view(torch.bool).reshape(*lead, wp, wp)
    return res[..., :w, :w].contiguous() if pad else res
