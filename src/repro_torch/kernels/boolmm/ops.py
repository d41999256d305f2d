"""Wrapper of the boolean product on the 8-bit tensor cores, a port-only
kernel, and the incremental closure refresh built on it.  The product is the
kernel ``bool_product_wgmma_kernel`` of ``csrc/closure.cu``: B3's device body
(``kernels/closure``) under its own name, beside ``byte_transpose_kernel``.

:func:`bool_product` computes ``c0 OR (a @ b > 0)`` over n stacked 0/1 byte
matrices, with b given as ``b_t``, each matrix transposed (8-bit ``wgmma``
reads both operands K-major), and writes the result's transpose too when
asked.  The kernel takes M, N and K in multiples of :data:`TILE`; the
wrapper pads other shapes with zeros.  CPU tensors take the plain version.

:func:`closure_refresh` is ``core/reach.py::closure_refresh`` on bytes: each
of its products is one :func:`bool_product`, the closure is transposed once,
and no matrix is cast to float.

:func:`byte_transpose` transposes byte matrices on the card.
``bool_product.launches`` and ``byte_transpose.launches`` count the kernels'
launches."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.boolmm.ref import bool_product_ref
from repro_torch.kernels.closure.ops import check_bytes, closure_steps

TILE = 128  # the kernel's tile along M, N and K

_C = ctypes.c_int64
_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, _P, _P, _P, _C, _C, _C, _C, _P]
_TRANSPOSE_ARGTYPES = [_P, _P, _C, _C, _C, _P]


def _transpose_cost(a):
    """No operations; a read, its transpose written, a byte an entry."""
    return 0, 2 * a.numel()


@build.costed(_transpose_cost)
def byte_transpose(a: torch.Tensor) -> torch.Tensor:
    """(n, R, C) uint8 -> (n, C, R), each matrix transposed, in a new tensor:
    the kernel's byte transpose for a contiguous CUDA tensor with R and C
    multiples of :data:`TILE`, else a strided copy."""
    n, r, c = a.shape
    if a.device.type != "cuda" or r % TILE or c % TILE or not a.is_contiguous() or a.data_ptr() % 16:
        return a.transpose(-1, -2).contiguous()
    out = torch.empty((n, c, r), dtype=torch.uint8, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        launch = build.function("closure", "glava_byte_transpose", _TRANSPOSE_ARGTYPES)
        status = launch(a.data_ptr(), out.data_ptr(), n, r, c, stream)
    build.check(status, "byte_transpose")
    byte_transpose.launches += 1
    return out


byte_transpose.launches = 0


def _up(x: int) -> int:
    return max(TILE, -(-x // TILE) * TILE)


def _launch(a, b_t, c0, out, out_t) -> None:
    n, m, k = a.shape
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        launch = build.function("closure", "glava_bool_product", _ARGTYPES)
        status = launch(a.data_ptr(), b_t.data_ptr(), None if c0 is None else c0.data_ptr(), out.data_ptr(),
                        None if out_t is None else out_t.data_ptr(), n, m, b_t.shape[1], k, stream)
    build.check(status, "bool_product")
    bool_product.launches += 1


def _cost(a, b_t, c0=None, out=None, out_t=None):
    """2·n·M·N·K operations; a, b_t and c0 read, out and out_t written, a
    byte an entry."""
    n, m, k = a.shape
    nc = b_t.shape[1]
    written = 1 + (c0 is not None) + (out_t is not None)
    return 2 * n * m * nc * k, n * (m * k + nc * k + written * m * nc)


@build.costed(_cost)
def bool_product(
    a: torch.Tensor,
    b_t: torch.Tensor,
    c0: Optional[torch.Tensor] = None,
    out: Optional[torch.Tensor] = None,
    out_t: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``c0 OR (a @ b > 0)`` for a (n, M, K) and b given as ``b_t`` (n, N,
    K), uint8 in {0, 1}, and c0 (n, M, N) or None.  Returns ``out`` (n, M,
    N), written into the given buffer or a new one, and writes its transpose
    into ``out_t`` (n, N, M) if given.  ``out`` and ``out_t`` are separate
    from the inputs and each other."""
    if a.dim() != 3 or b_t.dim() != 3 or a.shape[0] != b_t.shape[0] or a.shape[2] != b_t.shape[2]:
        raise ValueError(f"a (n, M, K) and b_t (n, N, K) do not match: {tuple(a.shape)}, {tuple(b_t.shape)}")
    n, m, k = a.shape
    nc = b_t.shape[1]
    dev = a.device
    check_bytes(a, a.shape, "a", dev)
    check_bytes(b_t, b_t.shape, "b_t", dev)
    for t, shape, name in ((c0, (n, m, nc), "c0"), (out, (n, m, nc), "out"), (out_t, (n, nc, m), "out_t")):
        if t is not None:
            check_bytes(t, shape, name, dev)
    outs = [t.data_ptr() for t in (out, out_t) if t is not None]
    if len(set(outs)) != len(outs) or set(outs) & {t.data_ptr() for t in (a, b_t, c0) if t is not None}:
        raise ValueError("out and out_t must be separate from the inputs and each other")
    if dev.type == "cpu":
        res = bool_product_ref(a, b_t, c0)
        if out_t is not None:
            out_t.copy_(res.transpose(1, 2))
        return res if out is None else out.copy_(res)
    if dev.type != "cuda":
        raise ValueError(f"bool_product runs on CUDA or CPU, got {dev}")
    out = torch.empty((n, m, nc), dtype=torch.uint8, device=dev) if out is None else out
    mp, ncp, kp = _up(m), _up(nc), _up(k)
    if (mp, ncp, kp) == (m, nc, k):
        _launch(a, b_t, c0, out, out_t)
        return out
    # Zero rows and columns add no path: pad to the tile, slice back.
    def pad(t, rows, cols):
        return F.pad(t, (0, cols - t.shape[2], 0, rows - t.shape[1]))

    res = torch.empty((n, mp, ncp), dtype=torch.uint8, device=dev)
    res_t = None if out_t is None else torch.empty((n, ncp, mp), dtype=torch.uint8, device=dev)
    _launch(pad(a, mp, kp), pad(b_t, ncp, kp), None if c0 is None else pad(c0, mp, ncp), res, res_t)
    if out_t is not None:
        out_t.copy_(res_t[:, :nc, :m])
    return out.copy_(res[:, :m, :nc])


bool_product.launches = 0


def pad_rows(rows: torch.Tensor) -> torch.Tensor:
    """Touched-row plans (..., T) of at least :data:`TILE` rows padded with
    row 0 to a multiple of it, so that the refresh's products, its
    squarings above all, take T whole on the card (exact: an untouched row
    restates paths the closure holds; under a tile more, less than T).  A
    shorter plan stays as it is: :func:`bool_product` pads its small
    operands."""
    t = rows.shape[-1]
    return F.pad(rows, (0, (-t) % TILE)) if t >= TILE and t % TILE else rows


def closure_refresh(closure: torch.Tensor, delta: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``core/reach.py::closure_refresh`` on bytes: the (n, w, w) bool
    ``closure`` refreshed from ``delta`` (n, T, w), the touched rows ``rows``
    (n, T) of the new adjacency as bools (``> 0``).  With B the closure, the
    new closure is ``B OR G · S* · (Δ·B)``, G being B's columns at the
    touched rows and S* the closure of the touched-row hop graph; every
    product is one :func:`bool_product` (3 + ``closure_steps(T)`` launches on
    the card) and the result is a new tensor.  No host sync."""
    n, w, _ = closure.shape
    t = rows.shape[1]
    u8 = dict(dtype=torch.uint8, device=closure.device)
    b = closure.contiguous().view(torch.uint8)
    b_t = byte_transpose(b)
    # U = Δ·B: one touched-row departure, then any old path; and U^T.
    u_t = torch.empty((n, w, t), **u8)
    bool_product(delta.contiguous().view(torch.uint8), b_t, out_t=u_t)
    # S, touched row to touched row (U at the touched columns: U^T's rows),
    # with the identity, and its closure S* by squarings S OR S·S.
    s_t = u_t[torch.arange(n, device=closure.device)[:, None], rows]
    s = byte_transpose(s_t)
    s.diagonal(dim1=1, dim2=2).fill_(1)
    s_t.diagonal(dim1=1, dim2=2).fill_(1)
    nxt, nxt_t = torch.empty_like(s), torch.empty_like(s)
    for _ in range(closure_steps(t)):
        bool_product(s, s_t, c0=s, out=nxt, out_t=nxt_t)
        s, s_t, nxt, nxt_t = nxt, nxt_t, s, s_t
    # W = S*·U: any number of touched-row departures, ending anywhere; W^T.
    w_t = torch.empty((n, w, t), **u8)
    bool_product(s, u_t, out_t=w_t)
    # An old path into a touched row, then W: B OR G·W.
    g = torch.gather(b, 2, rows[:, None, :].expand(n, w, t))
    return bool_product(g, w_t, c0=b).view(torch.bool)
