"""Wrapper of the CUDA CountSketch (``csrc/countsketch.cu``), the port of
``src/repro/kernels/countsketch/kernel.py::countsketch_pallas``, and of
``src/repro/kernels/countsketch/ops.py::countsketch``.

``countsketch`` takes operands already hashed; :func:`hash_indices` hashes
the coordinates ``0..n-1`` once into the narrow types the kernel reads
(int32 buckets, int8 signs), and :func:`countsketch_family` is the
reference's ``countsketch(vec, hash_family)``.  ``countsketch.launches``
counts the kernel launches."""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.core.hashing import HashFamily
from repro_torch.kernels import build
from repro_torch.kernels.countsketch.ref import countsketch_ref

_C = ctypes.c_int64
_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, _P, _C, _P, _C, _C, _C, _P]
_SIGN_TYPES = (torch.int8, torch.int32)
# Coordinates hashed per pass: bounds the int64 temporaries of the hash at
# a few hundred MB whatever the length of the vector.
HASH_CHUNK = 1 << 23


def countsketch(vec: torch.Tensor, h: torch.Tensor, s: torch.Tensor, width: int) -> torch.Tensor:
    """vec (n,) float32; h (d, n) buckets in [0, width); s (d, n) ±1 (int8 or
    int32) -> (d, width) float32 table.  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if vec.device.type == "cpu":
        return countsketch_ref(vec, h, s, width)
    if vec.device.type != "cuda":
        raise ValueError(f"countsketch runs on CUDA or CPU, got {vec.device}")
    if vec.dtype != torch.float32 or vec.dim() != 1:
        raise ValueError(f"vec must be a (n,) float32 tensor, got {tuple(vec.shape)} {vec.dtype}")
    n = vec.shape[0]
    if h.dim() != 2 or h.shape[1] != n or s.shape != h.shape:
        raise ValueError(f"h and s must be (d, n={n}), got {tuple(h.shape)}, {tuple(s.shape)}")
    if h.dtype.is_floating_point or s.dtype not in _SIGN_TYPES:
        raise ValueError(f"h must be integer and s int8 or int32, got {h.dtype}, {s.dtype}")
    if int(width) < 1:
        raise ValueError(f"width must be positive, got {width}")
    for t in (h, s):
        if t.device != vec.device:
            raise ValueError(f"all operands must be on {vec.device}, got {t.device}")
    d = h.shape[0]
    v = vec.contiguous()
    hi = h.to(torch.int32).contiguous()
    si = s.contiguous()
    table = torch.zeros((d, int(width)), dtype=torch.float32, device=vec.device)
    with torch.cuda.device(vec.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = build.function("countsketch", "glava_countsketch", _ARGTYPES)(
            v.data_ptr(), hi.data_ptr(), si.data_ptr(), si.element_size(), table.data_ptr(),
            d, n, int(width), stream,
        )
    build.check(status, "countsketch")
    countsketch.launches += 1
    return table


countsketch.launches = 0


def hash_indices(family: HashFamily, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Buckets (d, n) int32 and signs (d, n) int8 of the coordinates
    ``0..n-1`` under ``family``, on its device."""
    d, dev = family.depth, family.device
    h = torch.empty((d, n), dtype=torch.int32, device=dev)
    s = torch.empty((d, n), dtype=torch.int8, device=dev)
    for lo in range(0, n, HASH_CHUNK):
        idx = torch.arange(lo, min(n, lo + HASH_CHUNK), dtype=torch.int64, device=dev)
        h[:, lo : lo + idx.shape[0]] = family(idx)
        s[:, lo : lo + idx.shape[0]] = family.signs(idx)
    return h, s


def countsketch_family(vec: torch.Tensor, family: HashFamily) -> torch.Tensor:
    """Compress a flat vector with a HashFamily -> (d, family.w) table.
    Equals ``repro_torch.train.compression._sketch`` (tested)."""
    h, s = hash_indices(family, vec.shape[0])
    return countsketch(vec.to(torch.float32), h, s, family.w)
