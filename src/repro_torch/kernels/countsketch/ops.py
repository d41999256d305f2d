"""Wrappers of the CUDA CountSketch and its median decode
(``csrc/countsketch.cu``): :func:`countsketch_family`, the reference's
``src/repro/kernels/countsketch/ops.py::countsketch(vec, hash_family)``
(the hash and ``kernel.py::countsketch_pallas`` in one kernel);
:func:`countsketch`, the Pallas kernel's own interface on buckets and signs
hashed before; and :func:`countsketch_median`, the gather and ``jnp.median``
of ``src/repro/train/compression.py::_unsketch``.  The hashed forms take the
family's coefficients in the launch record and build no (d, n) tensor.

The launch path is ``kernels/query/ops.py``'s: the checks build no tensors,
the C function is bound at its first launch and takes one packed record,
the stream is the raw handle of the device's current stream, and the device
guard is entered only for a tensor off the current device.  CPU tensors
take the plain versions (``ref.py``).  :func:`hash_indices` hashes the
coordinates ``0..n-1`` into the narrow types the pre-hashed kernel reads
(int32 buckets, int8 signs); the CPU round trip shares one such hash
between its two sketches and its decode.

The sketch sums in 64-bit fixed point, each cell at its own scale
(``csrc/countsketch.cu``), so its table does not depend on the order of the
atomics: one vector always sketches to the same bits, on any worker.  It
takes a scratch buffer of :func:`scratch_bytes` from the caching
allocator.

The decode takes one of four kernels by the table's shape
(:func:`median_variant`): one CTA holding the whole table in shared memory, a
pair of CTAs (a thread-block cluster) holding it between them, the staged
kernel for a wider table, the runtime-depth kernel past 8 rows.

``countsketch.launches`` counts the sketch's launches (pre-hashed and
hashed; each is a memset and the cell-max, sum and finalize kernels on one
stream), ``countsketch_median.launches`` the decode's."""
from __future__ import annotations

import ctypes
import operator
import struct
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.hashing import HashFamily
from repro_torch.kernels import build
from repro_torch.kernels.countsketch.ref import countsketch_median_ref, countsketch_ref

# csrc/countsketch.cu's Record: in, out, h, s, a_dev, b_dev and scratch
# pointers; n, depth, width and the sign size in bytes; the stream.  The
# hashed forms append depth x (a, b) as int64.
_RECORD = struct.Struct("=7Q4qQ")
_SIGN_BYTES = {torch.int8: 1, torch.int32: 4}
# Coordinates hashed per pass: bounds the int64 temporaries of the hash at
# a few hundred MB whatever the length of the vector.
HASH_CHUNK = 1 << 23


def scratch_bytes(d: int, width: int) -> int:
    """The sketch's scratch: the int64 sums, uint32 maxima and uint32 flags
    of the d x width cells (``csrc/countsketch.cu::scratch_bytes``)."""
    return 16 * d * width


def _scratch(vec: torch.Tensor, d: int, width: int) -> torch.Tensor:
    return torch.empty(scratch_bytes(d, width), dtype=torch.uint8, device=vec.device)


def _family_rows(family: HashFamily) -> bytes:
    """The family's (a, b) pairs as int64, row by row (the record's tail)."""
    return np.stack([family.a_host, family.b_host], axis=1).astype(np.int64).tobytes()


def _check_vec(vec: torch.Tensor) -> int:
    """The device index of a (n,) float32 vector (-1 on the CPU)."""
    if vec.dtype is not torch.float32 or vec.dim() != 1:
        raise ValueError(f"vec must be a (n,) float32 tensor, got {tuple(vec.shape)} {vec.dtype}")
    return _device_of(vec)


def _device_of(t: torch.Tensor) -> int:
    dev = t.get_device()
    if dev < 0 and not t.is_cpu:
        raise ValueError(f"the countsketch kernels run on CUDA or CPU, got {t.device}")
    return dev


def _check_family(family: HashFamily, dev: int) -> None:
    if family.a.get_device() != dev:
        raise ValueError(f"the hash family lies on {family.device}, the operands on device {dev}")


def _prehashed_cost(vec, h, s, width):
    """d adds an element; each value, its d buckets and d signs read once,
    the float32 table written once."""
    n, d = vec.numel(), h.shape[0]
    return d * n, n * (4 + d * (h.element_size() + s.element_size())) + 4 * d * int(width)


def _family_cost(vec, family):
    """d adds an element (the hashes computed, not read): 4n + 4dw bytes."""
    n, d, w = vec.numel(), family.depth, family.w
    return d * n, 4 * n + 4 * d * w


def _median_cost(table, family, n):
    """d gathers a coordinate: 4n + 4dw bytes."""
    d, w = family.depth, family.w
    return d * int(n), 4 * int(n) + 4 * d * w


@build.costed(_prehashed_cost)
def countsketch(vec: torch.Tensor, h: torch.Tensor, s: torch.Tensor, width: int) -> torch.Tensor:
    """vec (n,) float32; h (d, n) integer buckets in [0, width); s (d, n) ±1
    (int8 or int32) -> (d, width) float32 table.  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    width = operator.index(width)
    dev = _check_vec(vec)
    n = vec.shape[0]
    if h.dim() != 2 or h.shape[1] != n or s.shape != h.shape:
        raise ValueError(f"h and s must be (d, n={n}), got {tuple(h.shape)}, {tuple(s.shape)}")
    sign_bytes = _SIGN_BYTES.get(s.dtype)
    if h.dtype.is_floating_point or h.dtype is torch.bool or sign_bytes is None:
        raise ValueError(f"h must be integer and s int8 or int32, got {h.dtype}, {s.dtype}")
    if width < 1:
        raise ValueError(f"width must be positive, got {width}")
    if h.get_device() != dev or s.get_device() != dev:
        raise ValueError(f"all operands must be on {vec.device}, got {h.device}, {s.device}")
    if dev < 0:
        return countsketch_ref(vec, h, s, width)
    d = h.shape[0]
    v = vec.contiguous()
    hi = h.to(torch.int32).contiguous()
    si = s.contiguous()
    table = vec.new_empty(d, width)
    scratch = _scratch(vec, d, width)
    record = _RECORD.pack(
        v.data_ptr(), table.data_ptr(), hi.data_ptr(), si.data_ptr(), 0, 0, scratch.data_ptr(),
        n, d, width, sign_bytes, torch._C._cuda_getCurrentRawStream(dev),
    )
    build.launch("countsketch", "glava_countsketch", dev, record)
    countsketch.launches += 1
    return table


countsketch.launches = 0


@build.costed(_family_cost)
def countsketch_family(vec: torch.Tensor, family: HashFamily) -> torch.Tensor:
    """Compress a flat (n,) float32 vector with a HashFamily -> (d, family.w)
    float32 table; on the card the kernel hashes the coordinates itself.
    Equals ``repro_torch.train.compression._sketch`` (tested)."""
    dev = _check_vec(vec)
    _check_family(family, dev)
    n, d, w = vec.shape[0], family.depth, family.w
    if dev < 0:
        return countsketch_ref(vec, *hash_indices(family, n), w)
    v = vec if vec.is_contiguous() else vec.contiguous()
    table = vec.new_empty(d, w)
    scratch = _scratch(vec, d, w)
    record = _RECORD.pack(
        v.data_ptr(), table.data_ptr(), 0, 0, family.a.data_ptr(), family.b.data_ptr(), scratch.data_ptr(),
        n, d, w, 0, torch._C._cuda_getCurrentRawStream(dev),
    )
    build.launch("countsketch", "glava_countsketch", dev, record + _family_rows(family))
    countsketch.launches += 1
    return table


@build.costed(_median_cost)
def countsketch_median(table: torch.Tensor, family: HashFamily, n: int) -> torch.Tensor:
    """The median decode of a (d, w) float32 CountSketch ``table`` under
    ``family`` for the coordinates ``0..n-1`` -> (n,) float32
    ``median_i(s_i(j) * table[i, h_i(j)])`` by ``jnp.median``'s rule (NaN
    wherever a value is NaN, the midpoint of the two middle values).  CPU
    tensors take the plain version."""
    n = operator.index(n)
    if table.dtype is not torch.float32 or table.dim() != 2:
        raise ValueError(f"table must be a (d, w) float32 tensor, got {tuple(table.shape)} {table.dtype}")
    d, w = family.depth, family.w
    if tuple(table.shape) != (d, w):
        raise ValueError(f"table must be (d={d}, w={w}) for this family, got {tuple(table.shape)}")
    if n < 0:
        raise ValueError(f"n must be non-negative, got {n}")
    dev = _device_of(table)
    _check_family(family, dev)
    if dev < 0:
        return countsketch_median_ref(table, family, n)
    t = table if table.is_contiguous() else table.contiguous()
    est = table.new_empty(n)
    record = _RECORD.pack(
        t.data_ptr(), est.data_ptr(), 0, 0, family.a.data_ptr(), family.b.data_ptr(), 0,
        n, d, w, 0, torch._C._cuda_getCurrentRawStream(dev),
    )
    build.launch("countsketch", "glava_countsketch_median", dev, record + _family_rows(family))
    countsketch_median.launches += 1
    return est


countsketch_median.launches = 0


# csrc/countsketch.cu::median_plan's codes.
_VARIANTS = {1: "one CTA", 2: "CTA pair", 0: "staged", -1: "runtime depth"}


def median_variant(depth: int, width: int) -> str:
    """The decode kernel a (depth, width) table takes on the current CUDA
    device (``csrc/countsketch.cu::median_plan``): ``"one CTA"`` (the whole
    table in one CTA's shared memory), ``"CTA pair"`` (a cluster of two CTAs
    holding it between them), ``"staged"`` (a wider table: the prefix that
    fits staged, the rest through L2) or ``"runtime depth"`` (more than 8
    rows)."""
    plan = build.function("countsketch", "glava_countsketch_median_plan", [ctypes.c_int64, ctypes.c_int64])
    return _VARIANTS[plan(operator.index(depth), operator.index(width))]


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
