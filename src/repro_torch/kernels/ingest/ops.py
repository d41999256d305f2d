"""Wrappers of the CUDA ingest scatter (``csrc/ingest.cu``), the port of
``src/repro/kernels/ingest/kernel.py::ingest_pallas``: :func:`ingest_scatter`
on (d, B) buckets hashed before (the Pallas kernel's interface) and
:func:`ingest_keys` on the (B,) keys, which the kernel hashes itself (the
serve path's pre-aggregated batches); and the launch path they share with
the fused ingest (``kernels/ingest_fused/ops.py``) and the fleet's stacked
ingest (``kernels/ingest_stacked/ops.py``).

The launch path is ``kernels/query/ops.py``'s: one helper checks the
operands the same way on either device (it builds no tensors and no
``torch.device`` objects); int32 and int64 buckets go to the kernel as they
come (each has its own instantiation; any other dtype, and rows and columns
of different dtypes, raise, nothing is cast); weights are float32 (both
callers, ``core/ingest.py::ingest`` and ``GLavaSketch.update_fused_``,
convert before they call); both kernels read one packed launch record
(:data:`RECORD`), launched by ``kernels/build.py::launch``; the stream is
the raw handle of the device's current stream.  The key entry takes int64
keys holding uint32 values (as ``core/hashing.py::keys_to_tensor`` gives
them), float32 weights and the two families, whose coefficients ride in its
own record (:data:`KEY_RECORD`); it builds no (d, B) tensor.

``ingest_scatter.launches`` and ``ingest_keys.launches`` count each entry's
kernel launches."""
from __future__ import annotations

import functools
import struct

import numpy as np
import torch

from repro_torch.core.hashing import HashFamily
from repro_torch.kernels import build
from repro_torch.kernels.ingest.ref import ingest_keys_ref, ingest_scatter_ref

# csrc/ingest.cu's and csrc/ingest_fused.cu's Record: the counters, row_flows,
# col_flows, touched, rows, cols and weights pointers; d, wr, wc, B, the row
# offset, the index size in bytes and the flags; the stream.
RECORD = struct.Struct("=7Q7qQ")
# csrc/ingest.cu's KeyRecord: the counters, src, dst and weights pointers and
# the row and column families' (d,) a and b on the device; d, wr, wc, B, the
# row offset, the row family's width and the mirror flag; the stream.  Then
# d x (row a, row b, column a, column b) as int64.
KEY_RECORD = struct.Struct("=8Q7qQ")
# The index dtypes the kernels take, with their size in bytes.
INDEX_BYTES = {torch.int32: 4, torch.int64: 8}
# Declared bytes of one add (kernels/build.py::costed): a 32-byte sector of
# counters read and written.
ADD_BYTES = 64


def _scatter_cost(counters, rows, cols, weights, row_offset=0):
    """An add a (sketch, slot); the indices and weights read once."""
    adds = rows.numel()
    return adds, adds * (ADD_BYTES + 2 * rows.element_size()) + 4 * weights.numel()


def _keys_cost(counters, src, dst, weights, row_hash, col_hash, row_offset=0, mirror=False):
    """d adds a slot (2d mirrored); two int64 keys and a weight read a slot."""
    adds = counters.shape[0] * src.numel() * (2 if mirror else 1)
    return adds, adds * ADD_BYTES + 20 * src.numel()


def _check_counters(counters: torch.Tensor, stacked: bool = False) -> None:
    if counters.dtype is not torch.float32 or counters.dim() != 3 + stacked or not counters.is_contiguous():
        raise ValueError(f"counters must be a contiguous {'(N, d, wr, wc)' if stacked else '(d, wr, wc)'} "
                         f"float32 tensor")


def _device(what: str, counters: torch.Tensor, *operands: torch.Tensor) -> int:
    """The counters' device index (-1 on the CPU); every operand must be on it."""
    dev = counters.get_device()
    if any(t.get_device() != dev for t in operands):
        raise ValueError(f"all operands must be on {counters.device}, got "
                         f"{', '.join(str(t.device) for t in operands)}")
    if dev < 0 and not (counters.is_cpu and all(t.is_cpu for t in operands)):
        raise ValueError(f"{what} runs on CUDA or CPU, got {counters.device}")
    return dev


def check_batch(what: str, counters: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
                weights: torch.Tensor, stacked: bool = False) -> int:
    """Check a hashed batch against its counters, the same on either device;
    return the device index (-1 on the CPU).  ``stacked`` counters carry a
    leading plane axis, (N, d, wr, wc)."""
    _check_counters(counters, stacked)
    depth = counters.shape[int(stacked)]
    shape = rows.shape
    if shape != cols.shape or len(shape) != 2 or shape[0] != depth:
        raise ValueError(f"rows/cols must be (d={depth}, B), got {tuple(shape)}, {tuple(cols.shape)}")
    if rows.dtype not in INDEX_BYTES or cols.dtype is not rows.dtype:
        raise ValueError(f"rows/cols must both be int32 or both int64, got {rows.dtype}, {cols.dtype}")
    if weights.dtype is not torch.float32 or weights.shape != shape[1:]:
        raise ValueError(f"weights must be a (B={shape[1]},) float32 tensor, got {tuple(weights.shape)} {weights.dtype}")
    return _device(what, counters, rows, cols, weights)


def check_keys(counters: torch.Tensor, src: torch.Tensor, dst: torch.Tensor, weights: torch.Tensor,
               row_hash: HashFamily, col_hash: HashFamily) -> int:
    """Check a batch of keys, its weights and the two families against the
    counters, the same on either device; return the device index (-1 on the
    CPU)."""
    _check_counters(counters)
    d, _, wc = counters.shape
    if src.dtype is not torch.int64 or dst.dtype is not torch.int64 or src.dim() != 1 or dst.shape != src.shape:
        raise ValueError(f"src/dst must be (B,) int64 keys, got {tuple(src.shape)} {src.dtype}, "
                         f"{tuple(dst.shape)} {dst.dtype}")
    if weights.dtype is not torch.float32 or weights.shape != src.shape:
        raise ValueError(f"weights must be a (B={src.shape[0]},) float32 tensor, got {tuple(weights.shape)} "
                         f"{weights.dtype}")
    if row_hash.depth != d or col_hash.depth != d or col_hash.w != wc or not 0 < row_hash.w < 1 << 32:
        raise ValueError(f"the families must hash d={d} rows, the columns onto {wc}; got depths "
                         f"{row_hash.depth}, {col_hash.depth} and widths {row_hash.w}, {col_hash.w}")
    return _device("ingest_keys", counters, src, dst, weights, row_hash.a, col_hash.a)


def check_state(name: str, t: torch.Tensor, dtype, shape, dev: int) -> None:
    """Check one state tensor beside the counters (a register, a bitmap)."""
    if t.dtype is not dtype or t.shape != shape or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {tuple(shape)} {dtype} tensor, got {tuple(t.shape)} {t.dtype}")
    if t.get_device() != dev:
        raise ValueError(f"{name} must be on the counters' device, got {t.device}")


@build.costed(_scatter_cost)
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
    build.launch("ingest", "glava_ingest_scatter", dev, scatter_record(counters, rows, cols, weights, row_offset, dev))
    ingest_scatter.launches += 1
    return counters


ingest_scatter.launches = 0


def scatter_record(counters, rows, cols, weights, row_offset: int, dev: int) -> bytes:
    """The bucket entry's packed launch record for checked, contiguous
    operands on CUDA device ``dev``."""
    d, wr, wc = counters.shape
    return RECORD.pack(
        counters.data_ptr(), 0, 0, 0, rows.data_ptr(), cols.data_ptr(), weights.data_ptr(),
        d, wr, wc, rows.shape[1], int(row_offset), INDEX_BYTES[rows.dtype], 0,
        torch._C._cuda_getCurrentRawStream(dev),
    )


@build.costed(_keys_cost)
def ingest_keys(
    counters: torch.Tensor,   # (d, wr_local, wc) float32, contiguous, updated in place
    src: torch.Tensor,        # (B,) int64 holding uint32 keys
    dst: torch.Tensor,        # (B,) int64 holding uint32 keys
    weights: torch.Tensor,    # (B,) float32
    row_hash: HashFamily,     # d hashes onto the GLOBAL rows
    col_hash: HashFamily,     # d hashes onto [0, wc)
    row_offset: int = 0,
    mirror: bool = False,
) -> torch.Tensor:
    """``counters[i, row_hash_i(src[b]) - row_offset, col_hash_i(dst[b])] +=
    weights[b]`` in place, and with ``mirror`` the edge ``(dst[b], src[b])``
    too; returns ``counters``.  On the card the kernel hashes the keys (one
    launch); CPU tensors take the plain version."""
    dev = check_keys(counters, src, dst, weights, row_hash, col_hash)
    if dev < 0:
        return ingest_keys_ref(counters, src, dst, weights, row_hash, col_hash, row_offset, mirror)
    src, dst, weights = (t if t.is_contiguous() else t.contiguous() for t in (src, dst, weights))
    record = key_record(counters, src, dst, weights, row_hash, col_hash, row_offset, mirror, dev)
    build.launch("ingest", "glava_ingest_keys", dev, record)
    ingest_keys.launches += 1
    return counters


ingest_keys.launches = 0


def key_record(counters, src, dst, weights, row_hash: HashFamily, col_hash: HashFamily, row_offset: int,
               mirror: bool, dev: int) -> bytes:
    """The key entry's packed launch record for checked, contiguous operands
    on CUDA device ``dev``, coefficients included."""
    d, wr, wc = counters.shape
    return KEY_RECORD.pack(
        counters.data_ptr(), src.data_ptr(), dst.data_ptr(), weights.data_ptr(), row_hash.a.data_ptr(),
        row_hash.b.data_ptr(), col_hash.a.data_ptr(), col_hash.b.data_ptr(),
        d, wr, wc, src.shape[0], int(row_offset), row_hash.w, int(bool(mirror)),
        torch._C._cuda_getCurrentRawStream(dev),
    ) + _coefficients(row_hash, col_hash)


@functools.lru_cache(maxsize=256)
def _coefficients(row_hash: HashFamily, col_hash: HashFamily) -> bytes:
    """The key record's tail, d x (row a, row b, column a, column b) as int64,
    packed once per pair of families (they are immutable; each hashes by
    identity)."""
    rows = [row_hash.a_host, row_hash.b_host, col_hash.a_host, col_hash.b_host]
    return np.stack(rows, axis=1).astype(np.int64).tobytes()
