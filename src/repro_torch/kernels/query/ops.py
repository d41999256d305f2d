"""Wrappers of the CUDA edge-query kernels (``csrc/query.cu``): the fused
multi-query :func:`edge_query_min`, the port of
``src/repro/kernels/query/kernel.py::multi_query_pallas``, and the
per-sketch gather :func:`edge_query_cells`, the port of ``query_pallas``.

The launch path is kept short, because at the serve workload's Q=1,024 a
kernel runs for about 2 µs and the host's work per call sets the pace: one
Python helper does the checks (they build no tensors and no ``torch.device``
objects), allocates the output and launches; int32 and int64 buckets go to
the kernel as they come (each has its own instantiation; any other dtype
raises, nothing is cast); the C function is bound at its first launch and
takes one packed launch record, so ctypes converts one argument, not ten;
the stream is the raw handle of the device's current stream; and the device
guard is entered only for a tensor off the current device (never checked
in a process that sees one device).

``edge_query_min.launches`` and ``edge_query_cells.launches`` count the
kernel launches."""
from __future__ import annotations

import struct

import torch

from repro_torch.kernels import build
from repro_torch.kernels.query.ref import edge_query_cells_ref, edge_query_min_ref

# csrc/query.cu's Record: counters, rows, cols and out pointers; d, wr, wc,
# Q and the index size in bytes; the stream.
_RECORD = struct.Struct("=4Q5qQ")
# The index dtypes the kernels take, with their size in bytes.
_INDEX_BYTES = {torch.int32: 4, torch.int64: 8}


def _gather(symbol: str, counters: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor, fused_min: bool):
    """Check the operands (the same on either device); on the card launch
    ``symbol`` into a new output and return it; on the CPU return None."""
    cshape = counters.shape
    if counters.dtype is not torch.float32 or len(cshape) != 3 or not counters.is_contiguous():
        raise ValueError("counters must be a contiguous (d, wr, wc) float32 tensor")
    shape = rows.shape
    if shape != cols.shape or len(shape) != 2 or shape[0] != cshape[0]:
        raise ValueError(f"rows/cols must be (d={cshape[0]}, Q), got {tuple(shape)}, {tuple(cols.shape)}")
    index_dtype = rows.dtype
    index_bytes = _INDEX_BYTES.get(index_dtype)
    if index_bytes is None or cols.dtype is not index_dtype:
        raise ValueError(f"rows/cols must both be int32 or both int64, got {index_dtype}, {cols.dtype}")
    dev = counters.get_device()
    if rows.get_device() != dev or cols.get_device() != dev:
        raise ValueError(f"all operands must be on {counters.device}, got {rows.device}, {cols.device}")
    if dev < 0:
        if not (counters.is_cpu and rows.is_cpu and cols.is_cpu):
            raise ValueError(f"the edge-query kernels run on CUDA or CPU, got {counters.device}, {rows.device}")
        return None
    if not rows.is_contiguous():
        rows = rows.contiguous()
    if not cols.is_contiguous():
        cols = cols.contiguous()
    d, q = shape
    # float32 on the counters' device, sized by ints: a torch.Size argument
    # costs the allocation 2–4 µs more (chip_smoke.py's host breakdown).
    out = counters.new_empty(q) if fused_min else counters.new_empty(d, q)
    record = _RECORD.pack(
        counters.data_ptr(), rows.data_ptr(), cols.data_ptr(), out.data_ptr(),
        d, cshape[1], cshape[2], q, index_bytes, torch._C._cuda_getCurrentRawStream(dev),
    )
    build.launch("query", symbol, dev, record)
    return out


def _gather_cost(out_per_query: bool):
    def cost(counters, rows, cols):
        """A gather a (sketch, query): a 32-byte sector and its two indices
        read; the output written once."""
        d, q = rows.shape[0], rows.shape[-1]
        return d * q, d * q * (32 + 2 * rows.element_size()) + 4 * q * (1 if out_per_query else d)

    return cost


@build.costed(_gather_cost(True))
def edge_query_min(counters: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """(d, wr, wc) float32 counters + (d, Q) in-range int32 or int64 buckets
    -> (Q,) float32 ``min_i counters[i, rows[i,q], cols[i,q]]``.  CPU tensors
    take the plain version."""
    out = _gather("glava_multi_query_min", counters, rows, cols, True)
    if out is None:
        return edge_query_min_ref(counters, rows, cols)
    edge_query_min.launches += 1
    return out


edge_query_min.launches = 0


@build.costed(_gather_cost(False))
def edge_query_cells(counters: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """(d, wr, wc) float32 counters + (d, Q) in-range int32 or int64 buckets
    -> (d, Q) float32 per-sketch cell values ``counters[i, rows[i,q],
    cols[i,q]]`` (no min).  CPU tensors take the plain version."""
    out = _gather("glava_query_cells", counters, rows, cols, False)
    if out is None:
        return edge_query_cells_ref(counters, rows, cols)
    edge_query_cells.launches += 1
    return out


edge_query_cells.launches = 0


def edge_query(sketch, src_keys: torch.Tensor, dst_keys: torch.Tensor) -> torch.Tensor:
    """Full f̃_e path on the fused kernel: hash (int64 buckets, handed to the
    kernel as they are), then gather+min in one pass."""
    r, c = sketch.hash_edges(src_keys, dst_keys)
    return edge_query_min(sketch.counters, r, c)
