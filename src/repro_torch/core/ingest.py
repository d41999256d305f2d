"""IngestEngine — the ONE dispatch point for sketch ingest.

Port of ``src/repro/core/ingest.py``.  Every path that folds an edge batch
into gLava counters routes through :func:`ingest` / :class:`IngestEngine`,
which owns the scatter semantics and the row-shard masking, so backends
cannot drift apart.  The port updates the counters IN PLACE: that is its
counterpart of the reference's buffer donation, and one ingest batch makes
no copy of the counters.

Exact-equivalence contract
--------------------------
For integer-valued fp32 weights with total per-cell mass below ``2**24``,
every backend — and any row-sharded decomposition of them — produces
BIT-IDENTICAL counters, because fp32 addition of exactly representable
integers is associative in that range and out-of-shard edges contribute
exactly zero (index masking, never weight rounding).  Float weights agree
to rounding (the CUDA kernel adds with atomics, in any order).

Ingest-backend selection
------------------------
``scatter``  The paper-faithful semantics, ``M[h(x), h(y)] += w``, as one
             vectorized ``index_add_`` (the kernel's plain version).
``cuda``     The hand-written CUDA scatter (``repro_torch.kernels.ingest``);
             given CPU tensors its wrapper computes the plain version.
             Batches given as keys (:meth:`IngestEngine.keys`, the serve
             path's pre-aggregated pairs) take its key entry, which hashes
             in the kernel: one launch a batch, mirrored edges included.
``auto``     ``cuda`` for counters on a CUDA device, ``scatter`` on the CPU.
             There is no environment override.

The reference's ``onehot`` backend (an MXU formulation) is not ported.
Sessions collapse batches on the host (:func:`preaggregate_host`);
:func:`preaggregate_edges` is the device-side, static-shape collapse.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.ingest.ops import ingest_keys, ingest_scatter
from repro_torch.kernels.ingest.ref import ingest_keys_ref, ingest_scatter_ref

BACKENDS = ("scatter", "cuda")


def resolve_backend(backend: Optional[str], device: torch.device) -> str:
    """Resolve "auto"/None for counters on ``device`` to a concrete name."""
    if backend in (None, "auto"):
        return "cuda" if torch.device(device).type == "cuda" else "scatter"
    if backend not in BACKENDS:
        raise ValueError(f"unknown ingest backend: {backend!r} (want {BACKENDS})")
    return backend


def touched_row_keys(src, dst=None, cap: Optional[int] = None):
    """The unique uint32 node keys whose ROW buckets one ingest batch can
    touch — ``src`` always; ``dst`` too when the sketch mirrors edges
    (undirected).  Feeds the incremental closure refresh, which only needs
    a SUPERSET of the changed rows.  ``None`` when the unique count exceeds
    ``cap`` (callers then fall back to a full rebuild)."""
    keys = np.atleast_1d(np.asarray(src))
    if dst is not None:
        keys = np.concatenate([keys, np.atleast_1d(np.asarray(dst))])
    uniq = np.unique(keys.astype(np.uint32, copy=False))
    if cap is not None and uniq.size > cap:
        return None
    return uniq


_BACKEND_FNS = {"scatter": ingest_scatter_ref, "cuda": ingest_scatter}
_KEY_FNS = {"scatter": ingest_keys_ref, "cuda": ingest_keys}


def ingest(
    counters: torch.Tensor,   # (d, wr_local, wc) float32 — updated in place
    rows: torch.Tensor,       # (d, B) int — GLOBAL row buckets
    cols: torch.Tensor,       # (d, B) int — column buckets
    weights: torch.Tensor,    # (B,) float32
    *,
    backend: str = "scatter",
    row_offset: int = 0,
) -> torch.Tensor:
    """Fold one hashed edge batch into ``counters`` in place and return it.

    ``row_offset`` is the global row id of this counter shard's row 0; rows
    outside ``[row_offset, row_offset + wr_local)`` contribute nothing."""
    fn = _BACKEND_FNS[resolve_backend(backend, counters.device)]
    return fn(counters, rows, cols, weights.to(torch.float32), row_offset)


@dataclasses.dataclass(frozen=True)
class IngestEngine:
    """A backend name with the :func:`ingest` dispatch bound; "auto"
    resolves per call from the counters' device."""

    backend: str = "auto"

    def __post_init__(self):
        if self.backend not in (None, "auto", *BACKENDS):
            raise ValueError(f"unknown ingest backend: {self.backend!r} (want {BACKENDS})")

    def __call__(self, counters, rows, cols, weights, row_offset=0):
        return ingest(
            counters, rows, cols, weights, backend=self.backend, row_offset=row_offset
        )

    def keys(self, counters, src, dst, weights, row_hash, col_hash, row_offset=0, mirror=False):
        """Fold a batch of ``(src, dst)`` keys into ``counters`` in place,
        hashed by ``row_hash`` and ``col_hash``, and with ``mirror`` the
        edges ``(dst, src)`` too: :func:`ingest` of the hashed batch, in one
        launch of the kernel's key entry on ``cuda``; ``scatter`` hashes,
        then scatters."""
        fn = _KEY_FNS[resolve_backend(self.backend, counters.device)]
        return fn(counters, src, dst, weights.to(torch.float32), row_hash, col_hash, row_offset, mirror)


# ---------------------------------------------------------------------------
# host pre-aggregation — the heavy-tail fast path (DESIGN.md Section 10)
# ---------------------------------------------------------------------------

PREAGG_MIN_BATCH = 1024  # below this the sort costs more than it saves


def resolve_preagg(mode: Optional[str] = None, batch: Optional[int] = None) -> bool:
    """Resolve a pre-aggregation mode ("auto"/"on"/"off"/None) to a bool:
    "auto" collapses batches of at least ``PREAGG_MIN_BATCH`` edges."""
    if mode in (None, "auto"):
        return batch is None or batch >= PREAGG_MIN_BATCH
    if mode in ("on", "1", "true"):
        return True
    if mode in ("off", "0", "false"):
        return False
    raise ValueError(f"unknown preagg mode: {mode!r} (want auto/on/off)")


def preaggregate_edges(src, dst, weights, out_size: int):
    """Collapse duplicate (src, dst) pairs on the device with static shapes
    (reference ``preaggregate_edges``, ``src/repro/core/ingest.py:271``).

    A STABLE sort on the 32-bit mixed pair key (as ``lax.sort_key_val``'s,
    so two colliding pairs keep their stream order and the runs are the
    reference's), run boundaries by neighbour compare on the sorted (src,
    dst) themselves (a key collision splits a run, never merges two pairs),
    and segment sums as differences of one cumulative sum (no scatter).

    Returns ``(s_rep, d_rep, w_agg, n_seg)``, the first three of shape
    ``(out_size,)``: representative keys and summed weights of the first
    ``min(n_seg, out_size)`` segments; slots past ``n_seg`` carry weight 0.0
    and a duplicated real key.  ``n_seg`` is a 0-d int32 tensor; when it
    exceeds ``out_size`` the collapse did not fit and the caller takes the
    raw batch."""
    from repro_torch.core.hashing import mix_keys

    b = src.shape[0]
    order = torch.sort(mix_keys(src, dst), stable=True).indices
    s2, d2, w2 = src[order], dst[order], weights[order]
    first = torch.ones(b, dtype=torch.bool, device=src.device)
    first[1:] = (s2[1:] != s2[:-1]) | (d2[1:] != d2[:-1])
    seg = torch.cumsum(first, 0, dtype=torch.int32) - 1  # (B,) non-decreasing
    n_seg = seg[-1] + 1
    csum = torch.cat([w2.new_zeros(1), torch.cumsum(w2, 0)])
    starts = torch.searchsorted(
        seg, torch.arange(out_size, dtype=torch.int32, device=src.device), side="left"
    )
    ends = torch.cat([starts[1:], starts.new_full((1,), b)])
    w_agg = csum[ends] - csum[starts]
    reps = starts.clamp(0, b - 1)
    return s2[reps], d2[reps], w_agg, n_seg


@dataclasses.dataclass(frozen=True)
class PreaggBatch:
    """A host-collapsed edge batch: distinct pairs plus marginal totals.

    ``src/dst/weights`` hold one slot per distinct (src, dst) pair with
    exactly-summed signed weights; ``src_unique/src_totals`` and
    ``dst_unique/dst_totals`` are the per-endpoint marginals the flow
    registers need."""

    src: np.ndarray          # (P,) uint32
    dst: np.ndarray          # (P,) uint32
    weights: np.ndarray      # (P,) float32
    src_unique: np.ndarray   # (S,) uint32
    src_totals: np.ndarray   # (S,) float32
    dst_unique: np.ndarray   # (D,) uint32
    dst_totals: np.ndarray   # (D,) float32

    @property
    def n_pairs(self) -> int:
        return int(self.src.size)


def preaggregate_host(src, dst, weights) -> PreaggBatch:
    """Collapse duplicate (src, dst) pairs on the host: one stable argsort
    of the 64-bit pair key gives the pair sums via ``np.add.reduceat``; the
    per-src marginals fall out of the same order, and a second small argsort
    gives the per-dst marginals.  Exact for signed weights; bit-identical to
    the raw batch in the integer regime."""
    sn = np.atleast_1d(np.asarray(src, np.uint32))
    dn = np.atleast_1d(np.asarray(dst, np.uint32))
    wn = np.atleast_1d(np.asarray(weights, np.float32))
    if sn.size == 0:
        empty_u, empty_f = sn[:0], wn[:0]
        return PreaggBatch(sn, dn, wn, empty_u, empty_f, empty_u, empty_f)
    pair = (sn.astype(np.uint64) << np.uint64(32)) | dn.astype(np.uint64)
    order = np.argsort(pair, kind="stable")
    ps, ss, ds, ws = pair[order], sn[order], dn[order], wn[order]
    first = np.empty(ps.size, bool)
    first[0] = True
    first[1:] = ps[1:] != ps[:-1]
    starts = np.flatnonzero(first)
    s_rep, d_rep = ss[starts], ds[starts]
    w_agg = np.add.reduceat(ws, starts).astype(np.float32)
    sfirst = np.empty(starts.size, bool)
    sfirst[0] = True
    sfirst[1:] = s_rep[1:] != s_rep[:-1]
    sstarts = np.flatnonzero(sfirst)
    src_unique = s_rep[sstarts]
    src_totals = np.add.reduceat(w_agg, sstarts).astype(np.float32)
    dorder = np.argsort(d_rep, kind="stable")
    dr, dw = d_rep[dorder], w_agg[dorder]
    dfirst = np.empty(dr.size, bool)
    dfirst[0] = True
    dfirst[1:] = dr[1:] != dr[:-1]
    dstarts = np.flatnonzero(dfirst)
    dst_unique = dr[dstarts]
    dst_totals = np.add.reduceat(dw, dstarts).astype(np.float32)
    return PreaggBatch(s_rep, d_rep, w_agg, src_unique, src_totals, dst_unique, dst_totals)


def bucket_size(n: int, minimum: int = 256) -> int:
    """Next power of two at or above ``n`` (floored at ``minimum``): the
    padded-size ladder that keeps collapsed batch shapes to a few sizes."""
    size = minimum
    while size < n:
        size *= 2
    return size


def pad_bucket(x: np.ndarray, minimum: int = 256, value=0) -> np.ndarray:
    """Right-pad a 1-D host array to its :func:`bucket_size` with ``value``."""
    pad = bucket_size(x.size, minimum) - x.size
    if pad == 0:
        return x
    return np.concatenate([x, np.full(pad, value, x.dtype)])
