"""Distributed gLava: the paper's Section 6.3 on ``torch.distributed``.

Port of ``src/repro/core/distributed.py``.  The sketch is a *linear*
projection of the stream, so the distributed recipe is the paper's: every
worker ingests its part of the stream with the same hash family, and the
global sketch is the elementwise SUM of the parts.  On a
:class:`~repro_torch.distributed.mesh.Mesh`:

- the edge batch is split over the stream axes (``("data",)`` by default),
- the counters' ROW axis is split over ``model``: a rank holds the sketch
  SHARD, a :class:`~repro_torch.core.sketch.GLavaSketch` of the global
  config whose counters are its ``(d, w_r / tp, w_c)`` rows (rows
  ``[m · w_r/tp, (m+1) · w_r/tp)`` for model coordinate ``m``), with the
  global hash families and the flow registers, which every rank keeps whole,
- each rank folds its stream block into the rows it owns through the ingest
  engine (``row_offset`` masks the other rows; the CUDA scatter, B1, on the
  card), and
- an ``all_reduce(SUM)`` over the stream axes merges the blocks' deltas.

Every rank receives the same GLOBAL batch and the same queries, so every
rank makes the same collectives in the same order.  Query-side, the owner
of a row answers for it: the others contribute ``+inf`` to an
``all_reduce(MIN)`` over ``model``.  :func:`gather_rows` assembles the whole
counters on every rank for the families that need whole matrices.  Unlike
the reference, a batch of any length works: each stream block is padded
with inert slots (row -1, weight 0), where the reference's ``shard_map``
needs the data axis to divide the batch.

Integer weights with cell mass below 2^24 give counters, registers and
answers bit-identical to the local session (``core/ingest.py``'s
exact-equivalence contract).

:class:`MeshQueryEngine` is the query engine of a mesh session
(``GraphStream.open(mesh=...)``), port-only: edge and subgraph families
through :func:`distributed_edge_cells`, register families as in a local
session, and reachability on the closure (B3 on the card) of the gathered
counters, cached by epoch as the local engine caches it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core import queries
from repro_torch.core.ingest import ingest
from repro_torch.core.query_engine import QueryEngine, run_padded
from repro_torch.core.sketch import GLavaSketch, _weights, scatter_flows, scatter_register
from repro_torch.distributed.mesh import Mesh
from repro_torch.distributed.sharding import Placement, gather_block, local_shard
from repro_torch.kernels.flow.ops import flows
from repro_torch.kernels.query.ops import edge_query_cells

_SUM, _MIN = dist.ReduceOp.SUM, dist.ReduceOp.MIN


def counter_placement(mesh: Mesh, model_axis: str = "model") -> Placement:
    """The counters' placement: rows over ``model_axis``."""
    return Placement(mesh, (None, model_axis, None))


def rows_per_shard(mesh: Mesh, wr: int, model_axis: str = "model") -> int:
    """Rows a model shard holds (``w_r / tp``); the model axis must divide
    ``w_r``, as in the reference."""
    tp = mesh.shape[model_axis]
    if wr % tp:
        raise ValueError(f"sketch rows {wr} must divide over the model axis ({tp})")
    return wr // tp


def empty_shard(mesh: Mesh, config, generator=0, device=None, model_axis: str = "model") -> GLavaSketch:
    """This rank's shard of an all-zero sketch whose hash families
    ``GLavaSketch.empty(config, generator)`` would draw (the whole counters
    are never allocated)."""
    wr_local = rows_per_shard(mesh, config.width_rows, model_axis)
    row_hash, col_hash = GLavaSketch.hash_families(config, generator, device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return GLavaSketch(
        zeros(config.depth, wr_local, config.width_cols), row_hash, col_hash, config,
        zeros(config.depth, config.width_rows), zeros(config.depth, config.width_cols),
    )


def shard_sketch(mesh: Mesh, sketch: GLavaSketch, model_axis: str = "model") -> GLavaSketch:
    """This rank's shard of a WHOLE sketch: copies of its rows of the
    counters and of the registers, with the same hash families."""
    rows_per_shard(mesh, sketch.config.width_rows, model_axis)
    rows = local_shard(sketch.counters, counter_placement(mesh, model_axis))
    return dataclasses.replace(
        sketch, counters=rows.clone(memory_format=torch.contiguous_format),
        row_flows=sketch.row_flows.clone(), col_flows=sketch.col_flows.clone(),
    )


def merge_rows(mesh: Mesh, shard: GLavaSketch, whole: GLavaSketch, model_axis: str = "model") -> GLavaSketch:
    """A new shard: ``shard`` plus this rank's rows of the WHOLE sketch
    ``whole`` (rows ``[offset, offset + rows)``), and the two sketches'
    registers added, with no collective; neither operand is aliased."""
    rows = local_shard(whole.counters, counter_placement(mesh, model_axis))
    return dataclasses.replace(
        shard, counters=shard.counters + rows,
        row_flows=shard.row_flows + whole.row_flows, col_flows=shard.col_flows + whole.col_flows,
    )


def gather_rows(mesh: Mesh, shard: GLavaSketch, model_axis: str = "model") -> GLavaSketch:
    """The WHOLE sketch on every rank, from each rank's shard: the counters
    assembled by ``all_reduce(SUM)`` over ``model`` of zero-filled buffers
    that each hold one shard's rows (disjoint rows, so the sum is exact),
    with the shard's registers and hash families."""
    cfg = shard.config
    shape = (cfg.depth, cfg.width_rows, cfg.width_cols)
    whole = gather_block(shard.counters, counter_placement(mesh, model_axis), shape)
    return dataclasses.replace(shard, counters=whole)


def _stream_block(mesh: Mesh, stream_axes: Sequence[str], r, c, w):
    """This rank's contiguous block of a hashed (d, B) batch: the batch is
    padded with inert slots (row -1, column 0, weight 0) up to a multiple
    of the stream ranks, so every rank's block has the same length."""
    dp = mesh.size(stream_axes)
    b = r.shape[1]
    blk = -(-b // dp)
    pad = blk * dp - b
    if pad:
        r = F.pad(r, (0, pad), value=-1)
        c = F.pad(c, (0, pad))
        w = F.pad(w, (0, pad))
    lo = mesh.index(stream_axes) * blk
    return r[:, lo:lo + blk], c[:, lo:lo + blk], w[lo:lo + blk]


def distributed_ingest(
    mesh: Mesh,
    sketch: GLavaSketch,
    src: torch.Tensor,
    dst: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    *,
    stream_axes: Sequence[str] = ("data",),
    model_axis: str = "model",
    backend: str = "auto",
    preagg_marginals=None,
) -> GLavaSketch:
    """Ingest a GLOBAL edge batch, split over ``stream_axes``, into this
    rank's sketch SHARD, IN PLACE (the counterpart of the reference's
    donation); returns the shard.

    The rank hashes the whole batch, takes its stream block and folds it
    into its rows through the ingest engine with ``row_offset`` = its first
    row (``backend="auto"``: the CUDA scatter on the card, the plain
    scatter on the CPU, bit-identical in the counting regime; the
    reference's ``onehot`` is not ported).  The blocks merge as in the
    reference: ``delta = upd - shard``, ``all_reduce(SUM)`` of the delta over
    the stream axes, ``shard + delta``.  The replicated flow registers are
    updated from the whole global batch, or, for a host-collapsed batch,
    from ``preagg_marginals`` = ``(src_unique, src_totals, dst_unique,
    dst_totals)``, one register add per distinct endpoint."""
    w = _weights(src, weights)
    r, c = sketch.hash_edges(src, dst)  # (d, B)
    wr_local = rows_per_shard(mesh, sketch.config.width_rows, model_axis)
    if sketch.counters.shape[1] != wr_local:
        raise ValueError(f"the shard holds {sketch.counters.shape[1]} rows, the mesh gives it {wr_local}")
    if r.shape[1]:
        rb, cb, wb = _stream_block(mesh, stream_axes, r, c, w)
        upd = sketch.counters.clone()
        ingest(upd, rb, cb, wb, backend=backend, row_offset=mesh.coords[model_axis] * wr_local)
        delta = upd.sub_(sketch.counters)
        mesh.all_reduce_(delta, _SUM, stream_axes)
        sketch.counters.add_(delta)
        del upd, delta
    if preagg_marginals is not None:
        src_unique, src_totals, dst_unique, dst_totals = preagg_marginals
        scatter_register(sketch.row_flows, sketch.row_hash(src_unique), src_totals)
        scatter_register(sketch.col_flows, sketch.col_hash(dst_unique), dst_totals)
    else:
        scatter_flows(sketch.row_flows, sketch.col_flows, r, c, w)
    return sketch


def _owned(mesh: Mesh, sketch: GLavaSketch, rows: torch.Tensor, model_axis: str):
    """Global row buckets -> (rows local to this shard, clipped into range;
    the mask of those this shard owns)."""
    wr_local = sketch.counters.shape[1]
    local = rows - mesh.coords[model_axis] * wr_local
    mine = (local >= 0) & (local < wr_local)
    return local.clamp(0, wr_local - 1), mine


def distributed_edge_cells(
    mesh: Mesh, sketch: GLavaSketch, rows: torch.Tensor, cols: torch.Tensor, *, model_axis: str = "model"
) -> torch.Tensor:
    """Per-sketch cell values ``counters[i, rows[i,q], cols[i,q]]`` (d, Q) of
    a row-sharded sketch, on every rank: the per-sketch gather (B5,
    ``edge_query_cells``) on the shard with rows clipped into range, cells
    this shard does not own set to ``+inf``, ``all_reduce(MIN)`` over
    ``model``."""
    local, mine = _owned(mesh, sketch, rows, model_axis)
    vals = edge_query_cells(sketch.counters, local, cols)
    vals = torch.where(mine, vals, torch.full((), torch.inf, dtype=vals.dtype, device=vals.device))
    return mesh.all_reduce_(vals, _MIN, model_axis)


def distributed_edge_query(
    mesh: Mesh, sketch: GLavaSketch, src: torch.Tensor, dst: torch.Tensor, *, model_axis: str = "model"
) -> torch.Tensor:
    """Batched f̃_e over a row-sharded sketch: each shard contributes the
    cells it owns (others ``+inf``), min-reduced over ``model``, then the
    min over the d sketches."""
    r, c = sketch.hash_edges(src, dst)
    return distributed_edge_cells(mesh, sketch, r, c, model_axis=model_axis).amin(dim=0)


def distributed_point_query(
    mesh: Mesh,
    sketch: GLavaSketch,
    keys: torch.Tensor,
    direction: str = "in",
    *,
    model_axis: str = "model",
    use_registers: bool = True,
) -> torch.Tensor:
    """f̃_v over a row-sharded sketch.

    ``use_registers=True``: a gather from the replicated flow registers,
    with no collective.  ``use_registers=False`` reduces the counters (B6,
    ``flows``, on the shard): in-flow from the column sums, ``all_reduce
    (SUM)`` of the shards' partial sums over ``model``; out-flow from the
    row sums of the owner shard, the others ``+inf``, ``all_reduce(MIN)``."""
    if direction not in ("in", "out"):
        raise ValueError(f"direction must be 'in' or 'out', got {direction!r}")
    if use_registers:
        return queries.node_in_flow(sketch, keys) if direction == "in" else queries.node_out_flow(sketch, keys)
    row_sums, col_sums = flows(sketch.counters)
    if direction == "in":
        mesh.all_reduce_(col_sums, _SUM, model_axis)  # (d, w_c)
        return torch.gather(col_sums, 1, sketch.col_hash(keys)).amin(dim=0)
    local, mine = _owned(mesh, sketch, sketch.row_hash(keys), model_axis)
    vals = torch.gather(row_sums, 1, local)
    vals = torch.where(mine, vals, torch.full((), torch.inf, dtype=vals.dtype, device=vals.device))
    return mesh.all_reduce_(vals, _MIN, model_axis).amin(dim=0)


class MeshQueryEngine(QueryEngine):
    """The query engine of a mesh session: the sketch it is handed is this
    rank's shard.  Every rank runs the same queries, so every rank makes
    the same collectives.

    - edge: :func:`distributed_edge_query` (B5 on the shard), with the
      undirected self-loop correction of the local engine;
    - subgraph: the same cells, then the local engine's arithmetic;
    - flows and heavy hitters: the replicated registers, as locally;
    - reach: the closure of the gathered counters (B3 on the card), cached
      and refreshed by epoch exactly as the local engine does, so its full
      and incremental refresh counts are the local session's.  The whole
      counters are gathered only when the closure must be rebuilt or
      refreshed, and dropped after."""

    def __init__(self, mesh: Mesh, backend: str = "auto", model_axis: str = "model", **kwargs):
        super().__init__(backend, **kwargs)
        self.mesh = mesh
        self.model_axis = model_axis

    def _whole(self, sketch: GLavaSketch) -> GLavaSketch:
        if sketch.counters.shape[1] == sketch.config.width_rows:
            return sketch  # already whole (or a model axis of 1)
        return gather_rows(self.mesh, sketch, self.model_axis)

    def _edge(self, sketch: GLavaSketch, src, dst):
        est = distributed_edge_query(self.mesh, sketch, src, dst, model_axis=self.model_axis)
        if not sketch.config.directed:
            est = queries.undirected_selfloop_correction(est, src, dst)
        return est

    def edge(self, sketch: GLavaSketch, src, dst):
        self.dispatches["edge"] += 1
        return run_padded(self._edge, (sketch,), (src, dst), (), self.pad_q, self.chunk_q)

    def _cells(self, sketch: GLavaSketch, rows, cols):
        """:func:`distributed_edge_cells` of (d, ...) buckets of any shape."""
        d = rows.shape[0]
        return distributed_edge_cells(
            self.mesh, sketch, rows.reshape(d, -1), cols.reshape(d, -1), model_axis=self.model_axis
        ).reshape(rows.shape)

    def subgraph_batch(self, sketch: GLavaSketch, src, dst, mask):
        self.dispatches["subgraph_batch"] += 1
        return queries.subgraph_batch_from_cells(self._cells(sketch, sketch.row_hash(src), sketch.col_hash(dst)), mask)

    def subgraph(self, sketch: GLavaSketch, src, dst, optimized: bool = False):
        self.dispatches["subgraph_opt" if optimized else "subgraph"] += 1
        if optimized:
            return queries.subgraph_from_estimates(self._edge(sketch, src, dst))
        return queries.subgraph_from_cells(self._cells(sketch, *sketch.hash_edges(src, dst)))

    def closure_for(self, sketch: GLavaSketch, epoch: Optional[int] = None) -> torch.Tensor:
        if self._closure_fresh(sketch, epoch):
            return self._closure
        return super().closure_for(self._whole(sketch), epoch)

    def refresh_closure(self, sketch: GLavaSketch, touched_keys, epoch: Optional[int] = None) -> torch.Tensor:
        if self._closure_fresh(sketch, epoch):
            return self._closure
        return super().refresh_closure(self._whole(sketch), touched_keys, epoch)
