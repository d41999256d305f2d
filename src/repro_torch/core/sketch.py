"""gLava graph sketches.

Port of ``src/repro/core/sketch.py``: the :class:`GLavaSketch` core, its
one-pass fused update and its order-dependent sequential and conservative
updates, and the four baselines the paper measures gLava against
(:class:`CountMin`, :class:`NodeCountMin`, :class:`CountSketch`,
:class:`GSketch`), and the fleet's :func:`scatter_stacked_` into stacked
sketch planes.

:class:`GLavaSketch` holds ``d`` independent graph sketches, each a
``w_r × w_c`` weighted adjacency matrix over hashed node buckets (paper
Section 3.3), plus the ``row_flows``/``col_flows`` registers (row and column
sums of the counters) that point, flow and heavy-hitter queries read.

The reference is functional: every update returns a new sketch.  The port
updates IN PLACE through the trailing-underscore methods (``update_``,
``update_preaggregated_``, ``update_fused_``, ``update_sequential_``,
``update_conservative_``, ``delete_``), which is its
counterpart of the reference's buffer donation; the plain-named methods keep
the reference's functional meaning by updating a clone.  ``merge`` and ``scale`` return new
tensors, so no result aliases an operand.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, ContextManager, Optional, Union

import numpy as np
import torch

from repro_torch.core.hashing import HashFamily, keys_to_tensor, make_hash_family, mix_keys
from repro_torch.core.ingest import IngestEngine, resolve_backend
from repro_torch.kernels.countsketch.ref import median_ref
from repro_torch.kernels.ingest_fused.ops import fused_ingest
from repro_torch.kernels.ingest_stacked.ops import stacked_ingest
from repro_torch.kernels.ingest_stacked.ref import stacked_ingest_ref
from repro_torch.kernels.preagg.ops import CollapseTables, preagg_collapse
from repro_torch.kernels.sequential.ops import sequential_update


@dataclasses.dataclass(frozen=True)
class SketchConfig:
    """Static configuration of a gLava sketch."""

    depth: int = 4          # d — number of independent sketches
    width_rows: int = 1024  # w_r
    width_cols: int = 1024  # w_c (== width_rows for the square/paper-default)
    directed: bool = True

    @property
    def is_square(self) -> bool:
        return self.width_rows == self.width_cols

    @property
    def num_cells(self) -> int:
        return self.depth * self.width_rows * self.width_cols

    def space_bytes(self) -> int:
        return self.num_cells * 4

    @staticmethod
    def for_error(epsilon: float, delta: float, square: bool = True) -> "SketchConfig":
        """Size per paper Thm 1 / Lemma 5.2: w = ceil(e/sqrt(eps)) per side,
        d = ceil(ln(1/delta))."""
        w = int(np.ceil(np.e / np.sqrt(epsilon)))
        d = max(1, int(np.ceil(np.log(1.0 / delta))))
        return SketchConfig(depth=d, width_rows=w, width_cols=w)

    def error_bound(self) -> tuple:
        """The (ε, δ) this sketch certifies — the inverse of :meth:`for_error`
        (ε = e²/(w_r·w_c), δ = e^(−d)), nudged up by a 1e-12 relative factor
        so ``for_error(*cfg.error_bound())`` round-trips to the same config."""
        eps = float(np.e**2 / (self.width_rows * self.width_cols)) * (1 + 1e-12)
        delta = float(np.exp(-self.depth)) * (1 + 1e-12)
        return eps, delta


def _weights(src: torch.Tensor, weights: Optional[torch.Tensor]) -> torch.Tensor:
    """Float32 weights of a batch; ones when none are given."""
    if weights is None:
        return torch.ones(src.shape, dtype=torch.float32, device=src.device)
    return weights.to(torch.float32)


def scatter_register(register: torch.Tensor, buckets: torch.Tensor, weights: torch.Tensor):
    """Scatter-add ``weights`` ((B,), or (d, B) per depth) into one (d, w)
    register (a flow register, or a baseline's counters) at per-depth
    ``buckets`` (d, B), in place; returns the register."""
    d, w = register.shape
    d_idx = torch.arange(d, device=register.device)[:, None]
    flat = (d_idx * w + buckets.long()).reshape(-1)
    vals = weights.to(register.dtype).expand(buckets.shape).reshape(-1)
    register.view(-1).index_add_(0, flat, vals)
    return register


def scatter_flows(row_flows, col_flows, rows, cols, weights):
    """Fold one hashed edge batch into both flow registers, in place — the
    same scatter-add semantics as counter ingest, restricted to the two
    marginals (bit-matches the counters' row/col sums for integer weights)."""
    return (
        scatter_register(row_flows, rows, weights),
        scatter_register(col_flows, cols, weights),
    )


_STACKED_FNS = {"scatter": stacked_ingest_ref, "cuda": stacked_ingest}


def scatter_stacked_(
    counters: torch.Tensor,   # (N, d, w_r, w_c) — N stacked sketch planes, updated in place
    row_flows: torch.Tensor,  # (N, d, w_r), updated in place
    col_flows: torch.Tensor,  # (N, d, w_c), updated in place
    plane: torch.Tensor,      # (B,) int32 or int64 — target plane per edge
    rows: torch.Tensor,       # (d, B) int32 or int64
    cols: torch.Tensor,       # (d, B)
    weights: torch.Tensor,    # (B,)
    backend: str = "auto",
):
    """Scatter-add one hashed edge batch into STACKED sketch planes, in place
    (reference ``scatter_stacked``, ``src/repro/core/sketch.py:120``).

    The fleet stacks many same-config sketches (tenant × window slice) along
    a leading axis; ``plane`` selects the target per edge, so one call folds
    a mixed multi-tenant batch into the whole stack, counters and both
    registers.  The ingest backend names of :mod:`repro_torch.core.ingest`
    apply: ``cuda`` is the stacked kernel (``kernels/ingest_stacked``, one
    launch), ``scatter`` its plain version, ``auto`` the kernel for a stack
    on a CUDA device.  Offsets are 64-bit wherever the stack passes 2^31
    cells, where the reference's int32 index wraps.  Returns the three
    tensors."""
    fn = _STACKED_FNS[resolve_backend(backend, counters.device)]
    return fn(counters, row_flows, col_flows, plane, rows, cols, weights.to(torch.float32))


def scatter_stacked(counters, row_flows, col_flows, plane, rows, cols, weights, backend: str = "auto"):
    """:func:`scatter_stacked_` on copies: the reference's functional form."""
    return scatter_stacked_(
        counters.clone(), row_flows.clone(), col_flows.clone(), plane, rows, cols, weights, backend=backend
    )


@dataclasses.dataclass(frozen=True, eq=False)
class GLavaSketch:
    """d graph sketches with per-sketch row/col hash functions and the two
    maintained flow registers (DESIGN.md Section 3).  The tensor fields are
    updated in place by the ``*_`` methods; the object's fields never
    change."""

    counters: torch.Tensor   # (d, w_r, w_c) float32
    row_hash: HashFamily
    col_hash: HashFamily
    config: SketchConfig
    row_flows: torch.Tensor  # (d, w_r) — row sums of counters
    col_flows: torch.Tensor  # (d, w_c) — col sums of counters

    @property
    def depth(self) -> int:
        return self.config.depth

    @property
    def device(self) -> torch.device:
        return self.counters.device

    # -- constructors -------------------------------------------------------

    @staticmethod
    def empty(
        config: SketchConfig,
        generator: Union[torch.Generator, int] = 0,
        device: Optional[torch.device] = None,
    ) -> "GLavaSketch":
        """All-zero sketch with hash families drawn from ``generator`` (a CPU
        ``torch.Generator``, or an int seed for a fresh one).  Square configs
        share ONE family between rows and columns (the paper default, needed
        for graph algorithms on the sketch)."""
        row_hash, col_hash = GLavaSketch.hash_families(config, generator, device)
        return GLavaSketch(
            torch.zeros(
                (config.depth, config.width_rows, config.width_cols),
                dtype=torch.float32, device=device,
            ),
            row_hash,
            col_hash,
            config,
            torch.zeros((config.depth, config.width_rows), dtype=torch.float32, device=device),
            torch.zeros((config.depth, config.width_cols), dtype=torch.float32, device=device),
        )

    @staticmethod
    def hash_families(
        config: SketchConfig,
        generator: Union[torch.Generator, int] = 0,
        device: Optional[torch.device] = None,
    ):
        """The ``(row_hash, col_hash)`` pair :meth:`empty` draws from
        ``generator``; one shared family for a square config."""
        if not isinstance(generator, torch.Generator):
            generator = torch.Generator().manual_seed(int(generator))
        row_hash = make_hash_family(generator, config.depth, config.width_rows, device)
        if config.is_square:
            return row_hash, row_hash
        return row_hash, make_hash_family(generator, config.depth, config.width_cols, device)

    def clone(self) -> "GLavaSketch":
        """A copy with its own counters and registers (hash families are
        immutable and shared)."""
        return dataclasses.replace(
            self,
            counters=self.counters.clone(),
            row_flows=self.row_flows.clone(),
            col_flows=self.col_flows.clone(),
        )

    def to(self, device: Optional[torch.device]) -> "GLavaSketch":
        """A copy on ``device`` with its own counters and registers."""
        row = self.row_hash.to(device)
        col = row if self.col_hash is self.row_hash else self.col_hash.to(device)
        return GLavaSketch(
            self.counters.to(device, copy=True),
            row,
            col,
            self.config,
            self.row_flows.to(device, copy=True),
            self.col_flows.to(device, copy=True),
        )

    # -- ingest (in place) -----------------------------------------------------

    def hash_edges(self, src: torch.Tensor, dst: torch.Tensor):
        """(B,) keys -> ((d, B) row buckets, (d, B) col buckets)."""
        return self.row_hash(src), self.col_hash(dst)

    def update_(
        self,
        src: torch.Tensor,
        dst: torch.Tensor,
        weights: Optional[torch.Tensor] = None,
        backend: str = "auto",
    ) -> "GLavaSketch":
        """Ingest a batch of stream elements (x, y; w) in place: counters
        through the :class:`IngestEngine`, both registers by scatter, and the
        mirrored edge too for undirected sketches (paper Section 6.1.1)."""
        weights = _weights(src, weights)
        engine = IngestEngine(backend)
        r, c = self.hash_edges(src, dst)
        engine(self.counters, r, c, weights)
        scatter_flows(self.row_flows, self.col_flows, r, c, weights)
        if not self.config.directed:
            r2, c2 = self.hash_edges(dst, src)
            engine(self.counters, r2, c2, weights)
            scatter_flows(self.row_flows, self.col_flows, r2, c2, weights)
        return self

    def update_preaggregated_(
        self,
        src: torch.Tensor,          # (P,) distinct-pair sources
        dst: torch.Tensor,          # (P,) distinct-pair destinations
        weights: torch.Tensor,      # (P,) per-pair summed weights
        src_unique: torch.Tensor,   # (S,) distinct sources
        src_totals: torch.Tensor,   # (S,) per-source summed weights
        dst_unique: torch.Tensor,   # (D,) distinct destinations
        dst_totals: torch.Tensor,   # (D,) per-destination summed weights
        backend: str = "auto",
    ) -> "GLavaSketch":
        """Ingest a HOST-COLLAPSED batch (``preaggregate_host``) in place:
        one counter slot per distinct pair, one register slot per distinct
        endpoint.  Zero-weight padding slots are no-ops in the counting
        regime, so callers may pad all seven arrays freely.  The counters
        take the pairs as keys (:meth:`IngestEngine.keys`: on the card one
        launch that hashes them, the mirrored pairs of an undirected sketch
        included); the registers take the marginals
        (:meth:`update_marginals_`)."""
        IngestEngine(backend).keys(
            self.counters, src, dst, weights, self.row_hash, self.col_hash, mirror=not self.config.directed
        )
        return self.update_marginals_(src_unique, src_totals, dst_unique, dst_totals)

    def update_marginals_(self, src_unique, src_totals, dst_unique, dst_totals) -> "GLavaSketch":
        """The register side of :meth:`update_preaggregated_`, in place: each
        distinct source's total into ``row_flows``, each distinct
        destination's into ``col_flows``, and for an undirected sketch the
        mirrored roles too."""
        scatter_register(self.row_flows, self.row_hash(src_unique), src_totals)
        scatter_register(self.col_flows, self.col_hash(dst_unique), dst_totals)
        if not self.config.directed:
            scatter_register(self.row_flows, self.row_hash(dst_unique), dst_totals)
            scatter_register(self.col_flows, self.col_hash(src_unique), src_totals)
        return self

    def update_collapsed_(
        self,
        batch: torch.Tensor,                      # (3, B) int32: src, dst, the weights' float32 bits
        tables: Optional[CollapseTables] = None,  # the card pass's tables, kept by the caller
        track_rows: bool = False,
        backend: str = "auto",
        collapse_scope: Callable[[], ContextManager] = contextlib.nullcontext,
    ):
        """Ingest a RAW batch in place, collapsed on the sketch's device
        (``repro_torch.kernels.preagg``: on the card two launches that add
        the distinct sources' and destinations' totals into the registers
        and mark the rows, inside ``collapse_scope()``), then the distinct
        pairs as keys (:meth:`IngestEngine.keys`).  The same result as
        :meth:`update_preaggregated_` of ``preaggregate_host``'s collapse,
        bit for bit in the counting regime.

        Returns ``(self, touched)``: with ``track_rows`` a new (d, w_r) bool
        bitmap of the rows the batch wrote (its distinct sources', and
        mirrored its destinations'), else ``None``."""
        mirror = not self.config.directed
        with collapse_scope():
            touched = (torch.empty((self.depth, self.config.width_rows), dtype=torch.bool, device=self.device)
                       if track_rows else None)
            src, dst, w = preagg_collapse(
                batch, self.row_flows, self.col_flows, touched, self.row_hash, self.col_hash, mirror, tables
            )
        IngestEngine(backend).keys(self.counters, src, dst, w, self.row_hash, self.col_hash, mirror=mirror)
        return self, touched

    def update_fused_(
        self,
        src: torch.Tensor,
        dst: torch.Tensor,
        weights: Optional[torch.Tensor] = None,
    ):
        """One-pass fused ingest in place: counters, both flow registers AND
        the touched-row bitmap in one sweep over the batch
        (``repro_torch.kernels.ingest_fused``: the CUDA kernel for a sketch
        on the card, its plain version on the CPU).

        Returns ``(self, touched)`` with ``touched`` a (d, w_r) bool bitmap
        of the row buckets this batch wrote, on the sketch's device: the
        replacement for the host-side ``touched_row_keys`` pass, consumed by
        ``QueryEngine.refresh_closure``.  Undirected sketches make a second
        launch for the mirrored edges, which ORs its rows into the first
        launch's bitmap."""
        weights = _weights(src, weights)
        r, c = self.hash_edges(src, dst)
        *_, touched = fused_ingest(self.counters, self.row_flows, self.col_flows, r, c, weights)
        if not self.config.directed:
            r2, c2 = self.hash_edges(dst, src)
            fused_ingest(self.counters, self.row_flows, self.col_flows, r2, c2, weights, touched)
        return self, touched

    def update_sequential_(self, src, dst, weights=None) -> "GLavaSketch":
        """Strictly sequential per-edge ingest in place, the paper's literal
        Step 2 (reference ``update_sequential``, ``src/repro/core/sketch.py:399``):
        the edges are added one after another in stream order
        (``kernels/sequential``, one launch), the mirrored batch of an
        undirected sketch through the batched ingest, and the registers are
        recomputed from the counters."""
        weights = _weights(src, weights)
        r, c = self.hash_edges(src, dst)
        sequential_update(self.counters, r, c, weights, conservative=False)
        if not self.config.directed:
            r2, c2 = self.hash_edges(dst, src)
            IngestEngine("auto")(self.counters, r2, c2, weights)
        return self._recompute_registers()

    def update_conservative_(self, src, dst, weights=None) -> "GLavaSketch":
        """Conservative update (Estan–Varghese) in place (reference
        ``update_conservative``, ``src/repro/core/sketch.py:420``): edge by
        edge in stream order, each of the edge's d cells is raised to
        ``max(cell, min of the d cells + w)`` (``kernels/sequential``, one
        launch); the update is non-linear, so the registers are recomputed
        from the counters.  Undirected edges are not mirrored, as in the
        reference."""
        weights = _weights(src, weights)
        r, c = self.hash_edges(src, dst)
        sequential_update(self.counters, r, c, weights, conservative=True)
        return self._recompute_registers()

    def _recompute_registers(self) -> "GLavaSketch":
        torch.sum(self.counters, dim=2, out=self.row_flows)
        torch.sum(self.counters, dim=1, out=self.col_flows)
        return self

    def delete_(self, src, dst, weights=None, backend: str = "auto") -> "GLavaSketch":
        """Turnstile deletion (paper Section 6.1.1) in place: a
        negative-weight update."""
        return self.update_(src, dst, -_weights(src, weights), backend=backend)

    # -- functional forms (the reference's semantics) ----------------------------

    def update(self, src, dst, weights=None, backend: str = "auto") -> "GLavaSketch":
        return self.clone().update_(src, dst, weights, backend=backend)

    def update_preaggregated(self, *args, backend: str = "auto") -> "GLavaSketch":
        return self.clone().update_preaggregated_(*args, backend=backend)

    def update_fused(self, src, dst, weights=None):
        """``(new_sketch, touched)``; this sketch is left as it was."""
        return self.clone().update_fused_(src, dst, weights)

    def update_sequential(self, src, dst, weights=None) -> "GLavaSketch":
        """Reference ``update_sequential`` (``src/repro/core/sketch.py:399``):
        :meth:`update_sequential_` on a copy."""
        return self.clone().update_sequential_(src, dst, weights)

    def update_conservative(self, src, dst, weights=None) -> "GLavaSketch":
        """Reference ``update_conservative`` (``src/repro/core/sketch.py:420``):
        :meth:`update_conservative_` on a copy."""
        return self.clone().update_conservative_(src, dst, weights)

    def delete(self, src, dst, weights=None, backend: str = "auto") -> "GLavaSketch":
        return self.clone().delete_(src, dst, weights, backend=backend)

    # -- linear-sketch algebra ----------------------------------------------

    def with_counters(self, counters: torch.Tensor) -> "GLavaSketch":
        """Replace the counter tensor wholesale and recompute the registers
        from it (the safe path for counter-level surgery)."""
        return dataclasses.replace(
            self,
            counters=counters,
            row_flows=counters.sum(dim=2),
            col_flows=counters.sum(dim=1),
        )

    def merge(self, other: "GLavaSketch") -> "GLavaSketch":
        """Merge two sketches built with the SAME hash family (linearity)."""
        return dataclasses.replace(
            self,
            counters=self.counters + other.counters,
            row_flows=self.row_flows + other.row_flows,
            col_flows=self.col_flows + other.col_flows,
        )

    def scale(self, gamma: float) -> "GLavaSketch":
        """Exponential decay of history (streaming time-window variant)."""
        return dataclasses.replace(
            self,
            counters=self.counters * gamma,
            row_flows=self.row_flows * gamma,
            col_flows=self.col_flows * gamma,
        )

    def same_family(self, other: "GLavaSketch") -> bool:
        return self.row_hash.same_values(other.row_hash) and self.col_hash.same_values(
            other.col_hash
        )


# ---------------------------------------------------------------------------
# Baselines: CountMin (edge-keyed), node-stream CountMin, CountSketch, gSketch
# ---------------------------------------------------------------------------
#
# Port of the reference's baselines (``src/repro/core/sketch.py:490-658``).
# Each takes an explicit ``device`` and a CPU ``torch.Generator`` (or an int
# seed) where the reference takes a JAX key; their hash draws are PyTorch's,
# so parity tests carry the reference's state across with ``convert.py``.
# The scatters are the reference's ``.at[].add`` (no Pallas kernel), done by
# :func:`scatter_register` (``index_add_``) and, for gSketch's stacked
# partitions, ``index_put_(accumulate=True)``.  As for GLavaSketch,
# ``update_`` updates in place and ``update`` returns a new sketch.


def _generator(generator: Union[torch.Generator, int]) -> torch.Generator:
    if isinstance(generator, torch.Generator):
        return generator
    return torch.Generator().manual_seed(int(generator))


@dataclasses.dataclass(frozen=True, eq=False)
class CountMin:
    """Classic CountMin over EDGE keys (``mix_keys(src, dst)``), the Example-2
    baseline (reference ``CountMin``, ``src/repro/core/sketch.py:490``): it
    treats each stream element on its own, so it answers edge frequencies and
    nothing that needs connectivity."""

    counters: torch.Tensor  # (d, w) float32
    hash: HashFamily

    @staticmethod
    def empty(depth: int, width: int, generator: Union[torch.Generator, int] = 0,
              device: Optional[torch.device] = None) -> "CountMin":
        fam = make_hash_family(_generator(generator), depth, width, device)
        return CountMin(torch.zeros((depth, width), dtype=torch.float32, device=device), fam)

    def update_(self, src, dst, weights=None) -> "CountMin":
        scatter_register(self.counters, self.hash(mix_keys(src, dst)), _weights(src, weights))
        return self

    def update(self, src, dst, weights=None) -> "CountMin":
        return dataclasses.replace(self, counters=self.counters.clone()).update_(src, dst, weights)

    def edge_query(self, src, dst) -> torch.Tensor:
        h = self.hash(mix_keys(src, dst))  # (d, Q)
        return torch.gather(self.counters, 1, h).amin(dim=0)

    def merge(self, other: "CountMin") -> "CountMin":
        return dataclasses.replace(self, counters=self.counters + other.counters)


@dataclasses.dataclass(frozen=True, eq=False)
class NodeCountMin:
    """CountMin over the node stream (paper Section 5.2's reduction; reference
    ``NodeCountMin``, ``src/repro/core/sketch.py:526``): one CountMin keyed by
    each edge's source, one by its destination; the point-query baseline.
    The two counters are separate tensors (the reference may share one zero
    array between them; the port updates in place)."""

    counters_out: torch.Tensor  # (d, w) keyed by src
    counters_in: torch.Tensor   # (d, w) keyed by dst
    hash: HashFamily

    @staticmethod
    def empty(depth: int, width: int, generator: Union[torch.Generator, int] = 0,
              device: Optional[torch.device] = None) -> "NodeCountMin":
        fam = make_hash_family(_generator(generator), depth, width, device)
        zeros = lambda: torch.zeros((depth, width), dtype=torch.float32, device=device)  # noqa: E731
        return NodeCountMin(zeros(), zeros(), fam)

    def update_(self, src, dst, weights=None) -> "NodeCountMin":
        w = _weights(src, weights)
        scatter_register(self.counters_out, self.hash(src), w)
        scatter_register(self.counters_in, self.hash(dst), w)
        return self

    def update(self, src, dst, weights=None) -> "NodeCountMin":
        return dataclasses.replace(
            self, counters_out=self.counters_out.clone(), counters_in=self.counters_in.clone()
        ).update_(src, dst, weights)

    def out_flow(self, keys) -> torch.Tensor:
        return torch.gather(self.counters_out, 1, self.hash(keys)).amin(dim=0)

    def in_flow(self, keys) -> torch.Tensor:
        return torch.gather(self.counters_in, 1, self.hash(keys)).amin(dim=0)


@dataclasses.dataclass(frozen=True, eq=False)
class CountSketch:
    """Signed sketch (AMS/CountSketch) over keys, an unbiased estimator with a
    median merge (reference ``CountSketch``, ``src/repro/core/sketch.py:566``).
    The median follows ``jnp.median``: the midpoint of the two middle values
    for an even depth, NaN where any value is NaN
    (``kernels/countsketch/ref.py::median_ref``)."""

    counters: torch.Tensor  # (d, w) float32
    hash: HashFamily

    @staticmethod
    def empty(depth: int, width: int, generator: Union[torch.Generator, int] = 0,
              device: Optional[torch.device] = None) -> "CountSketch":
        fam = make_hash_family(_generator(generator), depth, width, device)
        return CountSketch(torch.zeros((depth, width), dtype=torch.float32, device=device), fam)

    def update_(self, keys, weights) -> "CountSketch":
        s = self.hash.signs(keys).to(torch.float32)  # (d, B) ±1
        scatter_register(self.counters, self.hash(keys), s * weights.to(torch.float32)[None, :])
        return self

    def update(self, keys, weights) -> "CountSketch":
        return dataclasses.replace(self, counters=self.counters.clone()).update_(keys, weights)

    def query(self, keys) -> torch.Tensor:
        h = self.hash(keys)
        s = self.hash.signs(keys).to(torch.float32)
        return median_ref(torch.gather(self.counters, 1, h) * s)

    def merge(self, other: "CountSketch") -> "CountSketch":
        return dataclasses.replace(self, counters=self.counters + other.counters)


@dataclasses.dataclass(frozen=True, eq=False)
class GSketch:
    """gSketch (Zhao et al., PVLDB'11; reference ``GSketch``,
    ``src/repro/core/sketch.py:598``): CountMin partitioned by a data sample,
    so hot regions of the stream get proportionally wider partitions.  A
    one-deep hash of the edge's source routes it to one of ``k`` CountMin
    partitions stacked as ``(k, d, w_max)`` counters, partition p using its
    first ``widths[p]`` columns."""

    partitions: CountMin     # counters (k, d, w_max)
    widths: torch.Tensor     # (k,) int32 — active width per partition
    part_hash: HashFamily    # 1-deep hash onto [0, k)

    @staticmethod
    def allocate_widths(part_hash: HashFamily, sample_src, k: int, total_width: int) -> np.ndarray:
        """Partition widths proportional to the sample's mass per partition,
        exactly as the reference's ``from_sample`` computes them (numpy,
        ``bincount + 1``, at least 8 each, int64)."""
        part_of = part_hash(keys_to_tensor(sample_src, part_hash.device)).cpu().numpy()[0]
        mass = np.bincount(part_of, minlength=k).astype(np.float64) + 1.0
        return np.maximum(8, (total_width * mass / mass.sum()).astype(np.int64))

    @staticmethod
    def from_sample(depth: int, total_width: int, k: int, sample_src,
                    generator: Union[torch.Generator, int] = 0,
                    device: Optional[torch.device] = None) -> "GSketch":
        """Reference ``GSketch.from_sample`` (``src/repro/core/sketch.py:612``):
        the partition hash, then the widths from the sample, then the
        partitions' family over the widest width."""
        gen = _generator(generator)
        part_hash = make_hash_family(gen, 1, k, device)
        widths = GSketch.allocate_widths(part_hash, sample_src, k, total_width)
        w_max = int(widths.max())
        fam = make_hash_family(gen, depth, w_max, device)
        counters = torch.zeros((k, depth, w_max), dtype=torch.float32, device=device)
        return GSketch(
            CountMin(counters, fam), torch.from_numpy(widths.astype(np.int32)).to(device), part_hash
        )

    def _cells(self, src, dst):
        part = self.part_hash(src)[0]                                  # (B,)
        h = self.partitions.hash(mix_keys(src, dst)) % self.widths[part][None, :]  # (d, B)
        d_idx = torch.arange(h.shape[0], device=h.device)[:, None].expand(h.shape)
        return part[None, :].expand(h.shape), d_idx, h

    def update_(self, src, dst, weights=None) -> "GSketch":
        cells = self._cells(src, dst)
        w = _weights(src, weights)[None, :].expand(cells[2].shape)
        self.partitions.counters.index_put_(cells, w, accumulate=True)
        return self

    def update(self, src, dst, weights=None) -> "GSketch":
        parts = dataclasses.replace(self.partitions, counters=self.partitions.counters.clone())
        return dataclasses.replace(self, partitions=parts).update_(src, dst, weights)

    def edge_query(self, src, dst) -> torch.Tensor:
        return self.partitions.counters[self._cells(src, dst)].amin(dim=0)
