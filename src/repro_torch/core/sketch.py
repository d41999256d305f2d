"""gLava graph sketches.

Port of ``src/repro/core/sketch.py`` (the :class:`GLavaSketch` core and its
one-pass fused update; the baselines CountMin, NodeCountMin, CountSketch and
gSketch, and the conservative and sequential updates, are not ported yet).

:class:`GLavaSketch` holds ``d`` independent graph sketches, each a
``w_r × w_c`` weighted adjacency matrix over hashed node buckets (paper
Section 3.3), plus the ``row_flows``/``col_flows`` registers (row and column
sums of the counters) that point, flow and heavy-hitter queries read.

The reference is functional: every update returns a new sketch.  The port
updates IN PLACE through the trailing-underscore methods (``update_``,
``update_preaggregated_``, ``update_fused_``, ``delete_``), which is its
counterpart of the reference's buffer donation; the plain-named methods keep
the reference's functional meaning by updating a clone.  ``merge`` and ``scale`` return new
tensors, so no result aliases an operand.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core.hashing import HashFamily, make_hash_family
from repro_torch.core.ingest import IngestEngine
from repro_torch.kernels.ingest_fused.ops import fused_ingest


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


def scatter_register(register: torch.Tensor, buckets: torch.Tensor, weights: torch.Tensor):
    """Scatter-add ``weights`` (B,) into one (d, w) flow register at per-depth
    ``buckets`` (d, B), in place; returns the register."""
    d, w = register.shape
    d_idx = torch.arange(d, device=register.device)[:, None]
    flat = (d_idx * w + buckets.long()).reshape(-1)
    vals = weights.to(register.dtype)[None, :].expand(buckets.shape).reshape(-1)
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
        if not isinstance(generator, torch.Generator):
            generator = torch.Generator().manual_seed(int(generator))
        row_hash = make_hash_family(generator, config.depth, config.width_rows, device)
        if config.is_square:
            col_hash = row_hash
        else:
            col_hash = make_hash_family(generator, config.depth, config.width_cols, device)
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
        if weights is None:
            weights = torch.ones(src.shape, dtype=torch.float32, device=src.device)
        weights = weights.to(torch.float32)
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
        regime, so callers may pad all seven arrays freely."""
        weights = weights.to(torch.float32)
        engine = IngestEngine(backend)
        r, c = self.hash_edges(src, dst)
        engine(self.counters, r, c, weights)
        scatter_register(self.row_flows, self.row_hash(src_unique), src_totals)
        scatter_register(self.col_flows, self.col_hash(dst_unique), dst_totals)
        if not self.config.directed:
            r2, c2 = self.hash_edges(dst, src)
            engine(self.counters, r2, c2, weights)
            scatter_register(self.row_flows, self.row_hash(dst_unique), dst_totals)
            scatter_register(self.col_flows, self.col_hash(src_unique), src_totals)
        return self

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
        if weights is None:
            weights = torch.ones(src.shape, dtype=torch.float32, device=src.device)
        weights = weights.to(torch.float32)
        r, c = self.hash_edges(src, dst)
        *_, touched = fused_ingest(self.counters, self.row_flows, self.col_flows, r, c, weights)
        if not self.config.directed:
            r2, c2 = self.hash_edges(dst, src)
            fused_ingest(self.counters, self.row_flows, self.col_flows, r2, c2, weights, touched)
        return self, touched

    def delete_(self, src, dst, weights=None, backend: str = "auto") -> "GLavaSketch":
        """Turnstile deletion (paper Section 6.1.1) in place: a
        negative-weight update."""
        if weights is None:
            weights = torch.ones(src.shape, dtype=torch.float32, device=src.device)
        return self.update_(src, dst, -weights.to(torch.float32), backend=backend)

    # -- functional forms (the reference's semantics) ----------------------------

    def update(self, src, dst, weights=None, backend: str = "auto") -> "GLavaSketch":
        return self.clone().update_(src, dst, weights, backend=backend)

    def update_preaggregated(self, *args, backend: str = "auto") -> "GLavaSketch":
        return self.clone().update_preaggregated_(*args, backend=backend)

    def update_fused(self, src, dst, weights=None):
        """``(new_sketch, touched)``; this sketch is left as it was."""
        return self.clone().update_fused_(src, dst, weights)

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
