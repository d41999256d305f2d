"""FleetSketch — T tenant gLava sketches stacked into one dense tensor.

Port of ``src/repro/fleet/stack.py``.  One fleet holds ``capacity`` tenant
*slots*, each a full sliding-window gLava sketch, laid out as
``(T, K, d, w_r, w_c)`` counters plus the matching stacked flow registers and
a per-tenant window cursor.  All slots share ONE hash family, drawn as
``GLavaSketch.empty`` draws it, so a fleet tenant is bit-identical to an
independent ``GraphStream`` opened with the same seed.

``K`` is the sliding-window ring depth; non-windowed fleets use ``K=1``, so
the ingest scatter, eviction shards and query gathers have ONE code path.
Per-slot views (:meth:`FleetSketch.tenant_sketch`) sum the window axis, as
``SlidingWindowSketch.window_sketch()`` does.

The reference is functional; the port updates the stack IN PLACE through the
trailing-underscore methods (``update_``, ``load_tenant_``, ``clear_tenant_``,
``advance_``), and the plain-named methods keep the reference's meaning by
working on a clone.  :meth:`FleetSketch.update_` folds a mixed batch into the
stack with one stacked-ingest launch per direction
(``core/sketch.py::scatter_stacked_``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from repro_torch.core.hashing import HashFamily
from repro_torch.core.sketch import GLavaSketch, SketchConfig, scatter_stacked_


@dataclasses.dataclass(eq=False)
class FleetSketch:
    """The fleet's device state: every resident tenant's sketch, stacked."""

    counters: torch.Tensor   # (T, K, d, w_r, w_c) float32
    row_flows: torch.Tensor  # (T, K, d, w_r)
    col_flows: torch.Tensor  # (T, K, d, w_c)
    cursor: torch.Tensor     # (T,) int32 — active window slice per tenant
    row_hash: HashFamily     # shared across all slots
    col_hash: HashFamily     # IS row_hash for square configs
    config: SketchConfig

    # -- construction -------------------------------------------------------

    @staticmethod
    def empty(
        config: SketchConfig,
        capacity: int,
        generator: Union[torch.Generator, int] = 0,
        window_slices: int = 1,
        device: Optional[torch.device] = None,
    ) -> "FleetSketch":
        """An all-zero stack whose hash family is the one
        ``GLavaSketch.empty(config, generator)`` draws: tenants of a fleet
        opened with seed s are bit-identical to ``GraphStream(seed=s)``."""
        row_hash, col_hash = GLavaSketch.hash_families(config, generator, device)
        t, k, d = capacity, max(1, window_slices), config.depth
        wr, wc = config.width_rows, config.width_cols
        return FleetSketch(
            torch.zeros((t, k, d, wr, wc), dtype=torch.float32, device=device),
            torch.zeros((t, k, d, wr), dtype=torch.float32, device=device),
            torch.zeros((t, k, d, wc), dtype=torch.float32, device=device),
            torch.zeros((t,), dtype=torch.int32, device=device),
            row_hash,
            col_hash,
            config,
        )

    @property
    def capacity(self) -> int:
        return self.counters.shape[0]

    @property
    def n_slices(self) -> int:
        return self.counters.shape[1]

    @property
    def device(self) -> torch.device:
        return self.counters.device

    def clone(self) -> "FleetSketch":
        """A copy with its own stack (hash families are immutable, shared)."""
        return dataclasses.replace(
            self,
            counters=self.counters.clone(),
            row_flows=self.row_flows.clone(),
            col_flows=self.col_flows.clone(),
            cursor=self.cursor.clone(),
        )

    # -- ingest (in place) -----------------------------------------------------

    def update_(
        self,
        slots: torch.Tensor,    # (B,) int — resident slot per edge
        src: torch.Tensor,      # (B,) uint32 keys in int64
        dst: torch.Tensor,      # (B,) uint32 keys in int64
        weights: torch.Tensor,  # (B,) float32
        backend: str = "auto",
    ) -> "FleetSketch":
        """Fold one mixed multi-tenant edge batch into the stack, in place:
        one stacked scatter (one kernel launch on the card) however many
        tenants the batch spans, a second for an undirected sketch's
        mirrored edges.  Each edge lands in its tenant's ACTIVE window slice
        (plane = slot·K + cursor[slot]), so the tenant axis rides in the
        scatter index."""
        t, k, d, w_r, w_c = self.counters.shape
        plane = slots if k == 1 else slots.long() * k + self.cursor[slots.long()]
        stack = (
            self.counters.view(t * k, d, w_r, w_c),
            self.row_flows.view(t * k, d, w_r),
            self.col_flows.view(t * k, d, w_c),
        )
        scatter_stacked_(*stack, plane, self.row_hash(src), self.col_hash(dst), weights, backend=backend)
        if not self.config.directed:
            scatter_stacked_(*stack, plane, self.row_hash(dst), self.col_hash(src), weights, backend=backend)
        return self

    # -- per-slot views / residency ops ----------------------------------------

    def tenant_sketch(self, slot: int) -> GLavaSketch:
        """One tenant's window-summed sketch as a plain ``GLavaSketch``, the
        view ``SlidingWindowSketch.window_sketch()`` serves.  For K=1 its
        tensors are views of the stack, not copies."""
        if self.n_slices == 1:
            counters, rf, cf = self.counters[slot, 0], self.row_flows[slot, 0], self.col_flows[slot, 0]
        else:
            counters = torch.sum(self.counters[slot], dim=0)
            rf, cf = torch.sum(self.row_flows[slot], dim=0), torch.sum(self.col_flows[slot], dim=0)
        return GLavaSketch(counters, self.row_hash, self.col_hash, self.config, rf, cf)

    def tenant_shard(self, slot: int) -> dict:
        """The tenant's evictable device state (window-resolved, per slice)
        as a checkpointable tree of views."""
        return {
            "counters": self.counters[slot],
            "row_flows": self.row_flows[slot],
            "col_flows": self.col_flows[slot],
            "cursor": self.cursor[slot],
        }

    def load_tenant_(self, slot: int, shard: dict) -> "FleetSketch":
        """Write a shard (tensors or host arrays) into slot ``slot``."""
        for name in ("counters", "row_flows", "col_flows", "cursor"):
            dst = getattr(self, name)[slot]
            dst.copy_(torch.as_tensor(shard[name]).to(dst.dtype))
        return self

    def clear_tenant_(self, slot: int) -> "FleetSketch":
        for name in ("counters", "row_flows", "col_flows", "cursor"):
            getattr(self, name)[slot].zero_()
        return self

    def advance_(self, slot: int) -> "FleetSketch":
        """Advance one tenant's window ring and zero the slice it wraps onto,
        as ``SlidingWindowSketch.advance_()`` does (reads the cursor back to
        the host: an advance waits for the device)."""
        nxt = (int(self.cursor[slot]) + 1) % self.n_slices
        self.cursor[slot] = nxt
        self.counters[slot, nxt].zero_()
        self.row_flows[slot, nxt].zero_()
        self.col_flows[slot, nxt].zero_()
        return self

    # -- functional forms (the reference's semantics) ----------------------------

    def update(self, slots, src, dst, weights, backend: str = "auto") -> "FleetSketch":
        return self.clone().update_(slots, src, dst, weights, backend=backend)

    def load_tenant(self, slot: int, shard: dict) -> "FleetSketch":
        return self.clone().load_tenant_(slot, shard)

    def clear_tenant(self, slot: int) -> "FleetSketch":
        return self.clone().clear_tenant_(slot)

    def advance(self, slot: int) -> "FleetSketch":
        return self.clone().advance_(slot)
