"""Sliding time-window sketches (paper Section 6.1.1 deletions).

Port of ``src/repro/core/window.py``.  A ring of K slice sketches sharing
one hash family: slice s covers one time slice, the window estimate is the
sum of the live slices (linearity), and expiry zeroes a whole slice in
O(d·w²) without replaying the stream.  Each slice carries its flow
registers, so the materialized window gets its registers by summing the
O(d·w) slice registers instead of re-reducing the counters.

The reference is functional; the port updates the ring IN PLACE through the
trailing-underscore methods (``update_``, ``update_at_``,
``update_preaggregated_``, ``advance_``), and the plain-named methods keep
the reference's meaning by working on a clone.  The slice an update
addresses is a :class:`~repro_torch.core.sketch.GLavaSketch` whose
``counters``/``row_flows``/``col_flows`` are VIEWS ``slices[slot]``,
``row_flows[slot]``, ``col_flows[slot]`` of the ring: each is contiguous and
its ``data_ptr()`` includes the slot's offset, so the ingest kernel scatters
straight into the ring and no slice is copied.

The template carries the hash family and the config.  Its counters and
registers are zero-stride views of one zero scalar, so it holds no
(d, w_r, w_c) buffer of its own; the checkpoint writes its counters as host
zeros, which is what the reference's file holds (``checkpoint/manager.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from repro_torch.core.sketch import GLavaSketch, SketchConfig


def _zeros_view(shape, device) -> torch.Tensor:
    """A read-only-in-practice zero tensor of ``shape`` that takes no memory."""
    return torch.zeros((), dtype=torch.float32, device=device).expand(shape)


@dataclasses.dataclass(eq=False)
class SlidingWindowSketch:
    """Ring buffer of K slice sketches sharing one hash family."""

    slices: torch.Tensor      # (K, d, w_r, w_c) float32
    current: int              # index of the active slice
    template: GLavaSketch     # hash family + config carrier (counters unused)
    row_flows: torch.Tensor   # (K, d, w_r) per-slice row registers
    col_flows: torch.Tensor   # (K, d, w_c) per-slice col registers

    @staticmethod
    def template_for(config: SketchConfig, row_hash, col_hash, device=None) -> GLavaSketch:
        """A hash-family carrier with zero-stride zero counters and registers."""
        d, wr, wc = config.depth, config.width_rows, config.width_cols
        return GLavaSketch(
            _zeros_view((d, wr, wc), device), row_hash, col_hash, config,
            _zeros_view((d, wr), device), _zeros_view((d, wc), device),
        )

    @staticmethod
    def empty(
        config: SketchConfig,
        n_slices: int,
        generator: Union[torch.Generator, int] = 0,
        device: Optional[torch.device] = None,
    ) -> "SlidingWindowSketch":
        """An all-zero ring whose hash family is the one
        ``GLavaSketch.empty(config, generator)`` draws."""
        row_hash, col_hash = GLavaSketch.hash_families(config, generator, device)
        d, wr, wc = config.depth, config.width_rows, config.width_cols
        return SlidingWindowSketch(
            torch.zeros((n_slices, d, wr, wc), dtype=torch.float32, device=device),
            0,
            SlidingWindowSketch.template_for(config, row_hash, col_hash, device),
            torch.zeros((n_slices, d, wr), dtype=torch.float32, device=device),
            torch.zeros((n_slices, d, wc), dtype=torch.float32, device=device),
        )

    @property
    def n_slices(self) -> int:
        return self.slices.shape[0]

    @property
    def config(self) -> SketchConfig:
        return self.template.config

    @property
    def device(self) -> torch.device:
        return self.slices.device

    def slice_at(self, slot: int) -> GLavaSketch:
        """Ring slot ``slot`` as a sketch whose tensors are views of the ring."""
        return dataclasses.replace(
            self.template,
            counters=self.slices[slot],
            row_flows=self.row_flows[slot],
            col_flows=self.col_flows[slot],
        )

    def clone(self) -> "SlidingWindowSketch":
        return dataclasses.replace(
            self,
            slices=self.slices.clone(),
            row_flows=self.row_flows.clone(),
            col_flows=self.col_flows.clone(),
        )

    def to(self, device: Optional[torch.device]) -> "SlidingWindowSketch":
        """A copy on ``device`` with its own ring."""
        row = self.template.row_hash.to(device)
        col = row if self.template.col_hash is self.template.row_hash else self.template.col_hash.to(device)
        return SlidingWindowSketch(
            self.slices.to(device, copy=True),
            self.current,
            SlidingWindowSketch.template_for(self.config, row, col, device),
            self.row_flows.to(device, copy=True),
            self.col_flows.to(device, copy=True),
        )

    # -- ingest (in place) -----------------------------------------------------

    def update_(self, src, dst, weights=None, backend: str = "auto") -> "SlidingWindowSketch":
        """Ingest into the active slice (counters AND its registers)."""
        self.slice_at(self.current).update_(src, dst, weights, backend=backend)
        return self

    def update_at_(self, slot: int, src, dst, weights=None, backend: str = "auto") -> "SlidingWindowSketch":
        """Event-time ingest: fold a batch into ring slot ``slot`` (any slot,
        not only the active one), where late-but-in-bound edges land."""
        if not 0 <= int(slot) < self.n_slices:
            raise ValueError(f"slot {slot} outside the ring of {self.n_slices}")
        self.slice_at(int(slot)).update_(src, dst, weights, backend=backend)
        return self

    def update_preaggregated_(self, *args, backend: str = "auto") -> "SlidingWindowSketch":
        """Host-collapsed ingest into the active slice (see
        :meth:`GLavaSketch.update_preaggregated_`)."""
        self.slice_at(self.current).update_preaggregated_(*args, backend=backend)
        return self

    def update_collapsed_(self, *args, **kwargs):
        """Raw ingest collapsed on the device into the active slice (see
        :meth:`GLavaSketch.update_collapsed_`); returns ``(self, touched)``."""
        _, touched = self.slice_at(self.current).update_collapsed_(*args, **kwargs)
        return self, touched

    def advance_(self) -> "SlidingWindowSketch":
        """Move to the next time slice, expiring the oldest: zero the slot
        the ring wraps onto, its counters and its registers."""
        nxt = (self.current + 1) % self.n_slices
        self.slices[nxt].zero_()
        self.row_flows[nxt].zero_()
        self.col_flows[nxt].zero_()
        self.current = nxt
        return self

    # -- functional forms (the reference's semantics) ----------------------------

    def update(self, src, dst, weights=None, backend: str = "auto") -> "SlidingWindowSketch":
        return self.clone().update_(src, dst, weights, backend=backend)

    def update_at(self, slot: int, src, dst, weights=None, backend: str = "auto") -> "SlidingWindowSketch":
        return self.clone().update_at_(slot, src, dst, weights, backend=backend)

    def update_preaggregated(self, *args, backend: str = "auto") -> "SlidingWindowSketch":
        return self.clone().update_preaggregated_(*args, backend=backend)

    def advance(self) -> "SlidingWindowSketch":
        return self.clone().advance_()

    def window_sketch(self) -> GLavaSketch:
        """Materialize the whole-window sketch, a new sketch holding the sum
        of the live slices; the registers are the summed slice registers
        (no counter reduction).  A ``torch.sum`` over the ring, as the
        reference's is a ``jnp.sum`` outside any kernel."""
        return dataclasses.replace(
            self.template,
            counters=torch.sum(self.slices, dim=0),
            row_flows=torch.sum(self.row_flows, dim=0),
            col_flows=torch.sum(self.col_flows, dim=0),
        )
