"""FleetIngestEngine — the fleet's one device dispatch per mixed batch.

Port of ``src/repro/fleet/ingest.py``.  A mixed arrival stream of
``(tenant_id, src, dst, weight)`` records is segment-grouped by resident
slot on the host (a stable sort, so each tenant's edges keep their arrival
order, which bit-identity with per-tenant sessions needs) and folded into
the whole ``(T, K, d, w_r, w_c)`` stack in place by ``FleetSketch.update_``:
the tenant axis rides in the scatter index, so T tenants cost ONE stacked
ingest launch per batch (two for an undirected sketch), counted by
:attr:`FleetIngestEngine.dispatches` and, on the card,
``kernels/ingest_stacked/ops.py::stacked_ingest.launches``.

The reference's power-of-two padding (``pad_grouped``) fed its jit cache;
the port has none, so batches go to the device at their own length.  In
flight: launches are asynchronous, and one CUDA event per dispatch bounds
how many may be outstanding, as ``GraphStream`` does.
"""
from __future__ import annotations

import collections
import functools

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.fleet.stack import FleetSketch


def group_stream(
    slots: np.ndarray,
    src: np.ndarray,
    dst: np.ndarray,
    weights: np.ndarray,
):
    """Segment-group a mixed arrival stream by tenant slot (the reference's
    ``group_stream``).

    Stable argsort on the slot lane: within a tenant the arrival order is
    preserved, so the grouped stream replayed through the stacked scatter is
    bit-identical to each tenant ingesting its own sub-stream.  Returns the
    grouped lanes plus ``(uniq_slots, starts, counts)`` segment descriptors
    for per-tenant bookkeeping."""
    order = np.argsort(slots, kind="stable")
    slots = slots[order]
    src, dst, weights = src[order], dst[order], weights[order]
    uniq, starts, counts = np.unique(slots, return_index=True, return_counts=True)
    return slots, src, dst, weights, uniq, starts, counts


class FleetIngestEngine:
    """Owns the fleet's update dispatch, its count and the in-flight bound.
    ``backend`` is an ingest backend name (``scatter``, ``cuda`` or
    ``auto``: the stacked kernel for a stack on a CUDA device)."""

    def __init__(self, backend: str = "auto", max_inflight: int = 2):
        self.backend = backend
        self.max_inflight = max_inflight
        self._inflight: collections.deque = collections.deque()
        self.dispatches = 0

    @classmethod
    def cost_probe(cls, *, tenants: int = 4, width: int = 64, depth: int = 2, batch: int = 64,
                   device="cpu", backend: str = "cuda"):
        """The cost plane's sizing hook (the reference's
        ``FleetIngestEngine.cost_probe``, ``src/repro/fleet/ingest.py:95``):
        :meth:`dispatch` of a mixed batch of B edges over T tenants into a
        new stack at (T, w, d).  Returns ``(fn, args, counters_shape)``."""
        from repro_torch.core.hashing import keys_to_tensor
        from repro_torch.core.sketch import SketchConfig

        cfg = SketchConfig(depth=depth, width_rows=width, width_cols=width)
        state = FleetSketch.empty(cfg, tenants, 0, device=torch.device(device))
        dev = state.device
        src = np.arange(batch, dtype=np.uint32)
        args = (
            torch.arange(batch, device=dev) % tenants, keys_to_tensor(src, dev),
            keys_to_tensor(src + np.uint32(batch), dev), torch.ones(batch, dtype=torch.float32, device=dev),
        )
        return functools.partial(cls(backend).dispatch, state), args, tuple(state.counters.shape)

    def dispatch(
        self,
        state: FleetSketch,
        slots: torch.Tensor,
        src: torch.Tensor,
        dst: torch.Tensor,
        weights: torch.Tensor,
    ) -> FleetSketch:
        """One in-place device dispatch for one grouped mixed batch; waits
        for the oldest dispatch past the in-flight bound."""
        state.update_(slots, src, dst, weights, backend=self.backend)
        self.dispatches += 1
        if state.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
            self._inflight.append(event)
            if len(self._inflight) > self.max_inflight:
                with telemetry.span("ingest.wait"):
                    while len(self._inflight) > self.max_inflight:
                        self._inflight.popleft().synchronize()
        return state

    def flush(self) -> bool:
        """Block until every dispatch has landed; True if any was pending."""
        pending = bool(self._inflight)
        while self._inflight:
            self._inflight.popleft().synchronize()
        return pending
