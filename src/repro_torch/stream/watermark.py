"""Watermarks: bounded out-of-orderness for event-time ingest.

Port of ``src/repro/stream/watermark.py`` (pure numpy and stdlib, copied as
it is, so both packages derive the same advance schedule from the same
event times).

A *watermark* is the stream's low-water mark: the promise that no edge
with event time below it will be accepted any more.  We use the standard
bounded-lateness construction — each source's watermark trails the
maximum event time it has emitted by ``max_lateness``, and the session
watermark is the MINIMUM over sources (a slow source holds the whole
stream back, which is what makes the merge safe):

    W  =  min over sources ( max event time seen )  -  max_lateness

The watermark is monotone by construction (per-source maxima only grow,
and we clamp against the previous value so registering a new lagging
source can never move W backwards).  ``GraphStream`` advances the sliding
window whenever W crosses a slice boundary, routes late-but-in-bound
edges (event time >= W but behind the head slice) into their correct open
slice, and retracts or drops too-late edges (event time < W, or landing
below the live ring) via the turnstile-delete path — counted here in
``late_dropped`` / ``late_retracted``.

Host-side only: tracking is a tiny dict update per batch; the per-edge
work (slice routing) is vectorized numpy in the session.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np

#: Source key used when ``ingest`` is called without ``source=`` — a
#: single anonymous source, which degrades to plain per-stream lateness.
DEFAULT_SOURCE = 0


def slice_of(t: float, slice_width: float) -> int:
    """Absolute slice index of event time ``t``: floor(t / slice_width)."""
    return int(math.floor(t / slice_width))


def slices_of(ts: np.ndarray, slice_width: float) -> np.ndarray:
    """Vectorized :func:`slice_of` over an event-time column (int64)."""
    return np.floor_divide(ts, slice_width).astype(np.int64)


class WatermarkTracker:
    """Per-source low-watermark merge with bounded lateness.

    ``observe(source_key, t_max)`` folds one batch's maximum event time
    for one source and returns the (monotone) session watermark.  State is
    JSON-serializable via :meth:`state` / :meth:`from_state` so it rides
    in checkpoint metadata and WAL replay re-derives the identical
    advance schedule."""

    def __init__(self, max_lateness: float):
        if not (max_lateness >= 0.0) or not math.isfinite(max_lateness):
            raise ValueError(
                f"max_lateness must be finite and >= 0, got {max_lateness}"
            )
        self.max_lateness = float(max_lateness)
        self._sources: Dict[int, float] = {}
        self._watermark = -math.inf
        self.late_dropped = 0
        self.late_retracted = 0

    # -- observation ---------------------------------------------------------

    def observe(self, source_key: int, t_max: float) -> float:
        """Fold one batch's max event time for ``source_key``; returns the
        updated session watermark (monotone)."""
        if not math.isfinite(t_max):
            raise ValueError(f"event times must be finite, got max {t_max}")
        key = int(source_key)
        prev = self._sources.get(key, -math.inf)
        if t_max > prev:
            self._sources[key] = float(t_max)
        candidate = min(self._sources.values()) - self.max_lateness
        if candidate > self._watermark:
            self._watermark = candidate
        return self._watermark

    @property
    def watermark(self) -> float:
        """The current low watermark (-inf before the first observation)."""
        return self._watermark

    @property
    def sources(self) -> Dict[int, float]:
        """Per-source max event times (copy; keys are uint32 source keys)."""
        return dict(self._sources)

    # -- persistence ---------------------------------------------------------

    def state(self) -> dict:
        """JSON-safe snapshot for checkpoint metadata."""
        return {
            "max_lateness": self.max_lateness,
            "sources": {str(k): v for k, v in self._sources.items()},
            "watermark": None if self._watermark == -math.inf else self._watermark,
            "late_dropped": self.late_dropped,
            "late_retracted": self.late_retracted,
        }

    @classmethod
    def from_state(cls, state: Optional[dict]) -> "WatermarkTracker":
        tracker = cls(float(state["max_lateness"]))
        tracker._sources = {int(k): float(v) for k, v in state["sources"].items()}
        wm = state.get("watermark")
        tracker._watermark = -math.inf if wm is None else float(wm)
        tracker.late_dropped = int(state.get("late_dropped", 0))
        tracker.late_retracted = int(state.get("late_retracted", 0))
        return tracker

    def __repr__(self) -> str:  # pragma: no cover — debugging sugar
        wm = "-inf" if self._watermark == -math.inf else f"{self._watermark:g}"
        return (
            f"<WatermarkTracker W={wm} lateness={self.max_lateness:g} "
            f"sources={len(self._sources)} late_dropped={self.late_dropped} "
            f"late_retracted={self.late_retracted}>"
        )
