"""Event-time stream plane: watermarks, WAL durability, backpressure.

Port of ``src/repro/stream``.  Everything here is host-side numpy and the
standard library, importable without touching a device:

- :mod:`repro_torch.stream.watermark` — per-source low-watermark tracking
  with bounded out-of-orderness and the slice arithmetic that maps event
  times onto the sliding-window ring;
- :mod:`repro_torch.stream.wal` — the append-only segmented write-ahead
  log, byte-compatible with the reference's;
- :mod:`repro_torch.stream.events` — the bounded event feed with an
  explicit overflow policy.
"""
from repro_torch.stream.events import OVERFLOW_POLICIES, EventFeed, EventOverflowError
from repro_torch.stream.wal import (
    OP_ADVANCE,
    OP_COMMIT,
    OP_EDGE,
    OP_MERGE,
    WAL_RECORD,
    AdvanceMutation,
    EdgeMutation,
    MergeMutation,
    WriteAheadLog,
)
from repro_torch.stream.watermark import WatermarkTracker, slice_of

__all__ = [
    "OVERFLOW_POLICIES",
    "EventFeed",
    "EventOverflowError",
    "OP_ADVANCE",
    "OP_COMMIT",
    "OP_EDGE",
    "OP_MERGE",
    "WAL_RECORD",
    "AdvanceMutation",
    "EdgeMutation",
    "MergeMutation",
    "WriteAheadLog",
    "WatermarkTracker",
    "slice_of",
]
