"""Host-side stream machinery (port of ``src/repro/stream``; so far only the
bounded event feed — watermarks and the WAL wait for ROADMAP item A7)."""
from repro_torch.stream.events import OVERFLOW_POLICIES, EventFeed, EventOverflowError

__all__ = ["OVERFLOW_POLICIES", "EventFeed", "EventOverflowError"]
