"""Bounded event feeds with an explicit overflow policy.

Port of ``src/repro/stream/events.py`` (numpy-free, copied as it is).

``gs.events()`` and every :class:`~repro_torch.api.subscription.Subscription`
used to hold pending events in a bare ``deque(maxlen=...)`` — overflow
silently evicted the OLDEST pending event, so a slow consumer lost data
with no signal.  :class:`EventFeed` makes the loss explicit:

- ``drop_oldest`` (default, the old behavior) — evict the oldest pending
  event to make room, but count it in :attr:`dropped`;
- ``drop_newest`` — refuse the incoming event instead (keep the history a
  consumer is mid-way through draining), counted the same way;
- ``error`` — raise :class:`EventOverflowError`, surfacing backpressure
  to the producer (the ingest call that triggered the evaluation).

The counter is monotone and cheap to poll; monitoring loops should treat
``feed.dropped > 0`` as an alert that ``every=`` is too fine or polling
is too slow.
"""
from __future__ import annotations

import collections
from typing import Iterator, List, Optional

OVERFLOW_POLICIES = ("drop_oldest", "drop_newest", "error")


class EventOverflowError(RuntimeError):
    """A bounded event feed with ``policy="error"`` was pushed while full."""


class EventFeed:
    """A bounded FIFO of pending events with an explicit overflow policy."""

    def __init__(self, maxlen: int, policy: str = "drop_oldest"):
        if maxlen < 1:
            raise ValueError(f"maxlen must be >= 1, got {maxlen}")
        if policy not in OVERFLOW_POLICIES:
            raise ValueError(
                f"unknown overflow policy {policy!r} (want one of "
                f"{OVERFLOW_POLICIES})"
            )
        self.maxlen = int(maxlen)
        self.policy = policy
        self._events: collections.deque = collections.deque()
        self._dropped = 0

    @property
    def dropped(self) -> int:
        """Events lost to overflow since the feed was created (monotone)."""
        return self._dropped

    def push(self, event) -> None:
        """Enqueue ``event``, applying the overflow policy when full."""
        if len(self._events) >= self.maxlen:
            if self.policy == "drop_oldest":
                self._events.popleft()
                self._dropped += 1
            elif self.policy == "drop_newest":
                self._dropped += 1
                return
            else:
                raise EventOverflowError(
                    f"event feed full ({self.maxlen} pending, "
                    f"{self._dropped} previously dropped); drain poll()/"
                    f"events() or pick a drop_* overflow policy"
                )
        self._events.append(event)

    def popleft(self):
        return self._events.popleft()

    def drain(self, max_events: Optional[int] = None) -> List:
        """Pop up to ``max_events`` pending events, oldest first."""
        out: List = []
        while self._events and (max_events is None or len(out) < max_events):
            out.append(self._events.popleft())
        return out

    def __len__(self) -> int:
        return len(self._events)

    def __bool__(self) -> bool:
        return bool(self._events)

    def __iter__(self) -> Iterator:
        while self._events:
            yield self._events.popleft()

    def __repr__(self) -> str:  # pragma: no cover — debugging sugar
        return (
            f"<EventFeed pending={len(self._events)}/{self.maxlen} "
            f"policy={self.policy} dropped={self._dropped}>"
        )
