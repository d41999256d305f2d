"""Standing queries: registered continuous subscriptions over a stream.

Port of ``src/repro/api/subscription.py``; the compiled plan keeps its
fused key tensors on the session's device.

The paper's headline scenarios — cyber-security monitoring, DDoS
detection, transportation alarms — re-ask the SAME queries after every
edge batch.  This module makes that workload first-class (the gSketch
lesson: summaries serve a *known* query workload):

    sub = gs.subscribe(Query.reach("a", "b"), Query.in_flow("b"),
                       every=4, on_result=handle)
    ...
    gs.ingest(src, dst)            # every 4th mutation re-evaluates
    for event in sub.poll():       # or gs.events() across subscriptions
        print(event.tick, event.results)

A :class:`Subscription` owns the batch compiled ONCE by the planner
(:class:`~repro_torch.api.planner.CompiledPlan`) and a bounded event
queue; the session (:class:`~repro_torch.api.stream.GraphStream`) drives
re-evaluation after every ``every``-th mutation (ingest / delete /
advance_window / merge),
refreshing the reach family's cached transitive closure INCREMENTALLY
from the rows the mutations touched (``QueryEngine.refresh_closure``)
instead of re-squaring from scratch.
Each evaluation emits one timestamped :class:`SubscriptionEvent` carrying
the request-ordered (ε, δ)-annotated results — pushed to the subscription
queue, the session-wide ``gs.events()`` feed, and the ``on_result``
callback.  An optional ``alarm`` predicate turns a subscription into a
threshold monitor (``GraphStream.monitor`` is a thin wrapper over one).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, List, Optional, Tuple

from repro_torch.api.planner import CompiledPlan
from repro_torch.api.query import QueryBatch, QueryResult
from repro_torch.stream.events import EventFeed

# Events kept per subscription when nobody polls; past this the overflow
# policy applies (default drop_oldest — monitoring workloads care about
# the newest state) and ``events_dropped`` counts the loss.
DEFAULT_MAX_PENDING = 1024


def sub_progress_key(sub: "Subscription") -> str:
    """Stable identity for checkpointed subscription progress: named
    subscriptions match by name across a process restart; anonymous ones
    match by registration-order id (deterministic when the recovering
    process re-subscribes in the same order)."""
    return f"name:{sub.name}" if sub.name else f"id:{sub.id}"


@dataclasses.dataclass(frozen=True)
class SubscriptionEvent:
    """One re-evaluation of a standing query batch.

    ``tick`` counts this subscription's evaluations from 1; ``epoch`` is
    the session mutation epoch the results reflect; ``timestamp`` is the
    host wall-clock at evaluation.  ``results`` are request-ordered
    :class:`QueryResult`\\ s (the same objects a one-shot ``gs.query`` of
    the batch would return — bit-identical, property-tested).  ``alarm``
    is the subscription's predicate evaluated on the results, or ``None``
    when no predicate was registered."""

    subscription_id: int
    name: Optional[str]
    tick: int
    epoch: int
    timestamp: float
    results: Tuple[QueryResult, ...]
    alarm: Optional[bool] = None


class Subscription:
    """A registered continuous query batch (construct via
    ``GraphStream.subscribe``, not directly).

    The batch is compiled once; the session re-runs the compiled plan
    after every ``every``-th mutation and delivers events here.  ``poll()``
    drains pending events, ``cancel()`` deregisters (idempotent), and the
    object iterates over pending events (``for ev in sub: ...``)."""

    def __init__(
        self,
        stream,
        sub_id: int,
        batch: QueryBatch,
        every: int = 1,
        on_result: Optional[Callable[[SubscriptionEvent], None]] = None,
        alarm: Optional[Callable[[List[QueryResult]], bool]] = None,
        name: Optional[str] = None,
        max_pending: int = DEFAULT_MAX_PENDING,
        overflow: str = "drop_oldest",
    ):
        if len(batch) == 0:
            raise ValueError("a subscription needs at least one query")
        every = int(every)
        if every < 1:
            raise ValueError(f"every must be a positive mutation count, got {every}")
        self._stream = stream
        self.id = sub_id
        self.name = name
        self.batch = batch
        self.plan = CompiledPlan(batch, stream.device)
        self.every = every
        self.on_result = on_result
        self.alarm = alarm
        self.ticks = 0
        self.active = True
        self.last_event: Optional[SubscriptionEvent] = None
        self._mutations_pending = 0
        self._events = EventFeed(max_pending, overflow)
        # Exactly-once replay floor: events with tick <= _seen_tick were
        # already consumed before a crash and are deduplicated on re-emit.
        self._seen_tick = 0
        self.events_deduped = 0

    # -- event plane ---------------------------------------------------------

    def poll(self, max_events: Optional[int] = None) -> List[SubscriptionEvent]:
        """Drain (up to ``max_events``) pending events, oldest first."""
        return self._events.drain(max_events)

    def __iter__(self) -> Iterator[SubscriptionEvent]:
        while self._events:
            yield self._events.popleft()

    @property
    def pending(self) -> int:
        return len(self._events)

    @property
    def events_dropped(self) -> int:
        """Pending events lost to queue overflow (monotone counter; the
        explicit replacement for the old silent ``deque(maxlen)`` loss)."""
        return self._events.dropped

    def seek(self, tick: int) -> None:
        """Exactly-once consumption floor: after :meth:`GraphStream.recover`
        re-emits the replayed event stream, events with ``tick <=`` this
        value are deduplicated (they were delivered before the crash).
        Call with the last tick the consumer durably processed."""
        self._seen_tick = max(self._seen_tick, int(tick))

    def cancel(self) -> None:
        """Deregister: no further evaluations or events (idempotent)."""
        if self.active:
            self.active = False
            self._stream._unsubscribe(self)

    # -- session-side hooks --------------------------------------------------

    def _note_mutation(self) -> bool:
        """Count one session mutation; True when the subscription is due."""
        self._mutations_pending += 1
        return self._mutations_pending >= self.every

    def _deliver(self, event: SubscriptionEvent) -> bool:
        """Accept one evaluation.  Returns False when the event was
        deduplicated by the exactly-once floor (already consumed before a
        crash): progress counters still advance, but nothing is queued, no
        callback fires, and the session feed skips it too."""
        self._mutations_pending = 0
        self.ticks = event.tick
        if event.tick <= self._seen_tick:
            self.events_deduped += 1
            return False
        self.last_event = event
        self._events.push(event)
        if self.on_result is not None:
            self.on_result(event)
        return True

    def __repr__(self) -> str:  # pragma: no cover — debugging sugar
        tag = f" {self.name!r}" if self.name else ""
        return (
            f"<Subscription #{self.id}{tag} families={self.plan.families} "
            f"every={self.every} ticks={self.ticks} "
            f"{'active' if self.active else 'cancelled'}>"
        )
