"""The port's spans: where a call's host time goes, on the device trace's
clock.

A span names one stretch of host work inside a call::

    from repro_torch import telemetry

    with telemetry.span("ingest") as call:
        with telemetry.span("ingest.codec"):
            ...
        call.tag(epoch)        # the id every span of this call shares

Spans record only while a ``torch.profiler`` session runs: ``span`` reads
the profiler's enabled flag, which ``profile.start()`` sets whatever its
activities.  Off, a span is one shared do-nothing object: it reads no clock,
allocates nothing and records nothing.  On, each span appends one record to
a process-wide ring of ``RING_SIZE`` records when it closes, the oldest
dropping off (and counted, :func:`dropped`) past that.  Read a profiled
window's records with :func:`spans`::

    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    lo = telemetry.now_ns()
    ...                                   # the window
    hi = telemetry.now_ns()
    prof.stop()
    for r in telemetry.spans(lo, hi):     # name, id, parent, trace, start_ns, end_ns
        ...

Times are ``time.time_ns()`` (:func:`now_ns`), the clock of kineto's device
events, so a record lies on the device timeline as it is.  ``parent`` is the
id of the span open around it on the same thread (-1 for a call's root);
``trace`` is the id the root was tagged with (its own id untagged), shared
by every span of the call and set when the root closes.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import List, NamedTuple

import torch.autograd.profiler as _profiler

RING_SIZE = 65536

# Every name the program gives a span: a reader of a name not here reads
# nothing, since the program it runs on does not record it.
NAMES = frozenset({
    "ingest", "ingest.codec", "ingest.preaggregate", "ingest.touched", "ingest.route", "ingest.copy",
    "ingest.wait", "tick", "tick.wait", "tick.results", "tick.refresh", "analytics.pagerank",
    "analytics.triangles",
})

# The program's one clock: its counters' seconds and the spans' times.
now_ns = time.time_ns
_clock = time.time_ns  # what a span reads; a name of its own so a test can watch it

_ring: collections.deque = collections.deque(maxlen=RING_SIZE)
_dropped = 0
_lock = threading.Lock()
_ids = itertools.count()
_local = threading.local()


class SpanRecord(NamedTuple):
    name: str
    id: int
    parent: int
    trace: int
    start_ns: int
    end_ns: int


class _Span:
    __slots__ = ("name", "id", "parent", "trace", "start_ns", "end_ns", "_call")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "_Span":
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.id = next(_ids)
        if stack:
            self.parent = stack[-1].id
            self.trace = stack[0].trace
            self._call = stack[0]._call
            self._call.append(self)
        else:
            self.parent = -1
            self.trace = self.id
            self._call = [self]
        stack.append(self)
        self.start_ns = _clock()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        global _dropped
        self.end_ns = _clock()
        _local.stack.pop()
        with _lock:
            if len(_ring) == _ring.maxlen:
                _dropped += 1
            _ring.append(self)
        if self.parent == -1:
            for s in self._call:
                s.trace = self.trace
        self._call = None
        return False

    def tag(self, trace: int) -> None:
        """Give every span of this call the id ``trace``."""
        self._call[0].trace = trace


class _Off:
    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    def tag(self, trace: int) -> None:
        pass


_OFF = _Off()


def span(name: str):
    """A span named ``name`` around a ``with`` block; the shared do-nothing
    span unless a profiler session is running."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def spans(lo_ns: int, hi_ns: int) -> List[SpanRecord]:
    """The kept records that start in ``[lo_ns, hi_ns)``, by start."""
    with _lock:
        kept = list(_ring)
    out = [SpanRecord(s.name, s.id, s.parent, s.trace, s.start_ns, s.end_ns)
           for s in kept if lo_ns <= s.start_ns < hi_ns]
    return sorted(out, key=lambda r: (r.start_ns, r.id))


def dropped() -> int:
    """Records dropped off the full ring since the process started."""
    return _dropped
