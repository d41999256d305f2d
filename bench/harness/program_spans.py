"""The program's own spans in a traced window (``repro_torch.telemetry``),
for the metrics that read them.

The port records a span only while a profiler runs, so only a ``--trace 1``
window has them; a program without ``repro_torch.telemetry`` has none.
Either way, and where the program's ring of records lost part of the window,
the readers here return ``None``.  Spans and device ops share one clock
(``time.time_ns``), so the host's innermost open span at an idle instant of
the device names what the host was doing then."""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

from bench.harness.trace import busy_intervals

# The ingest call's host work: the call's own time and every child but its
# waits and its tick.
INGEST_HOST = frozenset({"ingest", "ingest.codec", "ingest.preaggregate", "ingest.touched", "ingest.route",
                         "ingest.copy"})


def window(ctx) -> Optional[list]:
    """The records that start in the window, by start; None where the
    program keeps none or some of the window's records were dropped (the
    earliest record kept closed after the window opened)."""
    try:
        from repro_torch import telemetry
    except ImportError:
        return None
    records = telemetry.spans(ctx.lo_ns, ctx.hi_ns)
    if telemetry.dropped():
        kept = telemetry.spans(0, ctx.hi_ns)
        if not kept or min(r.end_ns for r in kept) > ctx.lo_ns:
            return None
    return records


def per_batch_ms(ctx, names) -> Optional[float]:
    """Milliseconds of the spans named in ``names`` a batch: their summed
    length over the window's ``ingest`` calls; None without such a span."""
    records = window(ctx)
    if records is None:
        return None
    batches = sum(r.name == "ingest" and r.parent == -1 for r in records)
    hits = [r for r in records if r.name in names]
    if not batches or not hits:
        return None
    return sum(r.end_ns - r.start_ns for r in hits) / batches / 1e6


def innermost(records, lo: int, hi: int) -> List[Tuple[int, int, Optional[str]]]:
    """``[lo, hi]`` cut into ``(start, end, name)`` pieces, ``name`` the
    innermost span open over the piece (None where none is).  Spans nest on
    the one thread that records them, so the innermost is the open span
    that started last (a parent opens first at a shared instant)."""
    pieces: List[Tuple[int, int, Optional[str]]] = []
    cursor, stack = lo, []

    def emit(end, name):
        nonlocal cursor
        end = min(max(end, lo), hi)
        if end > cursor:
            pieces.append((cursor, end, name))
            cursor = end

    for r in sorted(records, key=lambda r: (r.start_ns, -r.end_ns, r.id)):
        while stack and stack[-1].end_ns <= r.start_ns:
            top = stack.pop()
            emit(top.end_ns, top.name)
        emit(r.start_ns, stack[-1].name if stack else None)
        stack.append(r)
    while stack:
        top = stack.pop()
        emit(top.end_ns, top.name)
    emit(hi, None)
    return pieces


def idle_pct(ctx, where: Callable[[Optional[str]], bool]) -> Optional[float]:
    """Percent of the window in which the device is idle (no op's interval
    covers it) while the host's innermost open span has a name ``where``
    accepts (None: no span open).  None untraced or without spans."""
    if not ctx.ops:
        return None
    records = window(ctx)
    if not records:
        return None
    lo, hi = ctx.lo_ns, ctx.hi_ns
    idle, cursor = [], lo
    for s, e in busy_intervals(ctx.ops, lo, hi) + [(hi, hi)]:
        if s > cursor:
            idle.append((cursor, s))
        cursor = max(cursor, e)
    total, i = 0, 0
    for s, e, name in innermost(records, lo, hi):
        if not where(name):
            continue
        while i < len(idle) and idle[i][1] <= s:
            i += 1
        j = i
        while j < len(idle) and idle[j][0] < e:
            total += min(e, idle[j][1]) - max(s, idle[j][0])
            j += 1
    return 100.0 * total / (hi - lo)
