"""Incremental closure refreshes a tick in the window: the program's
``tick.refresh`` spans (one a refresh dispatch: the incremental branch of a
session's ``QueryEngine.refresh_closure``, or a fleet's batched
``FleetQueryEngine._refresh``, which refreshes every stale tenant at once)
over its ``tick`` spans, in the traced window.  None untraced, and on a
program that records no ``tick.refresh`` span."""
from bench.harness.program_spans import window


def read(ctx):
    records = window(ctx)
    if records is None:
        return None
    from repro_torch import telemetry

    ticks = sum(r.name == "tick" for r in records)
    if not ticks or "tick.refresh" not in getattr(telemetry, "NAMES", ()):
        return None
    return sum(r.name == "tick.refresh" for r in records) / ticks
