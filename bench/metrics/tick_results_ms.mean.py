"""Host ms a tick blocked on its answers' host copies (the device's queries,
and a rebuilt closure before them): the program's ``tick.results`` spans
inside ``tick`` spans over those ticks, in the traced window."""
from bench.harness.program_spans import window


def read(ctx):
    records = window(ctx)
    if records is None:
        return None
    ticks = {r.id for r in records if r.name == "tick"}
    ms = [(r.end_ns - r.start_ns) / 1e6 for r in records if r.name == "tick.results" and r.parent in ticks]
    return sum(ms) / len(ticks) if ms else None
