"""The share of the traced window in which the device is idle while the
host is in an ingest call's own work: its innermost open span is ``ingest``
or a child of it other than a wait or the tick (codec, pre-aggregation,
touched scan, routing, copies)."""
from bench.harness.program_spans import INGEST_HOST, idle_pct


def read(ctx):
    return idle_pct(ctx, lambda name: name in INGEST_HOST)
