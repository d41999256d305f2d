"""Host ms a batch blocked on the device inside the program's ingest call:
its ``ingest.wait`` spans (the wait for the oldest batch past the in-flight
bound) and ``tick.wait`` spans (the flush before a tick) over its ``ingest``
calls in the traced window."""
from bench.harness.program_spans import per_batch_ms


def read(ctx):
    return per_batch_ms(ctx, {"ingest.wait", "tick.wait"})
