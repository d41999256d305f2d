"""Host ms a batch in the padding and host-to-device copies of the batch's
arrays: the program's ``ingest.copy`` spans over its ``ingest`` calls in the
traced window."""
from bench.harness.program_spans import per_batch_ms


def read(ctx):
    return per_batch_ms(ctx, {"ingest.copy"})
