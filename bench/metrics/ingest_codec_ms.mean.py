"""Host ms a batch in the codec: both endpoint columns encoded, the weights
(and any timestamps) coerced: the program's ``ingest.codec`` spans over its
``ingest`` calls in the traced window."""
from bench.harness.program_spans import per_batch_ms


def read(ctx):
    return per_batch_ms(ctx, {"ingest.codec"})
