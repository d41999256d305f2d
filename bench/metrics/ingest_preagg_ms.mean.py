"""Host ms a batch in ``preaggregate_host``, the host's collapse of a session's
batch into distinct (src, dst) pairs and their marginals: the program's
``ingest.preaggregate`` spans over its ``ingest`` calls in the traced
window."""
from bench.harness.program_spans import per_batch_ms


def read(ctx):
    return per_batch_ms(ctx, {"ingest.preaggregate"})
