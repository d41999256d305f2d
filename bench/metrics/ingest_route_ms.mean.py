"""Host ms a batch in a fleet's routing: the tenant ids made unique, each
tenant's mask and WAL append, the slot lane and ``group_stream``: the
program's ``ingest.route`` spans over its ``ingest`` calls in the traced
window."""
from bench.harness.program_spans import per_batch_ms


def read(ctx):
    return per_batch_ms(ctx, {"ingest.route"})
