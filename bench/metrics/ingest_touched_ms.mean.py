"""Host ms a batch in the touched-key scan (a session's unique sources, a
fleet's ``touched_row_keys`` a tenant): the program's ``ingest.touched``
spans over its ``ingest`` calls in the traced window."""
from bench.harness.program_spans import per_batch_ms


def read(ctx):
    return per_batch_ms(ctx, {"ingest.touched"})
