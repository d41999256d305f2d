"""The share of the traced window in which the device is idle while no span
of the program is open: the idle time the program's spans leave unnamed."""
from bench.harness.program_spans import idle_pct


def read(ctx):
    return idle_pct(ctx, lambda name: name is None)
