"""The share of the traced window in which no operation ran on the device:
one minus the union of the device ops' intervals (kernels, copies, fills)
over the window."""
from bench.harness.trace import busy_s


def read(ctx):
    if not ctx.ops:
        return None
    window = (ctx.hi_ns - ctx.lo_ns) / 1e9
    return 100.0 * (1.0 - busy_s(ctx.ops, ctx.lo_ns, ctx.hi_ns) / window)
