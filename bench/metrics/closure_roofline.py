"""B3's share of its int8 roofline in the window: the squarings the builds
needed (the window's full builds times the steps that changed the last
closure before its fixed point, as the reference counts them on this run's
summary; the fewest of the hot tenants'), each ``2 d w^3`` operations at
the int8 peak, over the device time of every B3 launch by kernel name."""
from bench.counts import closure
from bench.harness.trace import kernel_s


def read(ctx):
    if ctx.ops is None:
        return None
    seconds = kernel_s(ctx.ops, r"closure_step")
    builds = ctx.after["full_builds"] - ctx.before["full_builds"]
    steps = ctx.facts.get("closure_squarings") or {}
    if not seconds or builds <= 0 or not steps:
        return None
    cfg = ctx.cell.config
    need = builds * min(steps.values()) * closure.squaring_bound_s(cfg["depth"], cfg["width_rows"])
    return 100.0 * need / seconds
