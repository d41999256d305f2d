"""Host ms a standing-query tick, closure included: the program's own
``query_s`` over its ``subscription_ticks`` in the window."""


def read(ctx):
    ticks = ctx.after["ticks"] - ctx.before["ticks"]
    if ticks <= 0:
        return None
    return (ctx.after["query_s"] - ctx.before["query_s"]) / ticks * 1e3
