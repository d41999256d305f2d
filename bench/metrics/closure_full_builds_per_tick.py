"""Full closure builds a tick in the window: the program's build counter
(the session engine's ``closure_refreshes``, the fleet engine's
``closure_builds``, one a tenant) over its ticks."""


def read(ctx):
    ticks = ctx.after["ticks"] - ctx.before["ticks"]
    if ticks <= 0:
        return None
    return (ctx.after["full_builds"] - ctx.before["full_builds"]) / ticks
