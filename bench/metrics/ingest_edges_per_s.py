"""Edges acknowledged in the window (handed to the program's ingest call,
which returned) over the window's seconds, the window closed by a
``torch.cuda.synchronize()``."""


def read(ctx):
    return (ctx.after["edges"] - ctx.before["edges"]) / ctx.window_s
