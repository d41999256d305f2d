"""Seconds from the process's start to the window's start: imports, the
kernels' build or load, the inputs drawn, the program opened and warmed up."""


def read(ctx):
    return ctx.setup_s
