"""Host ms a dashboard call (PageRank and the triangle mass, ending in both
results on the host): the harness's own span around each call in the
window."""


def read(ctx):
    ms = [(s.end_ns - s.start_ns) / 1e6 for s in ctx.spans if s.name == "dashboard call"]
    return sum(ms) / len(ms) if ms else None
