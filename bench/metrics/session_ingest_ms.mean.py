"""Host ms a batch in the program's ingest call before its tick: the
program's own ``ingest_s`` counter (``StreamStats`` of a session,
``FleetStats`` of a fleet) over the window's batches."""


def read(ctx):
    batches = ctx.after["batches"] - ctx.before["batches"]
    if batches <= 0:
        return None
    return (ctx.after["ingest_s"] - ctx.before["ingest_s"]) / batches * 1e3
