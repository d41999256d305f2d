"""The fleet's stacked ingest's share of its byte roofline in the window:
``stacked_bound_bytes`` of each window batch (its tenants as planes, its
buckets hashed by the reference's family) at the HBM peak, over the device
time of every stacked-ingest launch by kernel name."""
import torch

from bench.counts import ingest, peaks
from bench.harness.trace import kernel_s
from bench.reference import glava


def read(ctx):
    if ctx.ops is None or ctx.inputs.stream.tenant is None:
        return None
    seconds = kernel_s(ctx.ops, r"ingest_stacked_kernel")
    if not seconds:
        return None
    cfg, s = ctx.cell.config, ctx.inputs.stream
    d, w = cfg["depth"], cfg["width_rows"]
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    a, b = (x.to(dev) for x in glava.hash_family(ctx.seed, d))
    shape = (cfg["capacity"], d, w, w)
    total = 0
    for i in range(ctx.before["batches"], ctx.after["batches"]):
        span = s.span(i)
        plane = torch.from_numpy(s.tenant[span]).to(dev)
        rows = glava.buckets(torch.from_numpy(s.src[span].astype("int64")).to(dev), a, b, w)
        cols = glava.buckets(torch.from_numpy(s.dst[span].astype("int64")).to(dev), a, b, w)
        total += ingest.stacked_bound_bytes(shape, plane, rows, cols)
    return 100.0 * total / peaks.HBM_BYTES_PER_S / seconds
