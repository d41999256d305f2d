"""B1's share of its byte roofline in the window (the key entry a session
launches once a batch): ``key_bound_bytes`` of each window batch's distinct
(src, dst) pairs at the HBM peak, over the device time of every B1 launch
by kernel name."""
import torch

from bench.counts import ingest, peaks
from bench.harness.trace import kernel_s


def read(ctx):
    if ctx.ops is None:
        return None
    seconds = kernel_s(ctx.ops, r"\bingest_kernel\b")
    if not seconds:
        return None
    cfg, s = ctx.cell.config, ctx.inputs.stream
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    total = 0
    for i in range(ctx.before["batches"], ctx.after["batches"]):
        span = s.span(i)
        pairs = ingest.distinct_pairs(torch.from_numpy(s.src[span].astype("int64")).to(dev),
                                      torch.from_numpy(s.dst[span].astype("int64")).to(dev))
        total += ingest.key_bound_bytes(cfg["depth"], pairs, pairs, mirror=not cfg["directed"])
    return 100.0 * total / peaks.HBM_BYTES_PER_S / seconds
