#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc``
per source, all at once) and holds each kernel against its plain PyTorch
version on the card at the BASE shapes (``configs/glava.py``: d=5,
8192 x 8192 counters): the ingest scatter, the fused multi-query, the closure
step, the one-pass fused ingest (B=50,000 with inert and weight-0 slots; also
timed on serve BASE's zipf-skewed first batch), the
per-sketch edge-query gather (Q=1,024 and 65,536) and the flow reductions.
Each is timed with CUDA events and the profiler beside its plain version and
one PyTorch library call where there is one.

Then it drives the main paths, each with the launch counts set to 0 just
before and read just after:

- serve BASE: ``repro_torch.launch.serve`` at BASE with the serve entry
  point's own traffic, on the kernels and on the plain backends; the two
  runs must agree bit for bit (counters, registers, transcript);
- fused serve BASE: the same traffic through a fused session
  (``ingest_backend="fused"`` on the parsed arguments), which must equal
  both runs above and launch the fused kernel once per batch;
- the ops entry points on the fused session's live sketch:
  ``kernels/flow/ops.py::node_in_flow``/``node_out_flow`` (the flow kernel)
  against the session's registers, and ``kernels/query/ops.py::
  edge_query_cells`` against the fused multi-query;
- serve incremental, plain and fused: small batches, so the closure refreshes
  incrementally (from touched keys, and from the fused kernel's bitmap);
  each must equal the plain-backend run.

Output: the card's name and power limit as ``nvidia-smi`` reports them, the
build log, one line per phase, one JSON line listing every kernel (launches
on its main path, error against the plain version, times and bound), and
last the line ``{"ok": true, "device": {...}}``.  Any failure raises and
exits nonzero; so does a machine without CUDA or a directory without the
package.  Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s and
# bf16 tensor-core FLOP/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12

BASE_DEPTH, BASE_WIDTH = 5, 8192
INGEST_BATCH = 50_000
SERVE_BASE = [
    "--depth", "5", "--width", "8192", "--nodes", "100000",
    "--edges", "500000", "--batch", "50000", "--every", "5",
]
# Batches small enough that every tick after the first refreshes the
# closure incrementally (touched rows < 25% of 8192).
SERVE_INCREMENTAL = [
    "--depth", "5", "--width", "8192", "--nodes", "100000",
    "--edges", "2000", "--batch", "200", "--every", "1",
]
PLAIN_BACKENDS = ["--ingest-backend", "scatter", "--query-backend", "torch"]


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls, after one warm-up,
    between two CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, kernel: str):
    """Mean device milliseconds per call of the CUDA kernel whose name holds
    ``kernel``, from the profiler's CUPTI trace (the events above also count
    the host's launch overhead whenever it exceeds the kernel); ``None``
    when the trace shows no such kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(
        getattr(e, "device_time_total", 0.0) for e in prof.key_averages() if kernel in e.key
    )
    return total_us / reps / 1e3 if total_us else None


def _fmt(ms) -> str:
    return "not in the trace" if ms is None else f"{ms:.4f} ms"


def phase_ingest(torch, gen):
    from repro_torch.kernels.ingest.ops import ingest_scatter
    from repro_torch.kernels.ingest.ref import ingest_scatter_ref

    d, w, b = BASE_DEPTH, BASE_WIDTH, INGEST_BATCH
    base = torch.randint(0, 1000, (d, w, w), generator=gen, device="cuda").float()
    rows = torch.randint(0, w, (d, b), generator=gen, device="cuda", dtype=torch.int32)
    rows[torch.rand((d, b), generator=gen, device="cuda") < 0.1] = -1  # inert slots
    cols = torch.randint(0, w, (d, b), generator=gen, device="cuda", dtype=torch.int32)
    wts = torch.randint(1, 9, (b,), generator=gen, device="cuda").float()
    got = ingest_scatter(base.clone(), rows, cols, wts)
    want = ingest_scatter_ref(base.clone(), rows, cols, wts)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(torch.equal(got, want), f"ingest kernel differs from its plain version (max err {err})")
    del want
    ms = time_ms(lambda: ingest_scatter(got, rows, cols, wts), 20)
    dev_ms = device_ms(lambda: ingest_scatter(got, rows, cols, wts), 20, "ingest_scatter_kernel")
    plain_ms = time_ms(lambda: ingest_scatter_ref(got, rows, cols, wts), 20)
    valid = rows >= 0
    d_idx = torch.arange(d, device="cuda")[:, None].expand(d, b)[valid]
    idx = (d_idx, rows.long()[valid], cols.long()[valid])
    vals = wts[None, :].expand(d, b)[valid]
    library_ms = time_ms(lambda: got.index_put_(idx, vals, accumulate=True), 20)
    n_valid = int(valid.sum())
    # Each valid slot reads and writes one 32-byte sector of counters; the
    # row and column indices and the weights are read once.
    bound_bytes = n_valid * 64 + d * b * 8 + b * 4
    print(
        f"[chip_smoke] ingest d={d} w={w} B={b} ({n_valid} valid slots): bit-equal; "
        f"kernel {ms:.4f} ms (device {_fmt(dev_ms)}), plain {plain_ms:.4f} ms, "
        f"index_put_ {library_ms:.4f} ms"
    )
    return dict(
        name="ingest_scatter", route="cuda", source="src/repro_torch/csrc/ingest.cu",
        replaces="src/repro/kernels/ingest/kernel.py:59", max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=bound_bytes / PEAK_BYTES_PER_S * 1e3,
        bound_by="bytes", library_ms=library_ms,
    )


def phase_query(torch, gen):
    from repro_torch.configs.glava import QUERY_64K
    from repro_torch.kernels.query.ops import edge_query_min
    from repro_torch.kernels.query.ref import edge_query_min_ref

    d, w = BASE_DEPTH, BASE_WIDTH
    counters = torch.randint(0, 1000, (d, w, w), generator=gen, device="cuda").float()
    flat = counters.view(d, -1)
    out = None
    for q in (1024, QUERY_64K):
        rows = torch.randint(0, w, (d, q), generator=gen, device="cuda", dtype=torch.int32)
        cols = torch.randint(0, w, (d, q), generator=gen, device="cuda", dtype=torch.int32)
        got = edge_query_min(counters, rows, cols)
        want = edge_query_min_ref(counters, rows, cols)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(torch.equal(got, want), f"query kernel differs at Q={q} (max err {err})")
        ms = time_ms(lambda: edge_query_min(counters, rows, cols), 50)
        dev_ms = device_ms(lambda: edge_query_min(counters, rows, cols), 50, "multi_query_min_kernel")
        plain_ms = time_ms(lambda: edge_query_min_ref(counters, rows, cols), 50)
        cell = rows.long() * w + cols.long()
        library_ms = time_ms(lambda: flat.gather(1, cell).amin(dim=0), 50)
        # One 32-byte sector per (sketch, query), the indices, the output.
        bound_bytes = d * q * (32 + 8) + q * 4
        print(
            f"[chip_smoke] query d={d} w={w} Q={q}: bit-equal; kernel {ms:.4f} ms "
            f"(device {_fmt(dev_ms)}), plain {plain_ms:.4f} ms, gather+amin {library_ms:.4f} ms"
        )
        if q == 1024:  # the serve workload's edge family: the main-path shape
            out = dict(
                name="edge_query_min", route="cuda", source="src/repro_torch/csrc/query.cu",
                replaces="src/repro/kernels/query/kernel.py:99", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_bytes / PEAK_BYTES_PER_S * 1e3,
                bound_by="bytes", library_ms=library_ms,
            )
    return out


def phase_closure(torch, gen):
    from repro_torch.kernels.closure.ops import closure_step
    from repro_torch.kernels.closure.ref import closure_step_ref

    d, w = BASE_DEPTH, BASE_WIDTH
    # Density 0.005 leaves about a fifth of A @ A nonzero: both outcomes occur.
    a = (torch.rand((d, w, w), generator=gen, device="cuda") < 0.005).float()
    got = closure_step(a)
    want = closure_step_ref(a)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(torch.equal(got, want), f"closure kernel differs from its plain version (max err {err})")
    ones = float(got.mean())
    del want
    buf = torch.empty_like(a)
    ms = time_ms(lambda: closure_step(a, out=buf), 5)
    dev_ms = device_ms(lambda: closure_step(a, out=buf), 3, "closure_step_kernel")
    plain_ms = time_ms(lambda: closure_step_ref(a), 3)
    a16 = a.to(torch.bfloat16)
    library_ms = time_ms(lambda: torch.matmul(a16, a16), 5)
    flops = d * 2 * w**3
    bound_bytes = 2 * d * w * w * 4
    bound_ms = max(flops / PEAK_BF16_FLOPS, bound_bytes / PEAK_BYTES_PER_S) * 1e3
    print(
        f"[chip_smoke] closure step d={d} w={w} (output {ones:.3f} ones): bit-equal; "
        f"kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s; device {_fmt(dev_ms)}), "
        f"plain {plain_ms:.3f} ms, "
        f"bf16 matmul {library_ms:.3f} ms"
    )
    return dict(
        name="closure_step", route="cuda", source="src/repro_torch/csrc/closure.cu",
        replaces="src/repro/kernels/closure/kernel.py:42", max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by="operations" if flops / PEAK_BF16_FLOPS > bound_bytes / PEAK_BYTES_PER_S else "bytes",
        library_ms=library_ms,
    )


def phase_fused_ingest(torch, gen):
    from repro_torch.kernels.ingest_fused.ops import fused_ingest
    from repro_torch.kernels.ingest_fused.ref import fused_ingest_ref

    d, w, b = BASE_DEPTH, BASE_WIDTH, INGEST_BATCH
    state = (
        torch.randint(0, 1000, (d, w, w), generator=gen, device="cuda").float(),
        torch.randint(0, 1000, (d, w), generator=gen, device="cuda").float(),
        torch.randint(0, 1000, (d, w), generator=gen, device="cuda").float(),
    )
    rows = torch.randint(0, w, (d, b), generator=gen, device="cuda", dtype=torch.int32)
    rows[torch.rand((d, b), generator=gen, device="cuda") < 0.1] = -1  # inert slots
    cols = torch.randint(0, w, (d, b), generator=gen, device="cuda", dtype=torch.int32)
    wts = torch.randint(1, 9, (b,), generator=gen, device="cuda").float()
    wts[torch.rand((b,), generator=gen, device="cuda") < 0.05] = 0.0  # valid, weight 0
    got = fused_ingest(*(t.clone() for t in state), rows, cols, wts)
    want = fused_ingest_ref(*state, rows, cols, wts)
    torch.cuda.synchronize()
    err = max(float((g.float() - x.float()).abs().max()) for g, x in zip(got, want))
    for name, g, x in zip(("counters", "row_flows", "col_flows", "touched"), got, want):
        check(torch.equal(g, x), f"fused ingest kernel: {name} differs from its plain version (max err {err})")
    del want
    counters, rf, cf, _ = got
    ms = time_ms(lambda: fused_ingest(counters, rf, cf, rows, cols, wts), 20)
    dev_ms = device_ms(lambda: fused_ingest(counters, rf, cf, rows, cols, wts), 20, "fused_ingest_kernel")
    plain_ms = time_ms(lambda: fused_ingest_ref(counters, rf, cf, rows, cols, wts), 20)
    # Bytes this batch needs: a 32-byte sector read and written for every
    # distinct counter and register sector its weighted valid slots add
    # into, the bitmap written once, the indices and weights read once.
    valid = rows >= 0
    adds = valid & (wts != 0)[None, :]
    i_idx = torch.arange(d, device="cuda")[:, None].expand(d, b)
    r, c, i = rows.long()[adds], cols.long()[adds], i_idx[adds]
    sectors = sum(
        int(torch.unique(flat // 8).numel())
        for flat in ((i * w + r) * w + c, i * w + r, i * w + c)
    )
    bound_bytes = sectors * 64 + d * w + d * b * 8 + b * 4
    zipf_ms, uniform_ms, n_pairs = fused_ingest_under_skew(torch, counters, rf, cf)
    print(
        f"[chip_smoke] fused ingest on serve BASE's first batch ({n_pairs} pre-aggregated pairs, "
        f"zipf a=1.2 sources): device {_fmt(zipf_ms)}; the same slots with uniform rows: "
        f"device {_fmt(uniform_ms)}"
    )
    print(
        f"[chip_smoke] fused ingest d={d} w={w} B={b} ({int(valid.sum())} valid slots, "
        f"{int(adds.sum())} weighted): all four outputs bit-equal; kernel {ms:.4f} ms "
        f"(device {_fmt(dev_ms)}), plain {plain_ms:.4f} ms; no single library call "
        f"updates counters, both registers and the bitmap (library_ms null)"
    )
    return dict(
        name="fused_ingest", route="cuda", source="src/repro_torch/csrc/ingest_fused.cu",
        replaces="src/repro/kernels/ingest_fused/kernel.py:98", max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=bound_bytes / PEAK_BYTES_PER_S * 1e3,
        bound_by="bytes", library_ms=None,
    )


def fused_ingest_under_skew(torch, counters, rf, cf):
    """Device ms of the fused kernel on serve BASE's first batch as a fused
    session hashes it (zipf sources, so many slots add into one row_flows
    address), and on the same slots with uniformly drawn rows; and the
    batch's pair count."""
    import numpy as np

    from repro_torch.core.hashing import keys_to_tensor, make_hash_family
    from repro_torch.core.ingest import pad_bucket, preaggregate_host
    from repro_torch.data.graphs import edge_stream
    from repro_torch.kernels.ingest_fused.ops import fused_ingest

    data = edge_stream(100_000, INGEST_BATCH, np.random.default_rng(0), zipf_a=1.2)
    pre = preaggregate_host(data["src"], data["dst"], data["weight"])
    # The square BASE session's one family, drawn as GraphStream seed 0 draws it.
    family = make_hash_family(torch.Generator().manual_seed(0), BASE_DEPTH, BASE_WIDTH, "cuda")
    rows = family(keys_to_tensor(pad_bucket(pre.src), "cuda"))
    cols = family(keys_to_tensor(pad_bucket(pre.dst), "cuda"))
    wts = torch.from_numpy(pad_bucket(pre.weights)).cuda()
    uniform = torch.randint_like(rows, 0, BASE_WIDTH)
    zipf_ms = device_ms(lambda: fused_ingest(counters, rf, cf, rows, cols, wts), 20, "fused_ingest_kernel")
    uniform_ms = device_ms(lambda: fused_ingest(counters, rf, cf, uniform, cols, wts), 20, "fused_ingest_kernel")
    return zipf_ms, uniform_ms, pre.n_pairs


def phase_query_cells(torch, gen):
    from repro_torch.configs.glava import QUERY_64K
    from repro_torch.kernels.query.ops import edge_query_cells
    from repro_torch.kernels.query.ref import edge_query_cells_ref

    d, w = BASE_DEPTH, BASE_WIDTH
    counters = torch.randint(0, 1000, (d, w, w), generator=gen, device="cuda").float()
    flat = counters.view(d, -1)
    out = None
    for q in (1024, QUERY_64K):
        rows = torch.randint(0, w, (d, q), generator=gen, device="cuda", dtype=torch.int32)
        cols = torch.randint(0, w, (d, q), generator=gen, device="cuda", dtype=torch.int32)
        got = edge_query_cells(counters, rows, cols)
        want = edge_query_cells_ref(counters, rows, cols)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(torch.equal(got, want), f"query cells kernel differs at Q={q} (max err {err})")
        ms = time_ms(lambda: edge_query_cells(counters, rows, cols), 50)
        dev_ms = device_ms(lambda: edge_query_cells(counters, rows, cols), 50, "query_cells_kernel")
        plain_ms = time_ms(lambda: edge_query_cells_ref(counters, rows, cols), 50)
        cell = rows.long() * w + cols.long()
        library_ms = time_ms(lambda: flat.gather(1, cell), 50)
        # One 32-byte sector per (sketch, query), the indices, the output.
        bound_bytes = d * q * (32 + 8 + 4)
        print(
            f"[chip_smoke] query cells d={d} w={w} Q={q}: bit-equal; kernel {ms:.4f} ms "
            f"(device {_fmt(dev_ms)}), plain {plain_ms:.4f} ms, gather {library_ms:.4f} ms"
        )
        if q == 1024:  # the ops-entry check's shape
            out = dict(
                name="edge_query_cells", route="cuda", source="src/repro_torch/csrc/query.cu",
                replaces="src/repro/kernels/query/kernel.py:122", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_bytes / PEAK_BYTES_PER_S * 1e3,
                bound_by="bytes", library_ms=library_ms,
            )
    return out


def phase_flows(torch, gen):
    from repro_torch.kernels.flow.ops import flows
    from repro_torch.kernels.flow.ref import flows_ref

    d, w = BASE_DEPTH, BASE_WIDTH
    # Cells below 2^24 / 8192 = 2048 keep every sum exact in any order.
    counters = torch.randint(0, 1000, (d, w, w), generator=gen, device="cuda").float()
    rs, cs = flows(counters)
    want_rs, want_cs = flows_ref(counters)
    torch.cuda.synchronize()
    err = max(float((rs - want_rs).abs().max()), float((cs - want_cs).abs().max()))
    check(torch.equal(rs, want_rs) and torch.equal(cs, want_cs),
          f"flows kernel differs from its plain version (max err {err})")
    ms = time_ms(lambda: flows(counters), 20)
    dev_ms = device_ms(lambda: flows(counters), 20, "flows_kernel")
    plain_ms = time_ms(lambda: flows_ref(counters), 20)
    library_ms = time_ms(lambda: (counters.sum(2), counters.sum(1)), 20)
    # One read of the counters, one write of both outputs.
    bound_bytes = d * w * w * 4 + 2 * d * w * 4
    print(
        f"[chip_smoke] flows d={d} w={w}: bit-equal; kernel {ms:.4f} ms (device {_fmt(dev_ms)}, "
        f"{d * w * w * 4 / ms / 1e9:.2f} TB/s by the wrapper's time), plain {plain_ms:.4f} ms, "
        f"sum(2)+sum(1) {library_ms:.4f} ms"
    )
    return dict(
        name="flows", route="cuda", source="src/repro_torch/csrc/flow.cu",
        replaces="src/repro/kernels/flow/kernel.py:39", max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=bound_bytes / PEAK_BYTES_PER_S * 1e3,
        bound_by="bytes", library_ms=library_ms,
    )


def countsketch_bound(depth: int = 5, width: int = 16_384) -> None:
    """Print the bound of the one TPU kernel still to port,
    ``src/repro/kernels/countsketch/kernel.py:47`` ``countsketch_pallas``, at
    ``train/compression.py``'s defaults: per gradient element it reads the
    value (4 bytes) and its d bucket and d sign indices (int32), and it
    writes the (d, width) float32 table once."""
    per_element = 4 + 2 * 4 * depth
    table = depth * width * 4
    per_million_ms = (1_000_000 * per_element + table) / PEAK_BYTES_PER_S * 1e3
    print(
        f"[chip_smoke] still to port: countsketch_pallas at d={depth}, width={width}: bound "
        f"{per_element} bytes per gradient element + {table} bytes of table, "
        f"{per_million_ms:.6f} ms per million elements (bytes, at {PEAK_BYTES_PER_S:.3g} B/s)"
    )


def _same_results(ev_a, ev_b) -> bool:
    import numpy as np

    if (ev_a.tick, ev_a.epoch, ev_a.alarm) != (ev_b.tick, ev_b.epoch, ev_b.alarm):
        return False
    for ra, rb in zip(ev_a.results, ev_b.results, strict=True):
        va = ra.value if isinstance(ra.value, tuple) else (ra.value,)
        vb = rb.value if isinstance(rb.value, tuple) else (rb.value,)
        if not all(np.array_equal(x, y) for x, y in zip(va, vb, strict=True)):
            return False
    return True


def timed_run(torch, fn):
    """(session, events, host wall seconds) of one serve run."""
    t0 = time.time()
    stream, _, events = fn()
    torch.cuda.synchronize()
    return stream, events, time.time() - t0


def run_fused(serve, argv):
    """serve.run on the parsed ``argv`` with the session in fused mode (the
    serve CLI offers no ``fused`` choice, as in the reference)."""
    args = serve.build_parser().parse_args(argv)
    args.ingest_backend = "fused"
    return serve.run(args)


def check_same(torch, a, ev_a, b, ev_b, label):
    """Two runs must leave the same counters, registers and transcript."""
    ka, kb = a._live(), b._live()
    for name in ("counters", "row_flows", "col_flows"):
        check(torch.equal(getattr(ka, name), getattr(kb, name)), f"{label}: {name} differ")
    check(bool(torch.isfinite(ka.counters).all()), f"{label}: non-finite counters")
    check(len(ev_a) == len(ev_b) and len(ev_a) > 0, f"{label}: {len(ev_a)} vs {len(ev_b)} events")
    check(all(_same_results(x, y) for x, y in zip(ev_a, ev_b)), f"{label}: subscription results differ")


def profile_serve(torch, serve, argv, label):
    """One more serve run under the profiler (CUDA activity only): device
    time by kernel and the device's busy share of the run's wall clock."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        serve.main(argv)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    by_kernel = sorted(
        ((getattr(e, "device_time_total", 0.0) / 1e3, e.count, e.key) for e in prof.key_averages()),
        reverse=True,
    )
    busy_ms = sum(t for t, _, _ in by_kernel)
    print(
        f"[chip_smoke] {label} profiled: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%, profiler on)"
    )
    for t, n, key in by_kernel[:8]:
        print(f"[chip_smoke]   {t:10.3f} ms  x{n:<5d} {key[:100]}")


def main() -> int:
    t_start = time.time()
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        raise SmokeFailure(f"no src/repro_torch beside {Path(__file__).name}: run it from a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import numpy as np

    from repro_torch.core import queries
    from repro_torch.core.hashing import keys_to_tensor
    from repro_torch.kernels import build
    from repro_torch.kernels.closure import ops as closure_ops
    from repro_torch.kernels.flow import ops as flow_ops
    from repro_torch.kernels.ingest import ops as ingest_ops
    from repro_torch.kernels.ingest_fused import ops as fused_ops
    from repro_torch.kernels.query import ops as query_ops
    from repro_torch.launch import serve

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"[chip_smoke] nvidia-smi: {smi}")
    print(f"[chip_smoke] torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")

    t0 = time.time()
    names = ("ingest", "query", "closure", "ingest_fused", "flow")
    build.build(names)
    print(f"[chip_smoke] built {', '.join(names)} in {time.time() - t0:.1f} s (nvcc, sm_90a, in parallel)")
    for name in names:
        for line in build.build_log(name).splitlines():
            if "ptxas" in line:
                print(f"[chip_smoke] {name}: {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for phase in (phase_ingest, phase_query, phase_closure, phase_fused_ingest, phase_query_cells, phase_flows):
        row = phase(torch, gen)
        rows[row["name"]] = row
        torch.cuda.empty_cache()

    # A small session on the card against the same session on the CPU (the
    # plain versions): the same stream, answers and summary.
    small = ["--depth", "3", "--width", "256", "--nodes", "2000", "--edges", "20000", "--batch", "5000"]
    gs_cuda, _, ev_cuda = serve.main(small)
    gs_cpu, _, ev_cpu = serve.main(small + ["--device", "cpu"])
    check(torch.equal(gs_cuda._live().counters.cpu(), gs_cpu._live().counters), "small: counters differ from CPU")
    check(all(_same_results(a, b) for a, b in zip(ev_cuda, ev_cpu, strict=True)), "small: results differ from CPU")
    print("[chip_smoke] small session: CUDA and CPU runs identical")

    counted = {
        "ingest_scatter": ingest_ops.ingest_scatter,
        "edge_query_min": query_ops.edge_query_min,
        "closure_step": closure_ops.closure_step,
        "fused_ingest": fused_ops.fused_ingest,
        "edge_query_cells": query_ops.edge_query_cells,
        "flows": flow_ops.flows,
    }

    def drive(kernel_names, fn):
        """Run ``fn`` with every count at 0; record the named kernels' counts."""
        for f in counted.values():
            f.launches = 0
        out = fn()
        for name in kernel_names:
            rows[name]["launches"] = counted[name].launches
            check(counted[name].launches > 0, f"{name} was not launched on its path")
        return out

    # The main path, at BASE, on the kernels (counts read from this run
    # only), then on the plain backends, which launch nothing.
    base, base_ev, base_s = drive(
        ("ingest_scatter", "edge_query_min", "closure_step"),
        lambda: timed_run(torch, lambda: serve.main(SERVE_BASE)),
    )
    plain, plain_ev, plain_s = timed_run(torch, lambda: serve.main(SERVE_BASE + PLAIN_BACKENDS))
    check_same(torch, base, base_ev, plain, plain_ev, "serve BASE vs plain")
    check(base.engine.closure_refreshes >= 1, "serve BASE: no closure build")
    print(
        f"[chip_smoke] serve BASE: kernels {base_s:.2f} s, plain {plain_s:.2f} s (host wall clock, "
        f"build excluded); {len(base_ev)} ticks; counters, registers and transcript identical"
    )

    # The fused session on the same traffic: one fused launch per batch.
    fused, fused_ev, fused_s = drive(
        ("fused_ingest",), lambda: timed_run(torch, lambda: run_fused(serve, SERVE_BASE))
    )
    n_batches = -(-int(SERVE_BASE[SERVE_BASE.index("--edges") + 1]) // INGEST_BATCH)
    check(rows["fused_ingest"]["launches"] == n_batches,
          f"fused serve BASE: {rows['fused_ingest']['launches']} fused launches for {n_batches} batches")
    check_same(torch, fused, fused_ev, plain, plain_ev, "fused serve BASE vs plain")
    check_same(torch, fused, fused_ev, base, base_ev, "fused serve BASE vs cuda-ingest run")
    print(
        f"[chip_smoke] fused serve BASE: {fused_s:.2f} s (host wall clock; {n_batches} fused launches, "
        f"closure full={fused.engine.closure_refreshes} incremental={fused.engine.closure_incremental_refreshes}); "
        f"identical to the plain and cuda-ingest runs"
    )
    del base, plain, base_ev, plain_ev
    torch.cuda.empty_cache()

    # The ops entry points on the fused session's live sketch: flows from the
    # counters against the maintained registers, per-sketch cells against
    # the fused multi-query.
    live = fused._live()
    rng = np.random.default_rng(12)
    q_src = keys_to_tensor(rng.integers(0, 100_000, 1024).astype(np.uint32), "cuda")
    q_dst = keys_to_tensor(rng.integers(0, 100_000, 1024).astype(np.uint32), "cuda")

    def entry_checks():
        in_k, out_k = flow_ops.node_in_flow(live, q_src), flow_ops.node_out_flow(live, q_src)
        cells = query_ops.edge_query_cells(live.counters, *live.hash_edges(q_src, q_dst))
        return in_k, out_k, cells

    in_k, out_k, cells = drive(("flows", "edge_query_cells"), entry_checks)
    check(torch.equal(in_k, queries.node_in_flow(live, q_src)), "node_in_flow: kernel flows differ from registers")
    check(torch.equal(out_k, queries.node_out_flow(live, q_src)), "node_out_flow: kernel flows differ from registers")
    check(torch.equal(cells.amin(dim=0), queries.edge_query(live, q_src, q_dst)),
          "edge_query_cells: min over sketches differs from the edge query")
    print(
        f"[chip_smoke] ops entry points on the fused BASE sketch: node_in_flow/node_out_flow over 1,024 keys "
        f"equal the registers ({rows['flows']['launches']} flows launches); edge_query_cells' min equals "
        f"the edge query ({rows['edge_query_cells']['launches']} launch)"
    )
    del fused, fused_ev, live
    torch.cuda.empty_cache()
    profile_serve(torch, serve, SERVE_BASE, "serve BASE")
    torch.cuda.empty_cache()

    inc, inc_ev, inc_s = timed_run(torch, lambda: serve.main(SERVE_INCREMENTAL))
    plain, plain_ev, plain_s = timed_run(torch, lambda: serve.main(SERVE_INCREMENTAL + PLAIN_BACKENDS))
    check_same(torch, inc, inc_ev, plain, plain_ev, "serve incremental vs plain")
    check(inc.engine.closure_incremental_refreshes > 0, "no incremental closure refresh")
    finc, finc_ev, finc_s = timed_run(torch, lambda: run_fused(serve, SERVE_INCREMENTAL))
    check_same(torch, finc, finc_ev, plain, plain_ev, "fused serve incremental vs plain")
    check(finc.engine.closure_incremental_refreshes > 0, "fused: no bitmap-driven incremental refresh")
    print(
        f"[chip_smoke] serve incremental: kernels {inc_s:.2f} s, fused {finc_s:.2f} s, plain {plain_s:.2f} s; "
        f"closure full={inc.engine.closure_refreshes} incremental={inc.engine.closure_incremental_refreshes}, "
        f"fused full={finc.engine.closure_refreshes} incremental={finc.engine.closure_incremental_refreshes}; "
        f"identical to the plain run"
    )

    countsketch_bound()
    print(f"[chip_smoke] total {time.time() - t_start:.1f} s, build included")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows.values()]}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
