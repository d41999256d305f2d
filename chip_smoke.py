#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc``
per source, all at once), holds each kernel against its plain PyTorch
version on the card at the BASE shapes (``configs/glava.py``: d=5,
8192 x 8192 counters), times kernel, plain version and one PyTorch library
call with CUDA events, then drives the main path — ``repro_torch.launch.serve``
at BASE with the serve entry point's own traffic — once on the kernels and once
on the plain backends, and requires the two runs to agree bit for bit.

Output: the card's name and power limit as ``nvidia-smi`` reports them, the
build log, one line per phase, one JSON line listing every kernel (launches
on the main path, error against the plain version, times and bound), and
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


def serve_pair(torch, serve, argv, label):
    """One serve run on the kernels, one on the plain backends; both must
    leave the same counters, registers and subscription transcript."""
    t0 = time.time()
    ks, ksub, kev = serve.main(argv)
    torch.cuda.synchronize()
    kernel_s = time.time() - t0
    t0 = time.time()
    ps, psub, pev = serve.main(argv + PLAIN_BACKENDS)
    torch.cuda.synchronize()
    plain_s = time.time() - t0
    k, p = ks._live(), ps._live()
    for name in ("counters", "row_flows", "col_flows"):
        check(torch.equal(getattr(k, name), getattr(p, name)), f"{label}: {name} differ from the plain run")
    check(bool(torch.isfinite(k.counters).all()), f"{label}: non-finite counters")
    check(len(kev) == len(pev) and len(kev) > 0, f"{label}: {len(kev)} vs {len(pev)} events")
    check(all(_same_results(a, b) for a, b in zip(kev, pev)), f"{label}: subscription results differ")
    print(
        f"[chip_smoke] {label}: kernels {kernel_s:.2f} s, plain {plain_s:.2f} s (host wall clock, "
        f"build excluded); {len(kev)} ticks; counters, registers and transcript identical"
    )
    return ks


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

    from repro_torch.kernels import build
    from repro_torch.kernels.closure import ops as closure_ops
    from repro_torch.kernels.ingest import ops as ingest_ops
    from repro_torch.kernels.query import ops as query_ops
    from repro_torch.launch import serve

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"[chip_smoke] nvidia-smi: {smi}")
    print(f"[chip_smoke] torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")

    t0 = time.time()
    names = ("ingest", "query", "closure")
    build.build(names)
    print(f"[chip_smoke] built {', '.join(names)} in {time.time() - t0:.1f} s (nvcc, sm_90a, in parallel)")
    for name in names:
        for line in build.build_log(name).splitlines():
            if "ptxas" in line:
                print(f"[chip_smoke] {name}: {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = [phase_ingest(torch, gen)]
    torch.cuda.empty_cache()
    rows.append(phase_query(torch, gen))
    torch.cuda.empty_cache()
    rows.append(phase_closure(torch, gen))
    torch.cuda.empty_cache()

    # A small session on the card against the same session on the CPU (the
    # plain versions): the same stream, answers and summary.
    small = ["--depth", "3", "--width", "256", "--nodes", "2000", "--edges", "20000", "--batch", "5000"]
    gs_cuda, _, ev_cuda = serve.main(small)
    gs_cpu, _, ev_cpu = serve.main(small + ["--device", "cpu"])
    check(torch.equal(gs_cuda._live().counters.cpu(), gs_cpu._live().counters), "small: counters differ from CPU")
    check(all(_same_results(a, b) for a, b in zip(ev_cuda, ev_cpu, strict=True)), "small: results differ from CPU")
    print("[chip_smoke] small session: CUDA and CPU runs identical")

    # The main path, at BASE.  Launch counts are read from this run only.
    launch_fns = (ingest_ops.ingest_scatter, query_ops.edge_query_min, closure_ops.closure_step)
    for fn in launch_fns:
        fn.launches = 0
    base = serve_pair(torch, serve, SERVE_BASE, "serve BASE")
    launches = [fn.launches for fn in launch_fns]
    # serve_pair's plain run launches nothing: the counts are the kernel run's.
    for row, n in zip(rows, launches):
        row["launches"] = n
        check(n > 0, f"{row['name']} was not launched on the main path")
    check(base.engine.closure_refreshes >= 1, "serve BASE: no closure build")
    del base
    torch.cuda.empty_cache()
    profile_serve(torch, serve, SERVE_BASE, "serve BASE")
    torch.cuda.empty_cache()

    inc = serve_pair(torch, serve, SERVE_INCREMENTAL, "serve incremental")
    check(inc.engine.closure_incremental_refreshes > 0, "no incremental closure refresh")
    print(
        f"[chip_smoke] incremental: closure full={inc.engine.closure_refreshes} "
        f"incremental={inc.engine.closure_incremental_refreshes}"
    )

    print(f"[chip_smoke] total {time.time() - t_start:.1f} s, build included")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
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
