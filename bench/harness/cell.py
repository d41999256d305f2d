"""One run of one cell: set-up, the measured window, the check against the
reference, and the metrics.

Set-up draws the inputs from the seed (the mix's ``generator``), opens the
program (the configuration's ``driver``) and hands it the mix's warm-up.
The window then hands work on the mix's schedule (its ``loop``) for
``seconds`` and ends with a ``torch.cuda.synchronize()``.  After it the
configuration's ``reference`` judges what the program produced, and each
metric's reader reads the run.
"""
from __future__ import annotations

import dataclasses
import gc
import sys
import time
from typing import Dict, List, Optional, Tuple

import torch

from bench.harness import spec
from bench.harness.trace import DeviceOp, Span, breakdown, busy_s, device_ops, profiler

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Context:
    """What a metric's reader reads (``bench/metrics/<name>.py``)."""

    cell: spec.Cell
    seed: int
    inputs: object                  # what the generator drew
    setup_s: float
    window_s: float
    before: Dict[str, float]        # the driver's counters at the window's start
    after: Dict[str, float]         # and at its end
    alert_ms: List[float]           # the latency of every event of the window
    spans: List[Span]               # every call of the window
    ops: Optional[List[DeviceOp]]   # the device trace (None untraced)
    lo_ns: int
    hi_ns: int
    facts: Dict[str, object]        # the reference's own findings


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """``correct`` and each number beside its limit.  A number without a
    limit is a fault of the workload file, never a pass."""
    checks = {name: {"value": value, "limit": limits.get(name)} for name, value in numbers.items()}
    ok = all(c["limit"] is not None and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, device, started: float) -> dict:
    """Run ``cell`` once; ``started`` is the process's start on the host
    clock.  Returns the result line's object (``checks`` last)."""
    import repro_torch.kernels.build as build

    cuda = torch.device(device).type == "cuda"
    tr = cell.traffic
    phases = {"start": time.time() - started}
    if cuda:
        build.build(build.SOURCES)  # every kernel, in parallel; built once a checkout
    phases["kernels"] = time.time() - started
    inputs = spec.plugin("generator", tr["generator"]).make(tr, seed, device, seconds=seconds)
    if cuda:
        torch.cuda.empty_cache()
        for i in range(cell.chips):
            torch.cuda.reset_peak_memory_stats(i)
    phases["inputs"] = time.time() - started
    drv = spec.driver(cell.config["driver"])(cell.config, tr, seed, device, inputs)
    phases["open"] = time.time() - started
    drv.warm_up()
    sync(device)
    setup_s = time.time() - started
    phases["warm-up"] = setup_s
    print("bench: set-up " + ", ".join(f"{k} {v:.2f} s" for k, v in phases.items()), file=sys.stderr)

    # -- the window --------------------------------------------------------
    before = drv.counters()
    first_event = len(drv.latencies_ms())
    prof = profiler() if trace else None
    if prof:
        prof.start()
    lo_ns = time.time_ns()
    t0 = time.perf_counter()
    spans = spec.plugin("loop", tr["loop"]).run(drv, seconds, t0)
    sync(device)
    window_s = time.perf_counter() - t0
    hi_ns = time.time_ns()
    if prof:
        prof.stop()
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(cell.chips)) if cuda else 0
    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"modules of JAX or the JAX package are loaded: {bad}")
    after = drv.counters()
    alert_ms = drv.latencies_ms()[first_event:]
    ops = device_ops(prof) if prof else None

    # -- the check ---------------------------------------------------------
    out = drv.outputs()
    drv.close()
    del drv
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers, facts = spec.plugin("reference", cell.config["reference"]).compare(cell, seed, inputs, out, device)
    del out
    correct, checks = judge(numbers, cell.workload["limits"])
    print(f"bench: the check took {time.perf_counter() - t_ref:.1f} s after a window of {window_s:.1f} s",
          file=sys.stderr)

    # -- metrics -------------------------------------------------------------
    ctx = Context(cell, seed, inputs, setup_s, window_s, before, after, alert_ms, spans, ops, lo_ns, hi_ns, facts)
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = spec.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": correct,
        "attempted": len(spans),
        "failed": 0,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name() if cuda else "cpu",
            "count": cell.chips,
            "memory_peak_bytes": peak,
        },
    }
    if ops is not None:
        result["device"]["busy_s"] = busy_s(ops, lo_ns, hi_ns)
        result["device"]["window_s"] = (hi_ns - lo_ns) / 1e9
        result["breakdown"] = breakdown(ops, spans, lo_ns, hi_ns)
    result["checks"] = checks
    return result
