"""costlint, pass 3: traced-cost and scaling-law contracts, the port of
``src/repro/analysis/costlint.py``.

The paper's headline guarantees are asymptotic: constant maintenance cost
per edge update, O(d·Q) query evaluation, O(T_touched·w²) closure refresh.
For every :class:`~repro_torch.analysis.contracts.CostEntryPoint` this pass
runs the probe at 2–3 geometrically spaced sizes per axis (batch B, queries
Q, tenants T, width w, touched stack S, ring K) under a :class:`CostCounter`
and fits per-axis log-log exponents of its counted work (or bytes).

The reference reads XLA's ``cost_analysis()``; the port counts the aten ops
it runs (``CostCounter``):

- elementwise ops, copies, fills and gathers: their output elements;
- ``index_put_``, ``index_add_`` and the scatters: their value elements;
- reductions: their input elements;
- ``mm``, ``bmm``, ``_int_mm`` (and ``addmm``, ``baddbmm``): 2·m·n·k;
- views and empty allocations: nothing;

and "bytes" are the bytes those elements touch.  A kernel wrapper's call
counts what it declares (``kernels/build.py::costed``) and none of the ops
it makes, so a trace on the CPU (plain versions) and on the card (kernels)
count the same work for the same call.

Violations:

- ``cost-exponent``        a fitted exponent exceeds its declared ceiling
                           (+tol): a silent O(B²) ingest or T-wide scan;
- ``cost-donation-memory`` a boundary that updates the summary in place has
                           fresh allocations alive at once of the state's
                           bytes or more (the counter's on the CPU, the
                           caching allocator's peak on the card): the
                           memory side of the in-place update;
- ``cost-budget``          a ceiling of the committed ``budgets.json``
                           (peak bytes, work and bytes an edge, the number
                           of traced points) regresses.

Budgets ratchet: ``python -m repro_torch.analysis --update-budgets``
re-measures and rewrites the ceilings at ``measured × margin``.
"""
from __future__ import annotations

import json
import math
import pathlib
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.analysis.contracts import COST_ENTRY_POINTS, CostEntryPoint, Violation
from repro_torch.analysis.dispatch_lint import INDEXING_OPS, REDUCTION_OPS, OpSink, Recorder

# Headroom multiplier applied by --update-budgets: ceilings absorb version
# jitter without hiding a real (>=25%) regression.
BUDGET_MARGIN = 1.25

DEFAULT_BUDGETS_PATH = pathlib.Path(__file__).with_name("budgets.json")

_MATMUL_OPS = frozenset({"mm", "bmm", "_int_mm", "addmm", "baddbmm", "addbmm", "mv", "dot"})
_SCATTER_VALUES = {  # op -> position of its value operand
    "index_put": 2, "index_put_": 2, "_index_put_impl_": 2, "index_add": 3, "index_add_": 3,
    "scatter": 3, "scatter_": 3, "scatter_add": 3, "scatter_add_": 3, "scatter_reduce": 3,
    "scatter_reduce_": 3, "index_copy": 3, "index_copy_": 3,
}
_GATHER_OPS = frozenset({"index", "_unsafe_index", "index_select", "gather", "take", "embedding",
                         "take_along_dim"})
_FREE_OPS = frozenset({"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
                       "set_", "resize_", "lift_fresh", "record_stream"})
_COLLECTIVE_NAMESPACES = frozenset({"c10d", "_c10d_functional", "c10d_functional"})


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _matmul_work(name: str, ins: List[torch.Tensor]) -> int:
    mats = [t for t in ins if t.dim() >= 1]
    a, b = (mats[-2], mats[-1]) if name in ("addmm", "baddbmm", "addbmm") else (mats[0], mats[1])
    if name in ("mv", "dot"):
        return 2 * a.numel()
    batch = math.prod(a.shape[:-2]) if a.dim() > 2 else 1
    return 2 * batch * a.shape[-2] * a.shape[-1] * b.shape[-1]


class CostCounter(OpSink):
    """Counts work and bytes of the aten ops it sees, and the kernel
    wrappers' declared costs; tracks fresh allocations (in all, the largest
    one, the most alive at once by weak references to the allocating ops'
    outputs)."""

    def __init__(self):
        super().__init__()
        self.work = 0
        self.bytes = 0
        self.alloc_bytes = 0
        self.max_alloc_bytes = 0
        self.live_bytes = 0
        self.peak_live_bytes = 0

    def on_kernel(self, work: int, nbytes: int) -> None:
        self.work += work
        self.bytes += nbytes

    def on_alloc(self, t: torch.Tensor, nbytes: int) -> None:
        self.alloc_bytes += nbytes
        self.max_alloc_bytes = max(self.max_alloc_bytes, nbytes)
        self.live_bytes += nbytes
        self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)
        weakref.finalize(t, self._free, nbytes)

    def _free(self, nbytes: int) -> None:
        self.live_bytes -= nbytes

    def on_record(self, rec, func, args, kwargs, ins, outs) -> None:
        name = rec.name
        if name in _FREE_OPS or rec.namespace in _COLLECTIVE_NAMESPACES or not (ins or outs):
            return
        if rec.aliased and not name.endswith("_") and func._overloadname != "out":
            return  # a view
        out_n = sum(t.numel() for t in outs)
        if name in _MATMUL_OPS:
            work = _matmul_work(name, ins)
            nbytes = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        elif name in _SCATTER_VALUES:
            pos = _SCATTER_VALUES[name]
            values = args[pos] if len(args) > pos and isinstance(args[pos], torch.Tensor) else None
            n = values.numel() if values is not None else out_n
            dest = args[0]
            index_bytes = sum(_nbytes(t) for t in ins[1:] if t is not values)
            work = n
            nbytes = n * (values.element_size() if values is not None else 0) + index_bytes + 2 * n * dest.element_size()
        elif name in REDUCTION_OPS:
            work = sum(t.numel() for t in ins[:1])
            nbytes = sum(_nbytes(t) for t in ins[:1]) + sum(_nbytes(t) for t in outs)
        elif name in _GATHER_OPS or name in INDEXING_OPS:
            src = ins[0] if ins else None
            work = out_n
            nbytes = (sum(_nbytes(t) for t in outs) + sum(_nbytes(t) for t in ins[1:])
                      + out_n * (src.element_size() if src is not None else 0))
        else:
            work = out_n
            nbytes = sum(_nbytes(t) for t in outs) + sum(min(t.numel(), out_n) * t.element_size() for t in ins)
        self.work += int(work)
        self.bytes += int(nbytes)


# ---------------------------------------------------------------------------
# measurement
# ---------------------------------------------------------------------------


def _fit_exponent(sizes: Sequence[int], values: Sequence[float]) -> float:
    """Log-log least-squares slope; values clip at 1 so an all-zero metric
    fits exponent 0, not -inf."""
    import numpy as np

    xs = np.log(np.asarray(sizes, dtype=float))
    ys = np.log(np.maximum(np.asarray(values, dtype=float), 1.0))
    if xs.size < 2:
        return 0.0
    return float(np.polyfit(xs, ys, 1)[0])


def _trace_point(entry: CostEntryPoint, sizes: Dict[str, int], device: str) -> Dict:
    from repro_torch.roofline.analysis import memory_dict, traced_cost_dict

    probe = entry.build(device=device, **sizes)
    cuda = torch.device(device).type == "cuda"
    counter = CostCounter()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
    with Recorder(counter):
        result = probe.fn(*probe.args)
    del result
    cuda_peak = None
    if cuda:
        torch.cuda.synchronize()
        cuda_peak = torch.cuda.max_memory_allocated() - before
    cost = traced_cost_dict(counter)
    return {
        "sizes": dict(sizes),
        "work": cost["work"],
        "bytes": cost["bytes accessed"],
        "memory": memory_dict(counter, state_bytes=probe.state_bytes, cuda_peak_bytes=cuda_peak),
        "state_bytes": int(probe.state_bytes),
    }


def measure_entry(entry: CostEntryPoint, device: str = "cpu") -> Dict:
    """Trace ``entry`` at every point of every axis ladder on ``device`` (the
    base point, each axis at its smallest size, is traced once and shared)
    and fit the per-axis exponents.  Returns the measurement record the
    report, budget and table layers read."""
    base = {a.axis: a.sizes[0] for a in entry.axes}

    def key(sizes: Dict[str, int]) -> Tuple:
        return tuple(sorted(sizes.items()))

    points: Dict[Tuple, Dict] = {}
    for ax in entry.axes:
        for s in ax.sizes:
            sizes = dict(base, **{ax.axis: s})
            if key(sizes) not in points:
                points[key(sizes)] = _trace_point(entry, sizes, device)

    fits = []
    for ax in entry.axes:
        values = [points[key(dict(base, **{ax.axis: s}))][ax.metric] for s in ax.sizes]
        measured = _fit_exponent(ax.sizes, values)
        fits.append(
            {
                "axis": ax.axis,
                "metric": ax.metric,
                "declared": ax.exponent,
                "tol": ax.tol,
                "measured": round(measured, 3),
                "sizes": list(ax.sizes),
                "values": values,
                "ok": measured <= ax.exponent + ax.tol,
            }
        )

    base_point = points[key(base)]
    peak = max((p["memory"].get("peak_bytes_per_device_est", 0) for p in points.values()), default=0)
    meas = {
        "entry": entry.name,
        "device": device,
        "donated": entry.donated,
        "axes": fits,
        "traces": len(points),
        "peak_bytes": int(peak),
        "base_memory": base_point["memory"],
        "state_bytes": base_point["state_bytes"],
    }
    if entry.edges_axis is not None:
        ax = next(a for a in entry.axes if a.axis == entry.edges_axis)
        big = points[key(dict(base, **{ax.axis: ax.sizes[-1]}))]
        meas["edges_at_max"] = int(ax.sizes[-1])
        meas["bytes_per_edge"] = big["bytes"] / float(ax.sizes[-1])
        meas["work_per_edge"] = big["work"] / float(ax.sizes[-1])
    return meas


# ---------------------------------------------------------------------------
# contract checks
# ---------------------------------------------------------------------------


def _violation(rule: str, subject: str, message: str) -> Violation:
    return Violation(rule=rule, subject=subject, message=message, pass_name="costlint")


def _exponent_violations(meas: Dict) -> List[Violation]:
    out = []
    for fit in meas["axes"]:
        if fit["ok"]:
            continue
        vals = ", ".join(f"{v:.4g}" for v in fit["values"])
        out.append(_violation(
            "cost-exponent", f"{meas['entry']}[{fit['axis']}]",
            f"measured {fit['metric']} exponent {fit['measured']:.2f} over {fit['axis']} ∈ {fit['sizes']} "
            f"exceeds declared O(n^{fit['declared']:g}) + {fit['tol']:g} tol ({fit['metric']}: {vals})",
        ))
    return out


def _donation_violations(meas: Dict) -> List[Violation]:
    """Memory side of the in-place update at the base point: the fresh
    allocations alive at once during the call stay below the summary's
    bytes, or the boundary copied the counters."""
    if not meas["donated"] or not meas["base_memory"]:
        return []
    state = meas["state_bytes"]
    live = meas["base_memory"].get("peak_live_bytes", 0)
    if live >= state:
        return [_violation(
            "cost-donation-memory", meas["entry"],
            f"the in-place boundary holds {live} fresh bytes at once (>= the {state} bytes of the summary): "
            "the batch copies the counters",
        )]
    return []


def _budget_violations(measurements: List[Dict], budgets: Optional[Dict], full_registry: bool) -> List[Violation]:
    if budgets is None:
        return [_violation("cost-budget", "budgets.json", (
            "no committed budgets file: run `python -m repro_torch.analysis --update-budgets` and commit "
            "src/repro_torch/analysis/budgets.json"))]
    out = []
    entries = budgets.get("entries", {})
    for m in measurements:
        b = entries.get(m["entry"])
        if b is None:
            out.append(_violation("cost-budget", m["entry"],
                                  "no committed ceiling for this entry: run --update-budgets and commit budgets.json"))
            continue
        ceil = b.get("peak_bytes")
        if ceil and m["peak_bytes"] > ceil:
            out.append(_violation(
                "cost-budget", m["entry"],
                f"peak memory {m['peak_bytes']} B exceeds committed ceiling {ceil} B "
                f"(+{(m['peak_bytes'] / ceil - 1) * 100:.0f}%)",
            ))
        for metric in ("bytes", "work"):
            per = b.get(f"{metric}_per_edge")
            got = m.get(f"{metric}_per_edge", 0.0)
            if per and got > per:
                out.append(_violation(
                    "cost-budget", m["entry"],
                    f"{got:.1f} {metric} per edge exceeds committed ceiling {per:.1f} (+{(got / per - 1) * 100:.0f}%)",
                ))
    ceiling = budgets.get("trace_count")
    total = sum(m["traces"] for m in measurements)
    if full_registry and ceiling and total > ceiling:
        out.append(_violation(
            "cost-budget", "costlint.trace_count",
            f"{total} traced points across the cost registry exceed the committed ceiling {ceiling}: a new "
            "entry or size ladder landed without --update-budgets",
        ))
    return out


def run_cost_pass(
    entry_points: Optional[Sequence[CostEntryPoint]] = None,
    *,
    budgets: Optional[Dict] = None,
    check_budgets: bool = True,
    full_registry: Optional[bool] = None,
    device: str = "cpu",
) -> Tuple[List[Violation], List[Dict]]:
    """Measure every cost entry point on ``device`` and check all three
    contract classes.  Returns ``(violations, measurements)``.
    ``check_budgets=False`` skips the absolute ceilings (fixture tests,
    --update-budgets runs, the card's run)."""
    if full_registry is None:
        full_registry = entry_points is None
    eps = COST_ENTRY_POINTS if entry_points is None else tuple(entry_points)
    violations: List[Violation] = []
    measurements: List[Dict] = []
    for ep in eps:
        try:
            meas = measure_entry(ep, device)
        except Exception as e:  # a broken probe IS a finding
            violations.append(_violation("cost-entry-broken", ep.name, f"cost probe failed to build/run: {e!r}"))
            continue
        measurements.append(meas)
        violations.extend(_exponent_violations(meas))
        violations.extend(_donation_violations(meas))
    if check_budgets:
        violations.extend(_budget_violations(measurements, budgets, full_registry))
    return violations, measurements


# ---------------------------------------------------------------------------
# budgets: load / ratchet
# ---------------------------------------------------------------------------


def load_budgets(path: Optional[pathlib.Path] = None) -> Optional[Dict]:
    p = pathlib.Path(path) if path is not None else DEFAULT_BUDGETS_PATH
    if not p.exists():
        return None
    return json.loads(p.read_text())


def budgets_from_measurements(
    measurements: List[Dict],
    *,
    margin: float = BUDGET_MARGIN,
    prior: Optional[Dict] = None,
    full_registry: bool = True,
) -> Dict:
    """The ratchet: ceilings at measured × margin.  Entries not measured
    this run (a --cost-entries filter) keep their prior ceilings; the
    trace-count ceiling only moves on full-registry runs."""
    entries = dict((prior or {}).get("entries", {}))
    for m in measurements:
        e = {"peak_bytes": int(math.ceil(m["peak_bytes"] * margin))}
        for metric in ("bytes", "work"):
            if f"{metric}_per_edge" in m:
                e[f"{metric}_per_edge"] = round(m[f"{metric}_per_edge"] * margin, 1)
        entries[m["entry"]] = e
    trace_count = sum(m["traces"] for m in measurements) if full_registry else (prior or {}).get("trace_count")
    out = {"margin": margin, "entries": dict(sorted(entries.items()))}
    if trace_count is not None:
        out["trace_count"] = trace_count
    return out


def write_budgets(budgets: Dict, path: Optional[pathlib.Path] = None) -> pathlib.Path:
    p = pathlib.Path(path) if path is not None else DEFAULT_BUDGETS_PATH
    p.write_text(json.dumps(budgets, indent=1, sort_keys=True) + "\n")
    return p


# ---------------------------------------------------------------------------
# the cost table
# ---------------------------------------------------------------------------


def cost_table_markdown(measurements: List[Dict]) -> str:
    """Entry point → declared complexity → measured exponents, as a markdown
    table."""
    lines = [
        "| entry point | axis | metric | declared | measured | sizes | ok |",
        "|---|---|---|---|---|---|---|",
    ]
    for m in measurements:
        for fit in m["axes"]:
            sizes = "×".join(str(s) for s in fit["sizes"])
            lines.append(
                f"| {m['entry']} | {fit['axis']} | {fit['metric']} "
                f"| O(n^{fit['declared']:g})+{fit['tol']:g} "
                f"| {fit['measured']:.2f} | {sizes} "
                f"| {'✓' if fit['ok'] else '✗'} |"
            )
    lines.append("")
    for m in measurements:
        extra = (
            f", {m['work_per_edge']:.1f} work and {m['bytes_per_edge']:.1f} B/edge @ {m['edges_at_max']} edges"
            if "bytes_per_edge" in m
            else ""
        )
        lines.append(f"- `{m['entry']}`: {m['traces']} traces, peak {m['peak_bytes']} B{extra}")
    return "\n".join(lines) + "\n"
