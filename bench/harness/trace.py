"""The device trace of a ``--trace 1`` window: ``torch.profiler`` with CUDA
activity only (no host op is recorded, so the host path runs as untraced
but for the profiler's own callbacks), read straight from the kineto
results.  Device events carry wall-clock nanoseconds, the clock of the
harness's own spans (``time.time_ns``)."""
from __future__ import annotations

import dataclasses
import re
from typing import List, Optional, Tuple

import torch


@dataclasses.dataclass
class DeviceOp:
    name: str
    start_ns: int
    end_ns: int


@dataclasses.dataclass
class Span:
    """A harness span around one call into the program."""

    name: str
    start_ns: int
    end_ns: int


def profiler() -> torch.profiler.profile:
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])


def device_ops(prof: torch.profiler.profile) -> List[DeviceOp]:
    """Every operation that ran on the device: kernels, copies, fills."""
    cuda = torch.autograd.DeviceType.CUDA
    ops = [DeviceOp(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events() if e.device_type() == cuda and e.duration_ns() > 0]
    return sorted(ops, key=lambda o: o.start_ns)


def busy_intervals(ops: List[DeviceOp], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The union of the ops' intervals, clipped to [lo, hi]."""
    merged: List[Tuple[int, int]] = []
    for op in ops:
        s, e = max(op.start_ns, lo), min(op.end_ns, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
        else:
            merged.append((s, e))
    return merged


def busy_s(ops: List[DeviceOp], lo: int, hi: int) -> float:
    return sum(e - s for s, e in busy_intervals(ops, lo, hi)) / 1e9


def kernel_s(ops: List[DeviceOp], pattern: str) -> Optional[float]:
    """Seconds of the ops whose name matches ``pattern``; None if none ran."""
    rx = re.compile(pattern)
    hits = [o for o in ops if rx.search(o.name)]
    return sum(o.end_ns - o.start_ns for o in hits) / 1e9 if hits else None


def short(name: str) -> str:
    """A kernel's name without its return type, arguments and namespaces."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in name:
        if ch == "(" and depth == 0:
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    return "".join(out)[:120]


def breakdown(ops: List[DeviceOp], spans: List[Span], lo: int, hi: int) -> dict:
    """The ten device ops that took most time, and the ten longest idle gaps
    named by the harness span the host was in (and how far into it)."""
    by_name: dict = {}
    for o in ops:
        by_name[short(o.name)] = by_name.get(short(o.name), 0) + (o.end_ns - o.start_ns)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    busy = busy_intervals(ops, lo, hi)
    gaps, cursor = [], lo
    for s, e in busy + [(hi, hi)]:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for s, e in gaps[:10]:
        span = next((sp for sp in spans if sp.start_ns <= s < sp.end_ns), None)
        where = f"{span.name}, {(s - span.start_ns) / 1e6:.3f} ms into it" if span else "between calls"
        named.append([where, (e - s) / 1e9])
    return {"device_ops": [[n, t / 1e9] for n, t in top], "idle_gaps": named}
