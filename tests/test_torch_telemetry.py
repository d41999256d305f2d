"""The port's spans (``repro_torch.telemetry``) on the CPU: off without a
profiler (no clock read, no record, the same receipts and counters), every
span of the session, fleet and analytics paths under a CPU-activity
profiler, nested inside its parent and sharing its call's trace, on the
clock of kineto's events, and the ring's bound.  The in-flight waits
(``ingest.wait``) happen only on a card: the ``gpu``-marked test at the end."""
import collections

import numpy as np
import pytest
import torch

from repro_torch import telemetry
from repro_torch.api import GraphStream, Query, QueryBatch
from repro_torch.core.queries import global_triangle_estimate
from repro_torch.core.sketch import SketchConfig
from repro_torch.fleet import SketchFleet

CONFIG = SketchConfig(depth=3, width_rows=64, width_cols=64, directed=True)
STANDING = QueryBatch([Query.edge(np.arange(8), np.arange(1, 9)), Query.in_flow(np.arange(8)),
                       Query.reach(np.arange(4), np.arange(4, 8))])
SESSION_SPANS = {"ingest", "ingest.codec", "ingest.preaggregate", "ingest.touched", "ingest.copy", "tick",
                 "tick.wait", "tick.results", "analytics.pagerank", "analytics.triangles"}
FLEET_SPANS = {"ingest", "ingest.codec", "ingest.route", "ingest.touched", "ingest.copy", "tick", "tick.wait",
               "tick.results"}


def _batches(seed, n=3, edges=2000, tenants=None):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = (rng.integers(0, 300, edges), rng.integers(0, 300, edges), rng.integers(1, 9, edges).astype(np.float32))
        out.append(b if tenants is None else (rng.integers(0, tenants, edges),) + b)
    return out


def _profiled(fn, device="cpu"):
    """``fn()`` under a profiler; returns its result and the window's records."""
    activity = torch.profiler.ProfilerActivity.CUDA if device == "cuda" else torch.profiler.ProfilerActivity.CPU
    prof = torch.profiler.profile(activities=[activity])
    prof.start()
    lo = telemetry.now_ns()
    try:
        out = fn()
    finally:
        hi = telemetry.now_ns()
        prof.stop()
    return out, telemetry.spans(lo, hi)


def _session_run(device="cpu", **kwargs):
    gs = GraphStream.open(CONFIG, seed=3, device=device, **kwargs)
    events = []
    gs.subscribe(STANDING, every=1, on_result=events.append)
    receipts = [gs.ingest(*b) for b in _batches(0)]
    gs.pagerank(iters=4)
    global_triangle_estimate(gs.sketch)
    return gs, receipts, events


def _fleet_run(device="cpu"):
    fleet = SketchFleet.open(CONFIG, capacity=4, seed=3, device=device)
    fleet.tenant(0).subscribe(STANDING, every=1)
    return fleet, [fleet.ingest_mixed(*b) for b in _batches(1, tenants=4)]


def test_spans_are_off_without_a_profiler(monkeypatch):
    """No profiler: a span is the one shared do-nothing object, no clock is
    read and nothing is recorded; receipts, events and counters are those
    of the same session traced."""
    assert telemetry.span("ingest") is telemetry.span("tick")

    def no_clock():
        raise AssertionError("a span read the clock with no profiler running")

    kept, dropped = len(telemetry._ring), telemetry.dropped()
    with monkeypatch.context() as m:
        m.setattr(telemetry, "_clock", no_clock)
        gs, receipts, events = _session_run()
    assert len(telemetry._ring) == kept and telemetry.dropped() == dropped

    (traced, traced_receipts, traced_events), records = _profiled(_session_run)
    assert records
    for a, b in zip(receipts, traced_receipts):
        assert (a.epoch, a.n_edges) == (b.epoch, b.n_edges)
        np.testing.assert_array_equal(a.touched_keys, b.touched_keys)
    for a, b in zip(events, traced_events):
        for ra, rb in zip(a.results, b.results):
            np.testing.assert_array_equal(np.asarray(ra.value), np.asarray(rb.value))
    for key in ("edges_ingested", "queries_served", "closure_refreshes", "closure_incremental_refreshes",
                "subscription_ticks"):
        assert getattr(gs.stats, key) == getattr(traced.stats, key), key
    assert gs.stats.ingest_s > 0 and gs.stats.query_s > 0
    torch.testing.assert_close(gs.sketch.counters, traced.sketch.counters, rtol=0, atol=0)


@pytest.mark.parametrize("path", ["session", "fleet"])
def test_every_span_nests_in_its_call(path):
    """Every span of the path appears; each child lies inside its parent,
    shares its call's trace (the epoch, or the fleet's batch count, after
    the batch), and ``tick`` is a child of ``ingest``."""
    if path == "session":
        (gs, receipts, _), records = _profiled(_session_run)
        want, traces = SESSION_SPANS, [r.epoch for r in receipts]
    else:
        (fleet, _), records = _profiled(_fleet_run)
        want, traces = FLEET_SPANS, list(range(fleet.stats.batches - 2, fleet.stats.batches + 1))
    assert {r.name for r in records} == want
    by_id = {r.id: r for r in records}
    roots = [r for r in records if r.parent == -1]
    assert [r.trace for r in roots if r.name == "ingest"] == traces
    for r in records:
        assert r.start_ns <= r.end_ns
        if r.parent == -1:
            assert r.name in ("ingest", "analytics.pagerank", "analytics.triangles")
            continue
        parent = by_id[r.parent]
        assert parent.start_ns <= r.start_ns and r.end_ns <= parent.end_ns
        root = parent
        while root.parent != -1:
            root = by_id[root.parent]
        assert r.trace == root.trace and root.name == "ingest"
        if r.name in ("tick", "ingest.codec", "ingest.preaggregate", "ingest.touched", "ingest.route",
                      "ingest.copy"):
            assert parent.name == "ingest"
        if r.name in ("tick.wait", "tick.results"):
            assert parent.name == "tick"
    assert sum(r.name == "tick" for r in records) == len(traces)


@pytest.mark.parametrize("path", ["session", "fleet"])
def test_refresh_span_names_each_incremental_refresh(path):
    """Small batches refresh the closure incrementally after the first
    tick's full build: one ``tick.refresh`` a refresh dispatch, a child of
    its ``tick``; none around the full build."""
    small = _batches(2, n=4, edges=6)
    if path == "session":
        def run():
            gs = GraphStream.open(CONFIG, seed=3, device="cpu")
            gs.subscribe(STANDING, every=1)
            for b in small:
                gs.ingest(*b)
            return gs.engine.closure_incremental_refreshes, gs.engine.closure_refreshes
    else:
        def run():
            fleet = SketchFleet.open(CONFIG, capacity=4, seed=3, device="cpu")
            for tenant in (0, 1):
                fleet.tenant(tenant).subscribe(STANDING, every=1)
            for b in small:
                fleet.ingest_mixed(np.arange(6) % 2, *b)
            return fleet.engine.dispatches["closure_refresh"], fleet.engine.dispatches["closure"]

    (refreshes, builds), records = _profiled(run)
    by_id = {r.id: r for r in records}
    spans = [r for r in records if r.name == "tick.refresh"]
    assert refreshes == len(small) - 1 and builds == 1
    assert len(spans) == refreshes and all(by_id[r.parent].name == "tick" for r in spans)


def test_span_names_are_declared():
    """Every name the port gives ``telemetry.span`` is in
    ``telemetry.NAMES``, which the benchmark's readers consult."""
    import pathlib
    import re

    import repro_torch

    root = pathlib.Path(repro_torch.__file__).parent
    used = {m for f in root.rglob("*.py") for m in re.findall(r'telemetry\.span\("([^"]+)"\)', f.read_text())}
    assert used == telemetry.NAMES


def test_kineto_events_lie_inside_their_span():
    """A CPU op run inside a span lies inside the span's ``[start_ns,
    end_ns]``: spans and the profiler's events share one clock."""
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    lo = telemetry.now_ns()
    with telemetry.span("outer"):
        torch.ones(4096).cumsum(0)
    hi = telemetry.now_ns()
    prof.stop()
    (record,) = [r for r in telemetry.spans(lo, hi) if r.name == "outer"]
    ops = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::cumsum"]
    assert ops
    for e in ops:
        assert record.start_ns <= e.start_ns() and e.start_ns() + e.duration_ns() <= record.end_ns


def test_ring_drops_the_oldest_and_counts_them(monkeypatch):
    monkeypatch.setattr(telemetry, "_ring", collections.deque(maxlen=3))
    monkeypatch.setattr(telemetry, "_dropped", 0)

    def five():
        for i in range(5):
            with telemetry.span(f"s{i}"):
                pass

    _, records = _profiled(five)
    assert [r.name for r in records] == ["s2", "s3", "s4"] and telemetry.dropped() == 2


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["session", "fleet"])
def test_inflight_wait_spans_on_the_card(path):
    """On a card, a batch past the in-flight bound waits inside
    ``ingest.wait``, a child of its ``ingest`` call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")

    def run():
        if path == "session":
            gs = GraphStream.open(CONFIG, seed=3, device="cuda", max_inflight=1)
            for b in _batches(0, n=4):
                gs.ingest(*b)
        else:
            fleet = SketchFleet.open(CONFIG, capacity=4, seed=3, device="cuda")
            fleet._ingest.max_inflight = 1
            for b in _batches(1, n=4, tenants=4):
                fleet.ingest_mixed(*b)
        torch.cuda.synchronize()

    _, records = _profiled(run, device="cuda")
    by_id = {r.id: r for r in records}
    waits = [r for r in records if r.name == "ingest.wait"]
    assert waits and all(by_id[r.parent].name == "ingest" for r in waits)
