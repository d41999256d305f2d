"""The port's cost plane (``repro_torch.analysis.costlint``), mirroring the
costlint half of ``tests/test_analysis.py``: the counter's rules, the
exponent fits against declared ceilings, planted quadratic and tenant-wide
twins, the memory side of the in-place update, budgets and their ratchet;
and parity with the reference: the same twelve cost entries and, on the B,
Q, T, K and S axes, the reference's measured exponents on this host within
each entry's tol."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.analysis import COST_ENTRY_POINTS, AxisContract, CostEntryPoint, CostProbe
from repro_torch.analysis.costlint import (
    CostCounter,
    _fit_exponent,
    load_budgets,
    measure_entry,
    run_cost_pass,
)
from repro_torch.analysis.dispatch_lint import Recorder
from repro_torch.analysis.runner import main


def _rules(violations):
    return sorted({v.rule for v in violations})


def _count(fn, *args):
    counter = CostCounter()
    with Recorder(counter):
        fn(*args)
    return counter


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------


def test_counter_rules_by_op_kind():
    a, b = torch.ones(3, 4), torch.ones(4, 5)
    assert _count(torch.mm, a, b).work == 2 * 3 * 4 * 5
    assert _count(torch.bmm, torch.ones(2, 3, 4), torch.ones(2, 4, 5)).work == 2 * 2 * 3 * 4 * 5
    assert _count(lambda x: x.sum(), torch.ones(6, 7)).work == 42
    assert _count(lambda x: x * 2.0, torch.ones(6, 7)).work == 42
    assert _count(lambda x: x.view(42), torch.ones(6, 7)).work == 0
    dest, idx = torch.zeros(100), torch.tensor([1, 5, 5])
    c = _count(lambda: dest.index_add_(0, idx, torch.ones(3)))
    assert c.work >= 3 and c.bytes > 0
    g = _count(lambda x: x[torch.tensor([0, 2])], torch.ones(10, 4))
    assert g.work == 8
    assert _count(torch.empty, 1000).work == 0


def test_counter_tracks_fresh_allocations():
    x = torch.zeros(1000)
    c = _count(lambda t: t.clone().add_(1.0), x)
    assert c.max_alloc_bytes == 4000 and c.alloc_bytes == 4000 and c.peak_live_bytes >= 4000
    assert _count(lambda t: t.add_(1.0), x).alloc_bytes == 0


def test_kernel_wrappers_count_their_declared_cost_on_the_cpu():
    """A wrapper's call counts its declared work whichever backend runs, and
    none of its plain version's ops: the card's trace counts the same."""
    from repro_torch.kernels.ingest.ops import ADD_BYTES, ingest_scatter
    from repro_torch.kernels.query.ops import edge_query_min

    counters = torch.zeros(3, 16, 16)
    rows = torch.randint(0, 16, (3, 10))
    cols = torch.randint(0, 16, (3, 10))
    c = _count(ingest_scatter, counters, rows, cols, torch.ones(10))
    assert (c.work, c.bytes) == (30, 30 * (ADD_BYTES + 2 * 8) + 40)
    assert [k[0] for k in c.kernels] == ["ingest_scatter"]
    q = _count(edge_query_min, counters, rows, cols)
    assert q.work == 30 and [k[0] for k in q.kernels] == ["edge_query_min"]


# ---------------------------------------------------------------------------
# exponent fits and planted twins
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sizes,values", [
    ((2, 4, 8), (7.0, 7.0, 7.0)),
    ((2, 4), (10.0, 40.0)),
    ((2, 4), (0.0, 0.0)),
    ((32, 64, 128), (1.0e3, 2.1e3, 3.9e3)),
    ((64, 128, 256), (5.5, 120.0, 9.0e4)),
])
def test_fit_exponent_matches_the_reference(sizes, values):
    from repro.analysis.costlint import _fit_exponent as ref_fit

    assert _fit_exponent(sizes, values) == pytest.approx(ref_fit(sizes, values), abs=1e-12)


def test_fit_exponent_basics():
    assert _fit_exponent((2, 4, 8), (7.0, 7.0, 7.0)) == pytest.approx(0.0)
    assert _fit_exponent((2, 4), (10.0, 40.0)) == pytest.approx(2.0)
    assert _fit_exponent((2, 4), (0.0, 0.0)) == pytest.approx(0.0)


def test_planted_quadratic_ingest_fails_B_contract():
    """An ingest twin with a hidden O(B²) pairwise coupling blows the
    declared O(B) work exponent."""
    from repro_torch.core.ingest import ingest
    from repro_torch.core.sketch import GLavaSketch, SketchConfig

    def build(B=64, device="cpu"):
        sk = GLavaSketch.empty(SketchConfig(depth=2, width_rows=64, width_cols=64), 0)
        src = torch.arange(B)
        rows, cols = sk.hash_edges(src, src + B)

        def bad(c, r, cc, ww):
            sim = torch.sum(ww[:, None] * ww[None, :], dim=1)  # O(B²)
            return ingest(c, r, cc, ww + 1e-9 * sim, backend="cuda")

        return CostProbe(fn=bad, args=(sk.counters, rows, cols, torch.ones(B)), state_bytes=4 * 2 * 64 * 64)

    ep = CostEntryPoint("fix.cost.quadratic_ingest", (AxisContract("B", 1.0, (64, 128, 256)),), build)
    violations, meas = run_cost_pass([ep], check_budgets=False)
    assert _rules(violations) == ["cost-exponent"]
    assert violations[0].subject == "fix.cost.quadratic_ingest[B]"
    assert meas[0]["axes"][0]["measured"] > 1.35


def test_planted_tenant_wide_reduction_fails_T_contract():
    """A fleet query twin that also scans the whole tenant stack blows the
    declared O(1)-in-T work exponent."""
    from repro_torch.fleet.query import FleetQueryEngine

    def build(T=2, device="cpu"):
        fn, args, shape = FleetQueryEngine.family_probe("in_flow", tenants=T, width=64, depth=2, n_queries=32)

        def bad(state, *rest):
            return fn(state, *rest) + 1e-9 * torch.sum(state.counters)

        return CostProbe(fn=bad, args=args, state_bytes=4 * int(np.prod(shape)))

    ep = CostEntryPoint("fix.cost.tenant_scan", (AxisContract("T", 0.0, (2, 8)),), build)
    violations, meas = run_cost_pass([ep], check_budgets=False)
    assert _rules(violations) == ["cost-exponent"]
    assert violations[0].subject == "fix.cost.tenant_scan[T]"
    assert meas[0]["axes"][0]["measured"] > 0.35


def test_donation_memory_proof_positive_and_negative():
    """A "boundary" that copies its counters holds the state's bytes fresh:
    cost-donation-memory; the real session boundary updates in place."""
    def build(w=64, device="cpu"):
        counters = torch.ones((2, w, w))
        return CostProbe(fn=lambda c: c.clone().mul_(2.0).add_(1.0), args=(counters,), state_bytes=4 * 2 * w * w)

    copying = CostEntryPoint("fix.cost.copying", (AxisContract("w", 3.0, (32, 64), tol=1.0),), build, donated=True)
    violations, _ = run_cost_pass([copying], check_budgets=False)
    assert _rules(violations) == ["cost-donation-memory"]
    assert "copies the counters" in violations[0].message

    real = next(ep for ep in COST_ENTRY_POINTS if ep.name == "cost.ingest.jit_boundary")
    clean, _ = run_cost_pass([real], check_budgets=False)
    assert clean == []


def test_broken_probe_is_a_finding_not_a_crash():
    def build(Q=8, device="cpu"):
        raise RuntimeError("probe exploded")

    ep = CostEntryPoint("fix.cost.broken", (AxisContract("Q", 1.0, (8, 16)),), build)
    violations, meas = run_cost_pass([ep], check_budgets=False)
    assert _rules(violations) == ["cost-entry-broken"]
    assert meas == []


# ---------------------------------------------------------------------------
# budgets
# ---------------------------------------------------------------------------


def test_cost_registry_passes_committed_budgets():
    """Every registry entry measured at >=2 sizes an axis, every exponent
    within its contract, every committed ceiling honoured."""
    budgets = load_budgets()
    assert budgets is not None, "src/repro_torch/analysis/budgets.json must be committed"
    violations, measurements = run_cost_pass(budgets=budgets)
    assert violations == [], "\n".join(v.render() for v in violations)
    assert len(measurements) == len(COST_ENTRY_POINTS) == 12
    for m in measurements:
        for fit in m["axes"]:
            assert len(fit["sizes"]) >= 2 and len(fit["values"]) >= 2


def test_budget_ratchet_roundtrip(tmp_path):
    """update -> clean run passes -> hand-shrunk ceiling -> exit 1 with a
    readable regression."""
    budgets = tmp_path / "budgets.json"
    entry = "cost.ingest.jit_boundary"
    assert main(["--update-budgets", "--cost-entries", entry, "--budgets", str(budgets)]) == 0
    data = json.loads(budgets.read_text())
    assert set(data["entries"][entry]) == {"peak_bytes", "bytes_per_edge", "work_per_edge"}
    # a filtered update must not ratchet the full-registry trace count
    assert "trace_count" not in data
    assert main(["--passes", "costlint", "--cost-entries", entry, "--budgets", str(budgets)]) == 0

    for key in ("peak_bytes", "work_per_edge"):
        shrunk = json.loads(json.dumps(data))
        shrunk["entries"][entry][key] = 1
        budgets.write_text(json.dumps(shrunk))
        report_path = tmp_path / "report.json"
        rc = main(["--passes", "costlint", "--cost-entries", entry, "--budgets", str(budgets),
                   "--format", "json", "--output", str(report_path)])
        assert rc == 1
        bad = [v for v in json.loads(report_path.read_text())["violations"] if v["rule"] == "cost-budget"]
        assert bad and "exceeds committed ceiling" in bad[0]["message"]


def test_missing_budgets_file_is_a_violation(tmp_path):
    violations, _ = run_cost_pass([], budgets=None, full_registry=False)
    assert _rules(violations) == ["cost-budget"]
    assert violations[0].subject == "budgets.json"
    assert main(["--passes", "costlint", "--cost-entries", "cost.query.in_flow",
                 "--budgets", str(tmp_path / "none.json")]) == 1


def test_cost_table_renders():
    from repro_torch.analysis.costlint import cost_table_markdown

    _, meas = run_cost_pass([COST_ENTRY_POINTS[0]], check_budgets=False)
    table = cost_table_markdown(meas)
    assert "| cost.ingest.scatter | B | work | O(n^1)+0.35 | 1.00 |" in table
    assert "B/edge @ 256 edges" in table


# ---------------------------------------------------------------------------
# parity with the reference's registry and exponents
# ---------------------------------------------------------------------------


def test_cost_registry_matches_the_reference():
    from repro.analysis import contracts as ref

    assert [ep.name for ep in COST_ENTRY_POINTS] == [ep.name for ep in ref.COST_ENTRY_POINTS]
    for mine, theirs in zip(COST_ENTRY_POINTS, ref.COST_ENTRY_POINTS):
        assert [(a.axis, a.exponent, a.sizes, a.tol) for a in mine.axes] == \
               [(a.axis, a.exponent, a.sizes, a.tol) for a in theirs.axes], mine.name
        assert (mine.donated, mine.edges_axis) == (theirs.donated, theirs.edges_axis), mine.name


@pytest.fixture(scope="module")
def port_measurements():
    return {m["entry"]: m for m in run_cost_pass(check_budgets=False)[1]}


@pytest.mark.parametrize("name", [ep.name for ep in COST_ENTRY_POINTS])
def test_port_exponents_within_ceilings_and_the_references(name, port_measurements):
    """Every port exponent within its declared ceiling; on the B, Q, T, K
    and S axes within ``tol`` of the reference's ``measure_entry`` on this
    host (the reference traced without its w axis, which this comparison
    does not read)."""
    from repro.analysis import contracts as ref
    from repro.analysis.costlint import measure_entry as ref_measure

    mine = port_measurements[name]
    assert all(fit["ok"] for fit in mine["axes"]), mine["axes"]
    theirs = next(ep for ep in ref.COST_ENTRY_POINTS if ep.name == name)
    axes = tuple(a for a in theirs.axes if a.axis != "w")
    if not axes:
        return
    ref_fits = {f["axis"]: f["measured"] for f in ref_measure(dataclasses.replace(theirs, axes=axes))["axes"]}
    for fit in mine["axes"]:
        if fit["axis"] in ref_fits:
            assert abs(fit["measured"] - ref_fits[fit["axis"]]) <= fit["tol"], (name, fit["axis"], ref_fits)


def test_measure_entry_on_cpu_names_its_device():
    m = measure_entry(COST_ENTRY_POINTS[4])
    assert m["device"] == "cpu" and m["traces"] == 3
