"""The port's analysis plane (``repro_torch.analysis``, pass 1 and 2 and the
CLI), mirroring ``tests/test_analysis.py``: every rule gets a planted
violation and a clean twin, the baseline, the CLI and the registry are
exercised, and the port's own tree passes with its committed baseline.
The registry is held to the reference's (``repro.analysis.contracts``) up
to an explicit list of differences."""
import dataclasses
import json
import pathlib
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.analysis import (
    ENTRY_POINTS,
    EntryPoint,
    TracedEntry,
    lint_file,
    lint_tree,
    reduces_full_counters,
    run_dispatch_pass,
)
from repro_torch.analysis.contracts import (
    STEP_CELLS,
    Violation,
    apply_baseline,
    check_closure_cache_value_keyed,
    check_fleet_permutation,
    check_fleet_subscription_tick,
    check_kernel_libraries,
    check_subscription_tick,
    one_rank_group,
)
from repro_torch.analysis.dispatch_lint import check_entry_point
from repro_torch.analysis.runner import main, run_analysis

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC_PORT = ROOT / "src" / "repro_torch"
TESTS_DIR = ROOT / "tests"


def _rules(violations):
    return sorted({v.rule for v in violations})


def _ep(name, contracts, entry):
    return EntryPoint(name=name, contracts=contracts, build=lambda fx: entry)


# ---------------------------------------------------------------------------
# dispatch pass: one planted violation and one clean twin per contract
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dirty", [
    lambda x: x.sum().item(),
    lambda x: x.tolist(),
    lambda x: x.numpy(),
    lambda x: x.cpu(),
    lambda x: x[x > 1.0],
    lambda x: torch.nonzero(x),
    lambda x: torch.unique(x),
    lambda x: bool(x.sum() > 0),
], ids=["item", "tolist", "numpy", "cpu", "bool-index", "nonzero", "unique", "bool"])
def test_no_host_sync_positive(dirty):
    x = torch.arange(4.0)
    bad = check_entry_point(_ep("fix.sync", ("no-host-sync",), TracedEntry(dirty, (x,))))
    assert _rules(bad) == ["no-host-sync"]


def test_no_host_sync_negative():
    x = torch.arange(4.0)
    assert check_entry_point(_ep("fix.clean", ("no-host-sync",), TracedEntry(lambda a: (a + 1).amax(), (x,)))) == []


def test_no_wide_dtype_positive_and_negative():
    x = torch.ones(4)
    bad = check_entry_point(_ep("fix.wide", ("no-wide-dtype",), TracedEntry(lambda a: a.double() * 2.0, (x,))))
    assert _rules(bad) == ["no-wide-dtype"]
    # int64 meeting float work outside the index plane
    mixed = check_entry_point(_ep("fix.mixed", ("no-wide-dtype",), TracedEntry(lambda a: a + torch.arange(4), (x,))))
    assert _rules(mixed) == ["no-wide-dtype"]
    good = check_entry_point(_ep("fix.narrow", ("no-wide-dtype",), TracedEntry(lambda a: a * 2.0, (x,))))
    assert good == []
    # the index plane: int64 hash arithmetic, then int64 indices of a gather and an index_add_
    keys = torch.arange(8)

    def index_plane(a, k):
        idx = (k * 7 + 3) % 4
        return a.index_add_(0, idx, torch.ones(8)).gather(0, idx[:4])

    assert check_entry_point(_ep("fix.index", ("no-wide-dtype",), TracedEntry(index_plane, (x.clone(), keys)))) == []


def test_no_counter_reduction_positive_and_negative():
    counters = torch.ones((2, 8, 8))
    shape = (2, 8, 8)
    bad = check_entry_point(_ep("fix.reduce", ("no-counter-reduction",),
                                TracedEntry(lambda c: torch.sum(c), (counters,), counters_shape=shape)))
    assert _rules(bad) == ["no-counter-reduction"]
    good = check_entry_point(_ep("fix.gather", ("no-counter-reduction",),
                                 TracedEntry(lambda c: c[:, 0, 0], (counters,), counters_shape=shape)))
    assert good == []
    assert reduces_full_counters(lambda c: c.amax(dim=(1, 2)), shape, counters)
    assert not reduces_full_counters(lambda c: c[:, 0, :].sum(), shape, counters)


def test_collectives_only_in_the_distributed_plane():
    import torch.distributed as dist

    def reduce(a):
        dist.all_reduce(a)
        return a

    with one_rank_group("cpu"):
        bad = check_entry_point(_ep("fix.naked_all_reduce", ("collectives-in-distributed-plane",),
                                    TracedEntry(reduce, (torch.ones(4),))))
        good = check_entry_point(_ep("distributed.fix", ("collectives-in-distributed-plane",),
                                     TracedEntry(reduce, (torch.ones(4),))))
    assert _rules(bad) == ["collectives-in-distributed-plane"]
    assert good == []


def test_no_counter_copy_positive_and_negative():
    counters = torch.zeros((2, 8, 8))
    state = counters.numel() * 4
    bad = check_entry_point(_ep("fix.copy", ("no-counter-copy",),
                                TracedEntry(lambda c: c.clone().add_(1.0), (counters,), state_bytes=state)))
    assert _rules(bad) == ["no-counter-copy"]
    good = check_entry_point(_ep("fix.inplace", ("no-counter-copy",),
                                 TracedEntry(lambda c: c.add_(1.0), (counters,), state_bytes=state)))
    assert good == []


def test_kernel_wrapper_calls_are_opaque():
    """The plain version inside a kernel wrapper (which may sync on the CPU,
    as the sequential scan's range check does) is the kernel's: the dispatch
    pass leaves it to the card's run, and the cost pass counts the wrapper's
    declared cost."""
    from repro_torch.kernels.sequential.ops import sequential_update

    counters = torch.zeros((2, 8, 8))
    rows = torch.tensor([[1, 2], [3, 4]])
    entry = TracedEntry(lambda c: sequential_update(c, rows, rows, torch.ones(2), True), (counters,))
    assert check_entry_point(_ep("fix.kernel", ("no-host-sync",), entry)) == []


def test_broken_fixture_is_a_finding():
    def build(fx):
        raise RuntimeError("fixture exploded")

    found = check_entry_point(EntryPoint("fix.broken", ("no-host-sync",), build))
    assert _rules(found) == ["entry-point-broken"]


def test_dispatch_pass_respects_entry_point_override():
    counters = torch.ones((2, 8, 8))
    eps = (_ep("fix.reduce", ("no-counter-reduction",),
               TracedEntry(lambda c: torch.sum(c), (counters,), counters_shape=(2, 8, 8))),)
    assert _rules(run_dispatch_pass(eps)) == ["no-counter-reduction"]
    report = run_analysis(("dispatch",), entry_points=eps, baseline={})
    assert not report["ok"] and [v["rule"] for v in report["violations"]] == ["no-counter-reduction"]


# ---------------------------------------------------------------------------
# dynamic checks: the port passes, planted faults are caught
# ---------------------------------------------------------------------------


def test_dynamic_checks_pass_on_the_port():
    for check in (check_kernel_libraries, check_closure_cache_value_keyed, check_subscription_tick,
                  check_fleet_permutation, check_fleet_subscription_tick):
        assert check("cpu") == [], check.__name__


def test_kernel_library_loaded_twice_is_flagged(monkeypatch):
    from repro_torch.kernels import build

    monkeypatch.setitem(build.load_counts, "query", 2)
    found = check_kernel_libraries("cpu")
    assert _rules(found) == ["retrace"] and found[0].subject == "kernels.query"


def test_identity_keyed_closure_cache_is_flagged(monkeypatch):
    from repro_torch.core.query_engine import QueryEngine

    monkeypatch.setattr(QueryEngine, "_family_key", staticmethod(lambda sk: id(sk.row_hash)))
    assert _rules(check_closure_cache_value_keyed("cpu")) == ["retrace"]


def test_full_rebuild_every_tick_is_flagged(monkeypatch):
    from repro_torch.core.query_engine import QueryEngine

    monkeypatch.setattr(QueryEngine, "refresh_closure",
                        lambda self, sk, touched, epoch=None: self.closure_for(sk, epoch))
    found = check_subscription_tick("cpu")
    assert _rules(found) == ["retrace"] and len(found) == 2


def test_fleet_dispatch_per_tenant_is_flagged(monkeypatch):
    from repro_torch.fleet.ingest import FleetIngestEngine

    inner = FleetIngestEngine.dispatch

    def twice(self, state, slots, src, dst, weights):
        inner(self, state, slots[:0], src[:0], dst[:0], weights[:0])
        return inner(self, state, slots, src, dst, weights)

    monkeypatch.setattr(FleetIngestEngine, "dispatch", twice)
    assert _rules(check_fleet_permutation("cpu")) == ["retrace"]
    assert _rules(check_fleet_subscription_tick("cpu")) == ["retrace"]


# ---------------------------------------------------------------------------
# source pass: fixture trees, one rule each
# ---------------------------------------------------------------------------


def _write(tmp_path, rel, body):
    p = tmp_path / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(body))
    return p


def test_no_compile_rule(tmp_path):
    bad = _write(tmp_path, "core/adhoc.py", """
        import torch

        def f(fn):
            return torch.compile(fn)
        """)
    assert _rules(lint_file(bad, "core/adhoc.py")) == ["no-compile"]
    scripted = _write(tmp_path, "api/adhoc.py", """
        import torch

        def f(fn):
            return torch.jit.script(fn)
        """)
    assert _rules(lint_file(scripted, "api/adhoc.py")) == ["no-compile"]
    clean = _write(tmp_path, "core/clean.py", """
        import torch

        def f(x):
            return torch.sum(x)
        """)
    assert lint_file(clean, "core/clean.py") == []


def test_host_sync_rule(tmp_path):
    bad = _write(tmp_path, "kernels/foo/ops.py", """
        def f(x):
            return x.item()
        """)
    assert _rules(lint_file(bad, "kernels/foo/ops.py")) == ["host-sync"]
    bad_cpu = _write(tmp_path, "core/reach_bad.py", """
        import torch

        def f(x):
            torch.cuda.synchronize()
            return x.cpu().numpy()
        """)
    found = lint_file(bad_cpu, "core/reach.py")
    assert _rules(found) == ["host-sync"] and len(found) == 3
    # api/ modules stage host<->device transfers by design: out of scope
    assert lint_file(bad, "api/stream.py") == []
    clean = _write(tmp_path, "kernels/foo/clean_ops.py", """
        import torch

        def f(x):
            return torch.sum(x)
        """)
    assert lint_file(clean, "kernels/foo/clean_ops.py") == []


def test_torch_in_loop_rule(tmp_path):
    bad = _write(tmp_path, "core/hot.py", """
        import torch
        import torch.nn.functional as F

        def f(xs):
            out = []
            for x in xs:
                out.append(F.pad(torch.sum(x), (0, 1)))
            return out
        """)
    found = lint_file(bad, "core/hot.py")
    assert _rules(found) == ["torch-in-loop"] and len(found) == 2
    launches = _write(tmp_path, "kernels/k/ops.py", """
        def f(a, n):
            while n:
                a = closure_step(a)
                n -= 1
            return a
        """)
    assert _rules(lint_file(launches, "kernels/k/ops.py", frozenset({"closure_step"}))) == ["torch-in-loop"]
    assert lint_file(launches, "kernels/k/ops.py") == []
    clean = _write(tmp_path, "core/cold.py", """
        import torch

        def f(xs):
            return torch.sum(torch.stack(list(xs)))
        """)
    assert lint_file(clean, "core/cold.py") == []
    # api/ is not a hot module for this rule
    assert lint_file(bad, "api/hot.py") == []


def test_env_read_rule(tmp_path):
    bad = _write(tmp_path, "api/cfg.py", """
        import os

        def f():
            return os.environ.get("REPRO_QUERY_BACKEND", "")
        """)
    assert _rules(lint_file(bad, "api/cfg.py")) == ["env-read"]
    bad_sub = _write(tmp_path, "api/cfg2.py", """
        import os

        def f():
            return os.environ["HOME"], os.getenv("CUDA_HOME")
        """)
    assert len(lint_file(bad_sub, "api/cfg2.py")) == 2
    toolkit = _write(tmp_path, "kernels/build.py", """
        import os

        def f():
            return os.environ.get("CUDA_HOME")
        """)
    assert lint_file(toolkit, "kernels/build.py") == []
    assert _rules(lint_file(bad, "kernels/build.py")) == ["env-read"]


def test_kernel_ref_rule(tmp_path):
    root = tmp_path / "src" / "pkg"
    tests = tmp_path / "tests"
    _write(root, "csrc/newk.cu", "// kernel\n")
    _write(root, "kernels/newk/ops.py", "def op():\n    return 0\n")
    _write(tests, "test_torch_other.py", "# no imports of newk\n")
    _write(tests, "test_torch_gpu.py", "# no imports of newk\n")
    _write(tmp_path, "chip_smoke.py", "# no phase\n")
    found = lint_tree(root, tests)
    assert _rules(found) == ["kernel-ref"]
    # no ref.py, no CPU parity test, the card's test imports neither, no smoke phase
    assert len(found) == 5

    _write(root, "kernels/newk/ref.py", "def ref():\n    return 0\n")
    _write(tests, "test_torch_other.py", "from pkg.kernels.newk.ref import ref\n")
    _write(tests, "test_torch_gpu.py", "from pkg.kernels.newk import ops, ref\n")
    _write(tmp_path, "chip_smoke.py", "from pkg.kernels.newk import ops\n")
    assert lint_tree(root, tests) == []


def test_kernel_wrappers_are_found():
    from repro_torch.analysis.source_lint import kernel_wrappers

    assert {"ingest_scatter", "ingest_keys", "closure_step", "transitive_closure", "edge_query_min",
            "edge_query_cells", "flows", "fused_ingest", "stacked_ingest", "countsketch", "countsketch_family",
            "countsketch_median", "sequential_update", "preagg_collapse", "bool_product",
            "byte_transpose"} == kernel_wrappers(SRC_PORT)


# ---------------------------------------------------------------------------
# baseline + CLI + the gate on the port's own tree
# ---------------------------------------------------------------------------


def test_baseline_marks_but_keeps_violations():
    v = Violation(rule="no-compile", subject="core/x.py::f:3", message="m", pass_name="source")
    out = apply_baseline([v], {("no-compile", "core/x.py::f:3"): "why"})
    assert out[0].baselined and out[0].justification == "why"
    assert not apply_baseline([v], {("no-compile", "core/other.py::f:3"): "why"})[0].baselined


def test_cli_exit_codes_and_json_report(tmp_path):
    bad_root = tmp_path / "pkg"
    _write(bad_root, "core/adhoc.py", """
        import torch

        def f(fn):
            return torch.compile(fn)
        """)
    report_path = tmp_path / "report.json"
    rc = main(["--passes", "source", "--root", str(bad_root), "--json", "--output", str(report_path)])
    assert rc == 1
    report = json.loads(report_path.read_text())
    assert not report["ok"]
    assert report["counts"]["violations"] == 1
    assert report["violations"][0]["rule"] == "no-compile"

    clean_root = tmp_path / "pkg2"
    _write(clean_root, "core/clean.py", "def f():\n    return 0\n")
    assert main(["--passes", "source", "--root", str(clean_root)]) == 0


@pytest.mark.parametrize("rel,body,rule", [
    ("core/a.py", "import torch\n\ndef f(fn):\n    return torch.compile(fn)\n", "no-compile"),
    ("kernels/k/ops.py", "def f(x):\n    return x.tolist()\n", "host-sync"),
    ("core/b.py", "import torch\n\ndef f(xs):\n    for x in xs:\n        torch.sum(x)\n", "torch-in-loop"),
    ("api/c.py", "import os\n\ndef f():\n    return os.getenv('X')\n", "env-read"),
], ids=["no-compile", "host-sync", "torch-in-loop", "env-read"])
def test_cli_names_each_planted_source_rule(tmp_path, rel, body, rule):
    root = tmp_path / "pkg"
    _write(root, rel, body)
    out = tmp_path / "r.json"
    assert main(["--passes", "source", "--root", str(root), "--output", str(out)]) == 1
    assert [v["rule"] for v in json.loads(out.read_text())["violations"]] == [rule]


def test_stale_baseline_warns_and_prunes(tmp_path):
    from repro_torch.analysis.baseline import load_baseline

    clean_root = tmp_path / "pkg"
    _write(clean_root, "core/clean.py", "def f():\n    return 0\n")
    bl = tmp_path / "baseline.json"
    bl.write_text(json.dumps([
        {"rule": "no-compile", "subject": "core/gone.py::f:1", "justification": "code was deleted"},
    ]))
    report = run_analysis(("source",), root=clean_root, baseline=load_baseline(bl))
    assert report["ok"]
    assert report["stale_baseline"] == [["no-compile", "core/gone.py::f:1"]]
    assert report["counts"]["stale_baseline"] == 1
    # the rule's pass did NOT run: staleness is undecidable, no warning
    report2 = run_analysis(("dispatch",), root=clean_root, entry_points=(), baseline=load_baseline(bl))
    assert report2["stale_baseline"] == []
    assert main(["--passes", "source", "--root", str(clean_root), "--baseline", str(bl), "--prune-baseline"]) == 0
    assert json.loads(bl.read_text()) == []


def test_live_baseline_entry_is_not_stale(tmp_path):
    from repro_torch.analysis.baseline import load_baseline

    root = tmp_path / "pkg"
    _write(root, "core/adhoc.py", """
        import torch

        def f(fn):
            return torch.compile(fn)
        """)
    bl = tmp_path / "baseline.json"
    bl.write_text(json.dumps([
        {"rule": "no-compile", "subject": "core/adhoc.py::f:5", "justification": "still here"},
    ]))
    report = run_analysis(("source",), root=root, baseline=load_baseline(bl))
    assert report["ok"] and report["stale_baseline"] == []
    assert report["counts"]["baselined"] == 1


def test_committed_baseline_loads_and_maps_rules():
    from repro_torch.analysis.baseline import BASELINE, RULE_PASS

    assert BASELINE, "committed baseline.json must load"
    for (rule, _subject), why in BASELINE.items():
        assert rule in RULE_PASS, f"rule {rule} missing from RULE_PASS"
        assert why.strip(), "every baseline entry carries a justification"


def test_the_three_findings_stand_baselined():
    """The per-batch shard clone, the refresh's host copy and the host-side
    squaring loop are found and baselined, not silently passed."""
    report = run_analysis(("dispatch", "source"), root=SRC_PORT, tests_dir=TESTS_DIR)
    got = {(v["rule"], v["subject"]) for v in report["violations"] if v["baselined"]}
    assert ("no-counter-copy", "distributed.ingest") in got
    assert ("no-host-sync", "query.closure_refresh") in got
    assert any(r == "torch-in-loop" and s.startswith("kernels/closure/ops.py::transitive_closure") for r, s in got)


def test_port_tree_passes_with_committed_baseline_and_budgets(tmp_path):
    """The gate: every pass over the real tree, zero unbaselined violations,
    no stale baseline entry; the CLI exits 0."""
    out = tmp_path / "report.json"
    rc = main(["--output", str(out)])
    report = json.loads(out.read_text())
    new = [v for v in report["violations"] if not v["baselined"]]
    assert rc == 0 and report["ok"], "\n".join(f"{v['rule']} {v['subject']}: {v['message']}" for v in new)
    assert report["stale_baseline"] == []
    assert report["counts"]["entry_points"] == len(ENTRY_POINTS) >= 44
    assert report["counts"]["cost_entry_points"] == 12


# ---------------------------------------------------------------------------
# registry parity with the reference
# ---------------------------------------------------------------------------

# The port's entry names against the reference's: the onehot backend is not
# ported (an MXU formulation, src/repro_torch/core/ingest.py), the Pallas
# backends are the CUDA ones, and five kernel entries are the port's own.
REMOVED = {"ingest.onehot", "ingest.pallas", "query.edge.pallas"}
ADDED = {"ingest.cuda", "query.edge.cuda", "kernels.ingest.keys", "kernels.ingest_stacked.ops",
         "kernels.sequential.ops", "kernels.countsketch.median", "kernels.preagg.ops", "kernels.boolmm.ops",
         # the step builder's steps (launch/steps.py), which the reference does not register
         *(f"steps.{name}" for name, _, _ in STEP_CELLS)}
RENAMED = {"ingest.pallas": "ingest.cuda", "query.edge.pallas": "query.edge.cuda"}
CONTRACT_MAP = {
    "no-host-callback": "no-host-sync",
    "no-wide-dtype": "no-wide-dtype",
    "no-counter-reduction": "no-counter-reduction",
    "collectives-under-shard-map": "collectives-in-distributed-plane",
    "donation-applied": "no-counter-copy",
}


def test_entry_point_names_match_the_reference_up_to_listed_differences():
    from repro.analysis import contracts as ref

    ref_names = {ep.name for ep in ref.ENTRY_POINTS}
    port_names = [ep.name for ep in ENTRY_POINTS]
    assert len(port_names) == len(set(port_names))
    assert set(port_names) == (ref_names - REMOVED) | ADDED


def test_entry_point_contracts_map_the_reference():
    from repro.analysis import contracts as ref

    port = {ep.name: set(ep.contracts) for ep in ENTRY_POINTS}
    for ep in ref.ENTRY_POINTS:
        name = RENAMED.get(ep.name, ep.name)
        if name not in port:
            continue
        mapped = {CONTRACT_MAP[c] for c in ep.contracts}
        assert mapped <= port[name], name
        extra = port[name] - mapped
        assert not extra or (name, extra) == ("distributed.ingest", {"no-counter-copy"}), (name, extra)


def test_entries_build_at_another_fixture():
    """The registry builds at other sizes (the card runs BASE): a wider,
    deeper fixture on the CPU keeps every entry clean but the baselined."""
    from repro_torch.analysis.baseline import BASELINE
    from repro_torch.analysis.contracts import FIXTURE

    fx = dataclasses.replace(FIXTURE, depth=3, width=128, batch=16)
    found = [v for v in apply_baseline(run_dispatch_pass(fixture=fx, dynamic=False), BASELINE) if not v.baselined]
    assert found == [], "\n".join(v.render() for v in found)


def test_entries_compute_what_the_engines_compute():
    """A session entry is the session's real boundary: the probe's update
    lands in the session's counters as GraphStream.ingest would put it."""
    from repro_torch.api.stream import GraphStream

    fn, args, shape = GraphStream.cost_probe_update(batch=8)
    fn(*args)
    ref = GraphStream.open(fn.__self__.config, device="cpu")
    ref.ingest(np.arange(8, dtype=np.uint32), np.arange(8, 16, dtype=np.uint32))
    assert torch.equal(fn.__self__._sketch.counters, ref._sketch.counters)
