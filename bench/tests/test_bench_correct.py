"""``correct`` is decided by a comparison shown to fail: the control (the
reference one precision step low) comes out not correct, and so does a run
driven with the timed path broken underneath it, once for each fault a cell
can have (a step that leaves the state unchanged; half of each batch left
out with the rest weighted double; an answer altered where it is made; one
card, so no exchange between cards to leave out), with half of the due
answers never delivered, and, in the reach cells, with no closure handed to
the check.  A sound run comes out correct.  The cells are cut to the SMOKE size (``small.py``) and run on the
CPU, past the harness's look for a card."""
import dataclasses
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from bench import control
from bench.harness import cell as cell_mod
from bench.harness import spec
from bench.tests.small import small_cell

CELLS = [w["name"] for w in spec.load_json(spec.REPO / "BENCHMARK.json")["workloads"]]
SEED = 2**31 + 4242


def _run(name):
    return cell_mod.run(small_cell(name, rate=5e6), SEED, 0.5, False, "cpu", time.time())


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = _run(cell)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks" and res["metrics"]["ingest_edges_per_s"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    c = small_cell(cell)
    variants = spec.plugin("reference", c.config["reference"]).controls(c)
    assert len(variants) == (2 if "dashboard" in c.traffic else 1)
    for low in variants.values():
        res = control.run(c, SEED, 24, "cpu", low)
        assert not res["correct"], res["checks"]


def _unchanged(mp):
    from repro_torch.core.sketch import GLavaSketch
    from repro_torch.fleet.stack import FleetSketch

    for cls, name in ((GLavaSketch, "update_"), (GLavaSketch, "update_preaggregated_"), (FleetSketch, "update_")):
        mp.setattr(cls, name, lambda self, *a, **k: self)


def _half_batch(mp):
    from repro_torch.api import GraphStream
    from repro_torch.fleet import SketchFleet

    ingest, mixed = GraphStream.ingest, SketchFleet.ingest_mixed
    mp.setattr(GraphStream, "ingest", lambda self, s, d, w, **k: ingest(self, s[::2], d[::2], 2 * w[::2], **k))
    mp.setattr(SketchFleet, "ingest_mixed",
               lambda self, t, s, d, w, **k: mixed(self, t[::2], s[::2], d[::2], 2 * w[::2], **k))


def _answer_altered(mp):
    from repro_torch.api import planner
    from repro_torch.core import queries

    run = planner.CompiledPlan.run

    def altered(self, *a, **k):
        results = run(self, *a, **k)
        results[0].value[0] += 1  # the first edge answer
        return results

    mp.setattr(planner.CompiledPlan, "run", altered)
    pagerank = queries.sketch_pagerank
    mp.setattr(queries, "sketch_pagerank", lambda *a, **k: pagerank(*a, **k) * 1.001)


def _answers_never_come(mp):
    from repro_torch.api.subscription import Subscription

    deliver = Subscription._deliver
    mp.setattr(Subscription, "_deliver", lambda self, ev: ev.tick % 2 == 0 and deliver(self, ev))


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _answer_altered, _answers_never_come],
                         ids=lambda f: f.__name__[1:])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    res = _run(cell)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", [c for c in CELLS if small_cell(c).traffic["standing"].get("reach")])
def test_missing_closure_is_not_correct(cell, monkeypatch):
    """A closure the check cannot find counts as wrong in every entry."""
    drv = spec.driver(small_cell(cell).config["driver"])
    outputs = drv.outputs
    monkeypatch.setattr(drv, "outputs", lambda self: dataclasses.replace(outputs(self), closures={}))
    res = _run(cell)
    assert not res["correct"] and res["checks"]["closure_miss"]["value"] >= 3 * 256 * 256, res["checks"]


@pytest.mark.gpu
def test_cell_on_the_card():
    """One short run of each cell on the card, through the command."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for name in CELLS:
        out = subprocess.run([sys.executable, str(spec.BENCH / "run.py"), "--workload", name, "--seed", str(SEED),
                              "--seconds", "2", "--trace", "0"], capture_output=True, text=True, timeout=600,
                             cwd=spec.REPO, env=dict(os.environ), check=True)
        assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
