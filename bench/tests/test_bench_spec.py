"""The benchmark's files: every cell resolves by name, BENCHMARK.json keeps
the contract's shape, and a new cell, configuration, mix and metric are
found as new files alone."""
import json
import re
import shutil

import pytest

from bench.harness import spec

BENCHMARK = spec.load_json(spec.REPO / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCHMARK["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    c = spec.resolve(BENCHMARK, cell)
    assert c.chips == 1
    assert spec.driver(c.config["driver"]).__name__ == "Driver"
    assert callable(spec.plugin("generator", c.traffic["generator"]).make)
    assert callable(spec.plugin("loop", c.traffic["loop"]).run)
    reference = spec.plugin("reference", c.config["reference"])
    assert callable(reference.compare) and callable(reference.control_outputs) and reference.controls(c)
    for m in c.end_to_end:
        assert callable(spec.reader(m["name"]))
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "ingest_edges_per_s"}
    assert c.per_layer
    for m in c.per_layer:
        assert callable(spec.reader(m["name"]))
    assert set(c.workload["limits"]) >= {"exact_miss", "rel_gap"}


def test_contract_shape():
    b = BENCHMARK
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["bench"] and b["command"] == ["python3", "bench/run.py"]
    assert 1 <= b["run_seconds"] <= 51 and len(json.dumps(b)) < 64 * 1024
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    names = [x["name"] for x in b["configs"] + b["workloads"]] + list(e2e) + [m["name"] for m in b["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert spec.load_json(spec.REPO / c["file"])["name"] == c["name"]
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        moved = e2e[m["moves"]]
        # Every cell a per-layer metric lists reports the metric it moves.
        assert set(m["workloads"]) <= set(moved.get("workloads", CELLS))
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for cell in CELLS:
        reported = [m for m in b["end_to_end"] if spec.applies(m, cell)]
        assert len(reported) >= 2 and any(spec.applies(m, cell) for m in b["per_layer"])


def test_new_files_alone_make_a_new_cell(tmp_path):
    """A cell, configuration, traffic mix, per-layer metric and loop added as
    new files (and entries in BENCHMARK.json) resolve with no file edited."""
    root = tmp_path / "bench"
    for sub in ("configs", "traffic", "workloads", "metrics", "harness"):
        shutil.copytree(spec.BENCH / sub, root / sub)
    config = spec.load_json(spec.BENCH / "configs" / "glava-base.json") | {"name": "glava-wide"}
    (root / "configs" / "glava-wide.json").write_text(json.dumps(config))
    mix = spec.load_json(spec.BENCH / "traffic" / "reach-50k.json")
    mix["stream"]["batch"] = 200
    mix["loop"] = "paced"
    (root / "harness" / "loops" / "paced.py").write_text(
        "def run(drv, seconds, t0):\n    return drv.step(due_ns=0)\n")
    (root / "traffic" / "reach-200.json").write_text(json.dumps(mix))
    (root / "workloads" / "wide-reach-200.json").write_text(json.dumps({"limits": {"exact_miss": 0}}))
    (root / "metrics" / "batches_per_s.py").write_text(
        "def read(ctx):\n    return (ctx.after['batches'] - ctx.before['batches']) / ctx.window_s\n")
    bench = json.loads(json.dumps(BENCHMARK))
    bench["workloads"].append({"name": "wide-reach-200", "config": "glava-wide", "traffic": "reach-200",
                               "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({"name": "batches_per_s", "unit": "1/s", "better": "higher",
                               "source": "host_clock", "layer": "session", "moves": "ingest_edges_per_s",
                               "workloads": ["wide-reach-200"]})
    cell = spec.resolve(bench, "wide-reach-200", root=root)
    assert cell.config["name"] == "glava-wide" and cell.traffic["stream"]["batch"] == 200
    assert [m["name"] for m in cell.per_layer] == ["batches_per_s"]

    class Ctx:
        before, after, window_s = {"batches": 3}, {"batches": 13}, 2.0

    assert spec.reader("batches_per_s", root=root)(Ctx) == 5.0

    class Drv:
        def step(self, due_ns=None):
            return [due_ns]

    assert spec.plugin("loop", cell.traffic["loop"], root=root).run(Drv(), 1.0, 0.0) == [0]
