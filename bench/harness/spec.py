"""Finds a cell's files by the names ``BENCHMARK.json`` gives: its
configuration in ``bench/configs/<config>.json``, its traffic mix in
``bench/traffic/<traffic>.json``, its limits and check sizes in
``bench/workloads/<cell>.json``, and each metric's reader in
``bench/metrics/<metric>.py``.  The configuration names the code that opens
the program (``driver``) and the plain reference that judges it
(``reference``); the mix names the code that draws its inputs
(``generator``) and the schedule that hands them over (``loop``).  Each is a
module found by that name (``PLUGINS``).  A new cell, configuration, mix,
metric, driver, generator, loop or reference is a new file and an entry in
``BENCHMARK.json`` or in a data file; no file here changes."""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import Callable, List

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    workload: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(benchmark: dict, cell: str, root: Path = BENCH) -> Cell:
    """The cell named ``cell`` with its files loaded from ``root``."""
    entry = next((w for w in benchmark["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json (have {[w['name'] for w in benchmark['workloads']]})")
    return Cell(
        name=cell,
        chips=entry["chips"],
        config=load_json(root / "configs" / f"{entry['config']}.json"),
        traffic=load_json(root / "traffic" / f"{entry['traffic']}.json"),
        workload=load_json(root / "workloads" / f"{cell}.json"),
        end_to_end=[m for m in benchmark["end_to_end"] if applies(m, cell)],
        per_layer=[m for m in benchmark["per_layer"] if applies(m, cell)],
    )


# kind -> the folder of ``bench/`` its modules live in; a name is a Python
# identifier.
PLUGINS = {
    "driver": "harness/drivers",        # Driver: opens, feeds and reads back the program
    "generator": "harness/generators",  # make(traffic, seed, device, seconds=|batches=)
    "loop": "harness/loops",            # run(driver, seconds, t0): the window's schedule
    "reference": "reference",           # compare, control_outputs, controls
}


def plugin(kind: str, name: str, root: Path = BENCH):
    """The module ``<root>/<PLUGINS[kind]>/<name>.py``, imported as
    ``bench.<folder>.<name>`` (once a process)."""
    module = ".".join(("bench", *PLUGINS[kind].split("/"), name))
    if root == BENCH:
        return importlib.import_module(module)
    if module not in sys.modules:
        spec = importlib.util.spec_from_file_location(module, root / PLUGINS[kind] / f"{name}.py")
        sys.modules[module] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules[module])
    return sys.modules[module]


def driver(name: str, root: Path = BENCH):
    """The driver class of ``bench/harness/drivers/<name>.py``."""
    return plugin("driver", name, root).Driver


def reader(metric: str, root: Path = BENCH) -> Callable:
    """The ``read(ctx)`` of ``<root>/metrics/<metric>.py``, end-to-end and
    per-layer metrics alike (``harness/cell.py::Context``)."""
    path = root / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"bench.metrics.{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
