"""Cells of ``BENCHMARK.json`` cut to a size a CPU test holds: the SMOKE
sketch (d = 3, 256 x 256), 2,000 nodes, 2,000-edge batches, the standing
workload and the dashboard cut alike.  Everything else is the cell's."""
from __future__ import annotations

import copy

from bench.harness import spec

SMALL_CONFIG = {"depth": 3, "width_rows": 256, "width_cols": 256}
SMALL_STREAM = {"nodes": 2000, "batch": 2000}
SMALL_STANDING = {"edge": 64, "in_flow": 32, "heavy": 16, "reach": 16}


def small_cell(name: str, rate: float = 4e4) -> spec.Cell:
    cell = spec.resolve(spec.load_json(spec.REPO / "BENCHMARK.json"), name)
    cell = copy.deepcopy(cell)
    cell.config.update(SMALL_CONFIG)
    d, w = SMALL_CONFIG["depth"], SMALL_CONFIG["width_rows"]
    cell.config["state_bytes"] = cell.config.get("capacity", 1) * (d * w * w + 2 * d * w) * 4
    cell.traffic["stream"].update(SMALL_STREAM)
    for fam, n in SMALL_STANDING.items():
        if cell.traffic["standing"].get(fam):
            cell.traffic["standing"][fam] = min(n, cell.traffic["standing"][fam])
    if "dashboard" in cell.traffic:
        cell.traffic["dashboard"]["pagerank"]["iters"] = 8
    cell.traffic["sized_for_edges_per_s"] = rate
    return cell
