"""The control of the check: the reference put in the program's place and
computed one precision step below what the configuration states, judged by
the same comparison as a run.  It has to come out not correct.  The
configuration's reference (``bench/reference/<reference>.py``) says what
its controls lower (``controls``) and serves their outputs
(``control_outputs``).

    python3 bench/control.py --workload <cell> --batches <n> --seeds <s> [<s> ...]

runs each control at the cell's own size on the card (``--device cpu`` with
a cut cell in the tests) over ``n`` batches, the warm-up included, and
prints each seed's numbers beside the limits."""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1]), str(Path(__file__).resolve().parents[1] / "src")]

from bench.harness import cell as cell_mod  # noqa: E402
from bench.harness import spec  # noqa: E402


def run(cell: spec.Cell, seed: int, batches: int, device, low) -> dict:
    """The control ``low`` of the cell's reference over ``batches``, judged."""
    tr = cell.traffic
    inputs = spec.plugin("generator", tr["generator"]).make(tr, seed, device, batches=batches)
    reference = spec.plugin("reference", cell.config["reference"])
    out = reference.control_outputs(cell, seed, inputs, device, low)
    numbers, _ = reference.compare(cell, seed, inputs, out, device)
    correct, checks = cell_mod.judge(numbers, cell.workload["limits"])
    return {"seed": seed, "correct": correct, "checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--batches", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = spec.resolve(spec.load_json(spec.REPO / "BENCHMARK.json"), args.workload)
    variants = spec.plugin("reference", cell.config["reference"]).controls(cell)
    for seed in args.seeds:
        for name, low in variants.items():
            print(json.dumps({"variant": name, **run(cell, seed, args.batches, args.device, low)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
