#!/usr/bin/env python3
"""End-to-end readings of two checkouts of the port, in turns on one card.

    python3 tools/paired_e2e.py PARENT_ROOT CHANGE_ROOT [ROUNDS]

Takes the readings ``chip_smoke.py`` keeps ranges for, with its flags and
its timing (``SERVE_BASE``, ``FLEET_BASE``, ``TRAIN_100M``, ``timed_run``,
``timed_fleet``, ``release``; imported from the ``chip_smoke.py`` beside this
directory), each checkout in a process of its own (its own ``src`` first on
the path, its own kernel build), in ROUNDS rounds (1 by default) of parent,
change, change, parent: serve BASE on the kernels, fleet serve BASE (16
tenants) on the kernels, and the median step of the compressed ``100m``
run.  Each process warms up with one serve BASE run first.  Prints the
card's name and power limit, one line per process, each side's sorted
readings and in how many pairs the change reads lower.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

TOOLS_ROOT = Path(__file__).resolve().parents[1]


def take_reading(root: Path) -> dict:
    """One process's readings of the checkout at ``root`` (run in a child)."""
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(1, str(TOOLS_ROOT))
    import numpy as np
    import torch

    import chip_smoke as smoke
    from repro_torch.kernels import build
    from repro_torch.launch import serve, train_lm

    torch.backends.cuda.matmul.allow_tf32 = False
    build.build(build.SOURCES)

    smoke.release(torch)
    reading = {}
    for key, argv, timed in (("warm-up", smoke.SERVE_BASE, smoke.timed_run),
                             ("serve_s", smoke.SERVE_BASE, smoke.timed_run),
                             ("fleet_s", smoke.FLEET_BASE, smoke.timed_fleet)):
        out = timed(torch, lambda: serve.main(argv))
        reading[key] = out[-1]
        del out
        smoke.release(torch)
    del reading["warm-up"]
    run = train_lm.main(smoke.TRAIN_100M)
    reading["step_ms"] = float(np.median([1e3 * h["duration_s"] for h in run.result.history]))
    return reading


def reading(root: Path) -> dict:
    proc = subprocess.run([sys.executable, __file__, "--reading", str(root)], capture_output=True, text=True,
                          timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{root}: exit {proc.returncode}\n{proc.stderr[-4000:]}")
    line = next(x for x in proc.stdout.splitlines() if x.startswith("READING "))
    return json.loads(line[len("READING "):])


def main(argv) -> int:
    if argv[:1] == ["--reading"]:
        print("READING " + json.dumps(take_reading(Path(argv[1]).resolve())))
        return 0
    parent, change = (Path(a).resolve() for a in argv[:2])
    rounds = int(argv[2]) if len(argv) > 2 else 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[paired_e2e] nvidia-smi: {smi}")
    runs = {"parent": [], "change": []}
    for side in ("parent", "change", "change", "parent") * rounds:
        t0 = time.time()
        r = reading(parent if side == "parent" else change)
        runs[side].append(r)
        print(f"[paired_e2e] {side}: serve BASE {r['serve_s']:.3f} s, fleet serve BASE {r['fleet_s']:.3f} s, "
              f"100m step median {r['step_ms']:.1f} ms ({time.time() - t0:.1f} s with its start)")
    for side, rs in runs.items():
        print(f"[paired_e2e] {side}, sorted: " + ", ".join(
            f"{k} {sorted(round(r[k], 4) for r in rs)}" for k in ("serve_s", "fleet_s", "step_ms")))
    for k in ("serve_s", "fleet_s", "step_ms"):
        wins = sum(c[k] < p[k] for p, c in zip(runs["parent"], runs["change"]))
        print(f"[paired_e2e] {k}: the change reads lower in {wins} of {len(runs['change'])} pairs")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
