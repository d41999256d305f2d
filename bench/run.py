"""Run one cell of the port's benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell, its configuration, traffic mix,
limits and metrics are found by name from ``BENCHMARK.json`` (see
``bench/README.md``).  The last line of standard output is one JSON object;
the last lines of standard error give each compared number beside its
limit.  Without a CUDA card, or with fewer cards than the cell asks for, it
exits with 1 and prints no result.
"""
import time

STARTED = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
# Kernel and compiler caches live at fixed paths inside the checkout (the
# port builds its kernels into build/kernels there itself).
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(REPO / "build" / "bench-cache" / sub)
sys.path[:0] = [str(REPO), str(REPO / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from bench.harness import cell as cell_mod
    from bench.harness import spec

    cell = spec.resolve(spec.load_json(REPO / "BENCHMARK.json"), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench: {args.workload} needs {cell.chips} CUDA card(s); this machine has {have}", file=sys.stderr)
        return 1
    result = cell_mod.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", STARTED)
    bad = cell_mod.forbidden_modules()
    if bad:
        print(f"bench: modules of JAX or the JAX package are loaded: {bad}", file=sys.stderr)
        return 1
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
