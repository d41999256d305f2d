"""Generic training entry point: ``python -m repro_torch.launch.train --arch <id>``.
Port of ``src/repro/launch/train.py``.

Runs the arch's train shape at smoke scale (full scale is the dry run's
job), with checkpoint/resume and the straggler watchdog of
``train/trainer.py::train_loop``, on ``--device`` (CUDA by default; a host
with no card raises unless ``--device cpu`` is given)::

    python -m repro_torch.launch.train --device cpu --arch olmo-1b --steps 4
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_arch
from repro_torch.launch.steps import build_step
from repro_torch.train.trainer import TrainerConfig, train_loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    spec = get_arch(args.arch)
    shape = args.shape or {"lm": "train_4k", "gnn": "full_graph_sm", "recsys": "train_batch"}[spec.family]
    bundle = build_step(args.arch, shape, smoke=True, device=args.device)
    rng = np.random.default_rng(args.seed)

    def batches():
        while True:
            yield bundle.make_batch(rng)

    cfg = TrainerConfig(
        total_steps=args.steps,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        log_every=max(1, args.steps // 10),
    )
    res = train_loop(bundle.init_state, bundle.step, batches(), cfg, seed=args.seed)
    first, last = res.history[0]["loss"], res.history[-1]["loss"]
    print(
        f"[train] {args.arch}/{shape}: {args.steps} steps, "
        f"loss {first:.4f} -> {last:.4f}"
        + (f" (resumed from step {res.resumed_from})" if res.resumed_from else "")
    )
    if res.straggler_steps:
        print(f"[train] watchdog flagged {len(res.straggler_steps)} straggler steps")
    return res


if __name__ == "__main__":
    main()
