"""Train a language model end to end: AdamW, the straggler watchdog and
(optionally, ``--compress``) the sketched gradient all-reduce built on the
paper's CountSketch machinery, with the token-bigram stream summarised in a
gLava session alongside.

Port of ``examples/train_lm.py``, run as ``python -m
repro_torch.launch.train_lm`` with the same flags plus ``--device``.  It
trains on the CUDA device unless ``--device cpu`` is given.
``--checkpoint-dir`` saves a checkpoint every ``max(10, steps // 4)`` steps
and resumes from the newest one it finds there."""
from __future__ import annotations

import argparse
import dataclasses
import math
from typing import Any, Callable, Iterator, Optional, Sequence

import numpy as np
import torch

from repro_torch.api import GraphStream, Query, SketchConfig
from repro_torch.data.lm import MarkovTokens, bigram_stream
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.train import compression as comp
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.trainer import (
    TrainerConfig,
    TrainResult,
    compressed_data_parallel_step,
    train_loop,
    value_and_grad,
)

PRESETS = {
    "tiny": tfm.TransformerConfig(
        name="lm-tiny", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        d_ff=512, vocab=2048, compute_dtype=torch.float32,
    ),
    "100m": tfm.TransformerConfig(
        name="lm-100m", n_layers=8, d_model=512, n_heads=8, n_kv_heads=4,
        d_ff=2048, vocab=32768, compute_dtype=torch.bfloat16,
    ),
}
COMPRESSOR = comp.CompressorConfig(depth=5, width=1 << 14, top_k=4096)


@dataclasses.dataclass
class TrainRun:
    """What a run leaves: the trainer's result, the step function, the batch
    stream (positioned after the last step) and the bigram session."""

    result: TrainResult
    step: Callable
    batches: Iterator[dict]
    bigrams: GraphStream


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train_lm")
    ap.add_argument("--preset", default="tiny", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--compress", action="store_true",
                    help="sketched gradient all-reduce (FetchSGD-style)")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def run(args: argparse.Namespace) -> TrainRun:
    device = resolve_device(args.device)
    cfg = PRESETS[args.preset]
    print(f"[train_lm] {cfg.name}: {cfg.param_count()/1e6:.1f}M params")
    opt_cfg = opt_mod.AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps)

    def loss_fn(params, batch):
        return tfm.loss_fn(cfg, params, batch["tokens"])

    gen = MarkovTokens(cfg.vocab, seed=0)
    rng = np.random.default_rng(0)
    # Corpus statistics via the paper's sketch: the token-bigram stream is a
    # graph stream, summarised in 4×256×256 counters.
    bigrams = GraphStream.open(
        SketchConfig(depth=4, width_rows=256, width_cols=256), seed=9, device=device
    )

    def batches():
        while True:
            toks = gen.batch(args.batch, args.seq + 1, rng)
            bs = bigram_stream(toks)
            bigrams.ingest(bs["src"], bs["dst"])
            yield {"tokens": toks}

    if args.compress:
        n_params = sum(math.prod(s) for s in _shapes(tfm.param_shapes(cfg)))
        ccfg = COMPRESSOR
        step = compressed_data_parallel_step(loss_fn, opt_cfg, ccfg)
        print(f"[train_lm] sketched all-reduce: {n_params/ (5*(1<<14)):.0f}x compression")

        def init_state(generator):
            params = tfm.init_params(cfg, generator, device)
            return {
                "params": params,
                "opt": opt_mod.init_adamw(opt_cfg, params),
                "comp": comp.init_compressor(ccfg, n_params, torch.Generator().manual_seed(1), device),
            }

    else:
        def init_state(generator):
            params = tfm.init_params(cfg, generator, device)
            return {"params": params, "opt": opt_mod.init_adamw(opt_cfg, params)}

        def step(state, batch):
            (loss, _), grads = value_and_grad(loss_fn, state["params"], batch)
            p, o, om = opt_mod.apply_adamw(opt_cfg, state["opt"], state["params"], grads)
            return {"params": p, "opt": o}, {"loss": loss, **om}

    stream = batches()
    res = train_loop(
        init_state, step, stream,
        TrainerConfig(
            total_steps=args.steps,
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_every=max(10, args.steps // 4),
            log_every=max(1, args.steps // 10),
        ),
    )
    losses = [h["loss"] for h in res.history]
    if losses:
        print(f"[train_lm] loss {losses[0]:.3f} -> {losses[-1]:.3f} over {len(losses)} steps")
    # The sketch earning its keep: bigram-frequency estimates.
    toks = gen.batch(4, 65, rng)
    bs = bigram_stream(toks)
    est = bigrams.query(Query.edge(bs["src"][:8], bs["dst"][:8])).value
    print(f"[train_lm] sketch bigram-frequency estimates (8 probes): {np.asarray(est)}")
    return TrainRun(res, step, stream, bigrams)


def _shapes(tree: Any):
    for k in sorted(tree):
        yield from (tree[k].values() if k == "layers" else [tree[k]])


def main(argv: Optional[Sequence[str]] = None) -> TrainRun:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
