"""Train loop: microbatch accumulation, periodic async checkpoints,
crash-exact resume, straggler watchdog, optional sketched gradient
compression, and failure injection for FT tests.

Port of ``src/repro/train/trainer.py``.  A step is a plain function
``step(state, batch) -> (state, metrics)`` over trees of tensors; gradients
come from ``torch.autograd.grad`` on detached copies of the parameter leaves
(the counterpart of ``jax.value_and_grad``), and microbatches run in a
Python loop in place of ``lax.scan``.  ``train_loop`` puts each batch on
the device of the state's tensors.  Checkpoints are
:class:`~repro_torch.checkpoint.manager.CheckpointManager` saves in the
reference's format.

The data-parallel exchange of :func:`compressed_data_parallel_step` runs on
``torch.distributed``: ``axis_name`` names an axis of the
:class:`~repro_torch.distributed.mesh.Mesh` the caller passes, and the
sketch table is all-reduced over that axis's process group.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.distributed.mesh import Mesh
from repro_torch.train import compression as comp_mod
from repro_torch.train import optimizer as opt_mod
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 25
    checkpoint_dir: Optional[str] = None
    keep_checkpoints: int = 3
    log_every: int = 10
    # microbatch gradient accumulation (1 = off)
    grad_accum: int = 1
    # straggler mitigation: flag steps slower than watchdog_factor × the
    # running median (recorded and surfaced to the caller)
    watchdog_factor: float = 3.0
    # sketched gradient compression (None = off)
    compressor: Optional[comp_mod.CompressorConfig] = None
    # failure injection for FT tests: raise at this step (simulates preempt)
    fail_at_step: Optional[int] = None


@dataclasses.dataclass
class TrainResult:
    state: Any
    history: list
    straggler_steps: list
    resumed_from: Optional[int]


def value_and_grad(loss_fn: Callable, params: Any, batch: Any):
    """``((loss, aux), grads)`` of ``loss_fn(params, batch)``, grads shaped
    like ``params``; the parameters themselves are not marked, and loss and
    aux come back detached from the graph."""
    live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, aux = loss_fn(tree_unflatten(params, live), batch)
        grads = torch.autograd.grad(loss, live)
    aux = tree_map(lambda t: t.detach() if isinstance(t, torch.Tensor) else t, aux)
    return (loss.detach(), aux), tree_unflatten(params, grads)


def make_accum_step(loss_fn: Callable, opt_cfg: opt_mod.AdamWConfig, n_accum: int):
    """Turn loss_fn(params, microbatch) into an accumulated train step over a
    batch with a leading microbatch axis (n_accum, ...)."""

    def step(state, batch):
        params, opt = state["params"], state["opt"]
        if n_accum > 1:
            grads = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
            losses = []
            for i in range(n_accum):
                (loss, _), g = value_and_grad(loss_fn, params, tree_map(lambda x: x[i], batch))
                grads = tree_map(torch.add, grads, g)
                losses.append(loss)
            grads = tree_map(lambda g: g / n_accum, grads)
            loss = torch.mean(torch.stack(losses))
        else:
            (loss, _), grads = value_and_grad(loss_fn, params, tree_map(lambda x: x[0], batch))
        new_params, new_opt, om = opt_mod.apply_adamw(opt_cfg, opt, params, grads)
        return {"params": new_params, "opt": new_opt}, {"loss": loss, **om}

    return step


def train_loop(
    init_state: Callable[[torch.Generator], Any],
    step_fn: Callable,
    batches: Iterator[Dict[str, np.ndarray]],
    cfg: TrainerConfig,
    seed: int = 0,
) -> TrainResult:
    """Run to total_steps.  ``init_state`` receives a CPU
    ``torch.Generator`` seeded with ``seed``.  With ``checkpoint_dir``, a
    checkpoint found there is resumed EXACTLY (step counter, optimizer
    state, parameters): ``batches`` must then start at the resumed step."""
    mgr = (
        CheckpointManager(cfg.checkpoint_dir, keep=cfg.keep_checkpoints)
        if cfg.checkpoint_dir
        else None
    )
    state = init_state(torch.Generator().manual_seed(seed))
    start_step = 0
    resumed_from = None
    if mgr is not None and mgr.latest_step() is not None:
        state, meta = mgr.restore(like=state)
        start_step = meta["step"]
        resumed_from = start_step
    device = next(x for x in tree_leaves(state) if isinstance(x, torch.Tensor)).device
    history = []
    stragglers = []
    durations = []
    for step in range(start_step, cfg.total_steps):
        batch = next(batches)
        if cfg.fail_at_step is not None and step == cfg.fail_at_step:
            # Simulated preemption: checkpoints begun on earlier steps are
            # durable by the time a later step dies (join the writer).
            if mgr is not None:
                mgr.wait()
            raise RuntimeError(f"injected failure at step {step}")
        t0 = time.time()
        batch = tree_map(lambda x: torch.as_tensor(x).to(device, non_blocking=True), batch)
        state, metrics = step_fn(state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        dt = time.time() - t0
        durations.append(dt)
        med = float(np.median(durations[-50:]))
        if len(durations) > 5 and dt > cfg.watchdog_factor * med:
            stragglers.append({"step": step, "duration": dt, "median": med})
        history.append({"step": step, "duration_s": dt, **metrics})
        if cfg.log_every and step % cfg.log_every == 0:
            print(f"[train] step {step}: loss={metrics.get('loss', float('nan')):.4f} {dt*1e3:.0f}ms")
        next_step = step + 1
        if mgr is not None and (next_step % cfg.checkpoint_every == 0 or next_step == cfg.total_steps):
            mgr.save_async(next_step, state, {"step": next_step})
    if mgr is not None:
        mgr.wait()
    return TrainResult(state, history, stragglers, resumed_from)


def compressed_data_parallel_step(
    loss_fn: Callable,
    opt_cfg: opt_mod.AdamWConfig,
    comp_cfg: comp_mod.CompressorConfig,
    axis_name: Optional[str] = None,
    mesh: Optional[Mesh] = None,
):
    """Train step whose gradient exchange is the SKETCHED all-reduce: grads
    are CountSketch'd, the (d, width) tables summed over the workers (the
    linear-sketch merge), top-k-decoded with error feedback, and applied
    with AdamW.

    ``axis_name=None`` is the single-worker semantics.  Otherwise
    ``axis_name`` names an axis (or a tuple of axes) of ``mesh``, a
    :class:`~repro_torch.distributed.mesh.Mesh` over the caller's process
    group, and each worker calls the step on its own batch: the table is
    ``all_reduce(SUM)``'d over that axis's group (the reference's ``psum``)
    and the loss averaged over it (``pmean``: a ``SUM``, then a division by
    the group's size; gloo has no ``AVG``).  The replicas stay identical
    with no further exchange: every rank holds the same reduced table, and
    the decode, the sketch of the update (fixed-point sums on the card) and
    AdamW give the same bits from the same inputs."""
    psum_fn = None
    if axis_name is not None:
        if not isinstance(mesh, Mesh):
            raise ValueError(f"axis_name={axis_name!r} names an axis of mesh=, a repro_torch Mesh; got {mesh!r}")
        mesh.group(axis_name)  # an unknown axis raises here, not in a step

        def psum_fn(table):
            return mesh.all_reduce_(table, dist.ReduceOp.SUM, axis_name)

    def step(state, batch):
        params, opt, cstate = state["params"], state["opt"], state["comp"]
        (loss, _), grads = value_and_grad(loss_fn, params, batch)
        with torch.no_grad():
            flat, spec = comp_mod.flatten_grads(grads)
            del grads
            update_flat, cstate = comp_mod.roundtrip(cstate, flat, psum_fn)
            grads_hat = comp_mod.unflatten_grads(update_flat, spec)
            if axis_name is not None:
                total = loss.reshape(1).clone()
                loss = (mesh.all_reduce_(total, dist.ReduceOp.SUM, axis_name) / mesh.size(axis_name)).reshape(())
        new_params, new_opt, om = opt_mod.apply_adamw(opt_cfg, opt, params, grads_hat)
        return {"params": new_params, "opt": new_opt, "comp": cstate}, {"loss": loss, **om}

    return step
