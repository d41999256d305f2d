"""AdamW with configurable state dtypes, and plain SGD.

Port of ``src/repro/train/optimizer.py``.  Functions on trees of tensors
(``repro_torch.tree``), run under ``torch.no_grad()``, return new trees and
leave their inputs untouched, as the reference does.  The schedule, the
step, ``b ** step`` and the bias corrections are float32 tensors and every
operation takes the reference's order, so a step rounds where the
reference's rounds (Python floats are f64 and would drift); ``m_dtype`` and
``v_dtype`` of ``torch.bfloat16`` round the moments where the reference
rounds them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # dtype knobs (memory fit)
    m_dtype: torch.dtype = torch.float32
    v_dtype: torch.dtype = torch.float32
    # schedule
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor  # () int32
    m: Any  # tree like params
    v: Any  # tree like params


def _f32(x, device) -> torch.Tensor:
    """A float32 scalar on ``device``, written by a fill (a ``torch.tensor``
    of a host float would copy it from pageable memory and wait)."""
    return torch.full((), x, dtype=torch.float32, device=device)


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to min_lr_frac * lr (float32)."""
    step = step.to(torch.float32)
    one = _f32(1.0, step.device)
    warm = torch.minimum(one, step / max(1.0, cfg.warmup_steps))
    progress = torch.clamp(
        (step - cfg.warmup_steps) / max(1.0, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0
    )
    cosine = 0.5 * (1.0 + torch.cos(math.pi * progress))
    frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cosine
    return cfg.lr * warm * frac


def init_adamw(cfg: AdamWConfig, params: Any) -> AdamWState:
    first = tree_leaves(params)[0]
    m = tree_map(lambda p: torch.zeros_like(p, dtype=cfg.m_dtype), params)
    v = tree_map(lambda p: torch.zeros_like(p, dtype=cfg.v_dtype), params)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=first.device), m=m, v=v)


@torch.no_grad()
def global_norm(tree: Any) -> torch.Tensor:
    total = 0
    for leaf in tree_leaves(tree):
        total = total + torch.sum(torch.square(leaf.to(torch.float32)))
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(grads: Any, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


@torch.no_grad()
def apply_adamw(
    cfg: AdamWConfig,
    state: AdamWState,
    params: Any,
    grads: Any,
) -> tuple[Any, AdamWState, dict]:
    """One AdamW step.  Math in fp32 regardless of storage dtypes."""
    if cfg.grad_clip > 0:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    else:
        gnorm = global_norm(grads)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    step32 = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(_f32(b1, step.device), step32)
    bc2 = 1.0 - torch.pow(_f32(b2, step.device), step32)

    def upd(p, g, m, v):
        g32 = g.to(torch.float32)
        m32 = m.to(torch.float32) * b1 + (1 - b1) * g32
        v32 = v.to(torch.float32) * b2 + (1 - b2) * torch.square(g32)
        mhat = m32 / bc1
        vhat = v32 / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.to(torch.float32)
        new_p = p.to(torch.float32) - lr * delta
        return new_p.to(p.dtype), m32.to(cfg.m_dtype), v32.to(cfg.v_dtype)

    columns = zip(*(tree_leaves(t) for t in (params, grads, state.m, state.v)))
    new_p, new_m, new_v = zip(*(upd(*leaves) for leaves in columns))
    new_params = tree_unflatten(params, new_p)
    new_m = tree_unflatten(params, new_m)
    new_v = tree_unflatten(params, new_v)
    metrics = {"lr": lr, "grad_norm": gnorm}
    return new_params, AdamWState(step, new_m, new_v), metrics


# Convenience SGD used by tiny tests / examples.
@torch.no_grad()
def sgd(params: Any, grads: Any, lr: float) -> Any:
    return tree_map(lambda p, g: p - lr * g.to(p.dtype), params, grads)
