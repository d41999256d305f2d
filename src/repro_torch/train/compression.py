"""Sketched gradient all-reduce with error feedback (FetchSGD-style,
arXiv:2007.07682).

Port of ``src/repro/train/compression.py``.  The gradient vector is
CountSketch'd into a (d, w) table with the gLava core's signed affine
hashing, the tables are summed across workers (``psum_fn``; linearity is the
paper's Section 6.3 merge), the top-k coordinates are un-sketched with the
median estimator, and the residual stays local as error feedback.

The port hashes the coordinates once per :func:`roundtrip` (int32 buckets,
int8 signs) and shares them between its two sketches and its un-sketch; a
sketch of a CUDA vector launches the CountSketch kernel
(``kernels/countsketch``).  ``jnp.median`` averages the two middle values
when d is even, and so does :func:`_median` (``torch.median`` would return
the lower one).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.core.hashing import HashFamily, make_hash_family
from repro_torch.kernels.countsketch.ops import countsketch, hash_indices
from repro_torch.tree import skeleton, tree_leaves, tree_unflatten

Hashes = Tuple[torch.Tensor, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class CompressorConfig:
    depth: int = 5
    width: int = 16384
    top_k: int = 2048
    momentum: float = 0.9  # sketch-side momentum as in FetchSGD (0 = off)


@dataclasses.dataclass(frozen=True)
class CompressorState:
    error: torch.Tensor      # (n,) error-feedback accumulator
    momentum: torch.Tensor   # (d, w) sketch-side momentum
    hash: HashFamily
    config: CompressorConfig


def init_compressor(
    cfg: CompressorConfig,
    n_params: int,
    generator: torch.Generator,
    device: Optional[torch.device] = None,
) -> CompressorState:
    fam = make_hash_family(generator, cfg.depth, cfg.width, device)
    return CompressorState(
        error=torch.zeros((n_params,), dtype=torch.float32, device=device),
        momentum=torch.zeros((cfg.depth, cfg.width), dtype=torch.float32, device=device),
        hash=fam,
        config=cfg,
    )


def _sketch(state: CompressorState, vec: torch.Tensor, hashes: Optional[Hashes] = None) -> torch.Tensor:
    """CountSketch a flat vector -> (d, w)."""
    h, s = hashes if hashes is not None else hash_indices(state.hash, vec.shape[0])
    return countsketch(vec.to(torch.float32), h, s, state.config.width)


def _median(vals: torch.Tensor) -> torch.Tensor:
    """Median over dim 0, the mean of the two middle values when it is even
    (``jnp.median``'s midpoint rule: ``(lo + hi) * 0.5``)."""
    d = vals.shape[0]
    srt = vals.sort(dim=0).values
    return (srt[(d - 1) // 2] + srt[d // 2]) * 0.5


def _unsketch(
    state: CompressorState, table: torch.Tensor, n: int, hashes: Optional[Hashes] = None
) -> torch.Tensor:
    """Median-of-d estimate for every coordinate -> (n,)."""
    h, s = hashes if hashes is not None else hash_indices(state.hash, n)
    vals = torch.gather(table, 1, h.long()) * s.to(torch.float32)  # (d, n)
    return _median(vals)


def roundtrip(
    state: CompressorState,
    grad_vec: torch.Tensor,
    psum_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Tuple[torch.Tensor, CompressorState]:
    """One full compress → (psum) → decompress cycle with exact error
    feedback.  ``psum_fn`` merges sketches across data-parallel workers
    (None = single worker)."""
    cfg = state.config
    n = grad_vec.shape[0]
    hashes = hash_indices(state.hash, n)
    corrected = grad_vec + state.error
    table = _sketch(state, corrected, hashes)
    if psum_fn is not None:
        table = psum_fn(table)
    mom = cfg.momentum * state.momentum + table
    est = _unsketch(state, mom, n, hashes)
    k = min(cfg.top_k, n)
    mag = est.abs()
    # jnp.sort(|est|)[-k]: the k-th largest magnitude; ">=" keeps every tie.
    thresh = torch.topk(mag, k, sorted=False).values.min()
    update = torch.where(mag >= thresh, est, torch.zeros((), dtype=est.dtype, device=est.device))
    new_mom = mom - _sketch(state, update, hashes)
    new_error = corrected - update
    return update, dataclasses.replace(state, momentum=new_mom, error=new_error)


# -- pytree <-> flat helpers --------------------------------------------------


def flatten_grads(grads: Any) -> Tuple[torch.Tensor, Any]:
    leaves = tree_leaves(grads)
    flat = torch.cat([g.reshape(-1).to(torch.float32) for g in leaves])
    shapes = [(g.shape, g.dtype) for g in leaves]
    return flat, (skeleton(grads), shapes)


def unflatten_grads(flat: torch.Tensor, spec) -> Any:
    like, shapes = spec
    out = []
    off = 0
    for shape, dtype in shapes:
        n = shape.numel()
        out.append(flat[off : off + n].reshape(shape).to(dtype))
        off += n
    return tree_unflatten(like, out)
