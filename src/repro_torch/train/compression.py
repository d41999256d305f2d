"""Sketched gradient all-reduce with error feedback (FetchSGD-style,
arXiv:2007.07682).

Port of ``src/repro/train/compression.py``.  The gradient vector is
CountSketch'd into a (d, w) table with the gLava core's signed affine
hashing, the tables are summed across workers (``psum_fn``; linearity is the
paper's Section 6.3 merge), the top-k coordinates are un-sketched with the
median estimator, and the residual stays local as error feedback.

On the card a round trip launches the CountSketch kernel twice and its
median decode once (``kernels/countsketch``); both hash the coordinates in
registers, so no (d, n) tensor is built.  On the CPU the plain versions
share one :func:`hash_indices` per round trip.  The decode follows
``jnp.median`` (NaN wherever a value is NaN, the midpoint of the two middle
values) and the top-k threshold ``jnp.sort(|est|)[-k]`` (NaN counted as the
largest magnitude), so a non-finite gradient trains as it does in the
reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.core.hashing import HashFamily, make_hash_family
from repro_torch.kernels.countsketch.ops import (
    countsketch,
    countsketch_family,
    countsketch_median,
    hash_indices,
)
from repro_torch.kernels.countsketch.ref import median_of_cells_ref
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
    """CountSketch a flat vector -> (d, w); ``hashes`` (the CPU path) are
    the coordinates' buckets and signs, else the kernel hashes them."""
    if hashes is None:
        return countsketch_family(vec.to(torch.float32), state.hash)
    h, s = hashes
    return countsketch(vec.to(torch.float32), h, s, state.config.width)


def _unsketch(
    state: CompressorState, table: torch.Tensor, n: int, hashes: Optional[Hashes] = None
) -> torch.Tensor:
    """Median-of-d estimate for every coordinate -> (n,)."""
    if hashes is None:
        return countsketch_median(table, state.hash, n)
    return median_of_cells_ref(table, *hashes)


def _threshold(mag: torch.Tensor, k: int) -> torch.Tensor:
    """``jnp.sort(mag)[-k]``: the k-th largest magnitude with NaN counted as
    the largest, so NaN once k or more are NaN.  ``topk`` ranks NaN first
    too; no sort runs (the k values come unsorted)."""
    top = torch.topk(mag, k, sorted=False).values
    nan = top.isnan()
    kth = torch.where(nan, torch.inf, top).amin()
    return torch.where(nan.all(), torch.nan, kth)


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
    hashes = hash_indices(state.hash, n) if grad_vec.device.type == "cpu" else None
    corrected = grad_vec + state.error
    table = _sketch(state, corrected, hashes)
    if psum_fn is not None:
        table = psum_fn(table)
    mom = cfg.momentum * state.momentum + table
    est = _unsketch(state, mom, n, hashes)
    k = min(cfg.top_k, n)
    mag = est.abs()
    # ">=" keeps every tie; a NaN magnitude is never selected.
    thresh = _threshold(mag, k)
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
