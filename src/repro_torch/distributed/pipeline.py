"""Pipeline parallelism: GPipe-style microbatch pipelining over a ``pipe``
axis of a rank mesh.  Port of ``src/repro/distributed/pipeline.py``.

The default path for the assigned shapes is TP×FSDP(×EP): at these depths
the PP bubble (S−1)/(M+S−1) loses to EP+FSDP, but PP is the right tool
where a single layer no longer fits a TP group, so the schedule ships as a
tested module.

Semantics: ``pipeline_apply(stage_fn, stage_params, x, mesh)`` computes
    y = stage_fn(p_{S-1}, stage_fn(p_{S-2}, … stage_fn(p_0, x)))
with stage s on pipe-rank s and the microbatches streamed GPipe-style:
at tick t rank s works on microbatch t−s (a bubble at each end), M + S − 1
ticks in all.

Every rank calls it with the whole stage-major parameter tree and the whole
microbatch queue (the reference's in-specs ``P(axis)`` and ``P()``) and
keeps its own stage.  The reference's ``ppermute`` to the right neighbour
is one ``all_reduce(SUM)`` a tick of a zero-filled ``(S, mb, D)`` buffer in
which each rank writes its output into its right neighbour's slot: every
slot has one nonzero addend, so the sum is exact (the mesh's gather-by-sum;
gloo runs only ``all_reduce`` and ``broadcast`` on CUDA tensors, and NCCL
refuses two ranks on one card).  The last rank's accumulator reaches every
rank by a final ``SUM``, as the reference's ``psum``.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import Placement, local_shard
from repro_torch.tree import tree_map


def pipeline_apply(
    stage_fn: Callable,
    stage_params,          # tree, each leaf (S, ...) — stage-major
    x: torch.Tensor,       # (M, mb, D) microbatched input, the same on every rank
    mesh,
    axis: str = "pipe",
) -> torch.Tensor:
    """Run the S-stage pipeline over M microbatches.  Returns (M, mb, D) on
    every rank."""
    s_stages = mesh.size(axis)
    rank = mesh.index(axis)
    m, mb, d = x.shape
    # This rank's stage: its block of every stage-major leaf.
    own = tree_map(lambda a: local_shard(a, Placement(mesh, (axis,)))[0], stage_params)
    out_acc = x.new_zeros((m, mb, d))
    recv = x.new_zeros((mb, d))
    for t in range(m + s_stages - 1):
        # rank 0 takes microbatch t from the queue (if any), the others what
        # arrived from the left neighbour
        stage_in = x[min(t, m - 1)] if rank == 0 else recv
        stage_out = stage_fn(own, stage_in)
        # the last rank commits microbatch t - (S-1) when it is valid
        mb_idx = t - (s_stages - 1)
        if rank == s_stages - 1 and 0 <= mb_idx < m:
            out_acc[mb_idx] = stage_out
        # ship the activations rightward for the next tick
        slots = x.new_zeros((s_stages, mb, d))
        slots[(rank + 1) % s_stages] = stage_out
        recv = mesh.all_reduce_(slots, dist.ReduceOp.SUM, axis)[rank]
    # only the last rank's accumulator is the output: a SUM gives it to all
    if rank != s_stages - 1:
        out_acc.zero_()
    return mesh.all_reduce_(out_acc, dist.ReduceOp.SUM, axis)


def microbatch(x: torch.Tensor, n_micro: int) -> torch.Tensor:
    """(B, D) -> (M, B/M, D)."""
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} does not split into {n_micro} microbatches")
    return x.reshape(n_micro, b // n_micro, *x.shape[1:])


def pipeline_bubble_fraction(n_stages: int, n_micro: int) -> float:
    """GPipe bubble: (S-1)/(M+S-1), the quantity that makes EP+FSDP win at
    the assigned depths."""
    return (n_stages - 1) / (n_micro + n_stages - 1)
