"""Ranks on one host: :func:`run_ranks` starts ``world`` processes with the
``spawn`` start method, joins each to a process group through a
``FileStore`` in a directory the caller gives (no TCP port, so runs side by
side never collide) and collects what each rank returns.

A rank that raises exits nonzero.  The parent raises on any nonzero exit
code and on a rank still running at the deadline, which it kills first; a
rank's failure never passes unseen.  The ranks choose their own devices:
several gloo ranks may share one card, NCCL takes one rank a card.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def run_ranks(
    target: Callable,
    world: int,
    workdir,
    *,
    args: Sequence[Any] = (),
    kwargs: Optional[Dict[str, Any]] = None,
    backend: str = "gloo",
    timeout: float = 600.0,
) -> List[Any]:
    """Run ``target(rank, world, workdir, *args, **kwargs)`` on ``world``
    spawned ranks of a ``backend`` group; return each rank's result,
    rank-ordered.  ``target`` must be importable by name (a module-level
    function), and its result picklable."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    name = getattr(target, "__name__", str(target))
    ctx = mp.get_context("spawn")
    procs = [
        ctx.Process(target=_rank_main, args=(target, rank, world, str(workdir), backend, tuple(args), kwargs or {}),
                    daemon=True)
        for rank in range(world)
    ]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [rank for rank, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    if hung:
        raise RuntimeError(f"{name}: ranks {hung} still running after {timeout} s")
    codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        raise RuntimeError(f"{name}: rank exit codes {codes}")
    return [torch.load(workdir / f"rank{rank}.pt", weights_only=False) for rank in range(world)]


def _rank_main(target, rank, world, workdir, backend, args, kwargs):
    dist.init_process_group(backend, store=dist.FileStore(str(Path(workdir) / "store"), world),
                            rank=rank, world_size=world)
    try:
        result = target(rank, world, workdir, *args, **kwargs)
        torch.save(result, Path(workdir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()
