"""Placements of the distributed sketch plane.

Port of ``sketch_plane_shardings`` (``src/repro/distributed/sharding.py:133``)
and of what it needs of ``jax.sharding``: a :class:`Placement` is the
counterpart of ``NamedSharding(mesh, PartitionSpec(*spec))``, where each
entry of ``spec`` names the mesh axis (or tuple of axes) a tensor dimension
is split over, or ``None`` for a whole dimension; dimensions past the spec
are whole.  :func:`local_shard` cuts one rank's block as ``NamedSharding``
places it, and :func:`gather_block` puts the blocks back together.  The
model-sharding rules of the reference module (``default_rules``,
``resolve_pspec``, ...) serve the models and are not ported here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed.mesh import Mesh, mesh_coords


@dataclasses.dataclass(frozen=True)
class Placement:
    """``NamedSharding(mesh, P(*spec))``: ``spec[i]`` is None, an axis name
    or a tuple of axis names for tensor dimension ``i``."""

    mesh: Mesh
    spec: Tuple = ()

    def axes(self) -> Tuple[str, ...]:
        """The mesh axes the placement splits over, in mesh order."""
        used = {a for entry in self.spec if entry is not None
                for a in ((entry,) if isinstance(entry, str) else entry)}
        return tuple(a for a in self.mesh.axis_names if a in used)


def sketch_plane_shardings(
    mesh: Mesh, *, model_axis: str = "model", stream_axes: Optional[Tuple[str, ...]] = None
) -> Tuple[Placement, Placement]:
    """The canonical placement of the distributed sketch plane (paper §6.3):
    ``(counter_placement, stream_placement)``, the counters' rows split over
    the model axis and the edge stream over the data axes (``("pod",
    "data")`` where present)."""
    if stream_axes is None:
        stream_axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    return Placement(mesh, (None, model_axis, None)), Placement(mesh, (tuple(stream_axes),))


def block_slices(shape: Sequence[int], spec: Sequence, mesh_shape: Sequence[int],
                 axis_names: Sequence[str], coords: Sequence[int]) -> Tuple[slice, ...]:
    """The block of a tensor of ``shape`` that the device at ``coords`` holds
    under ``spec``, as ``NamedSharding.devices_indices_map`` gives it: a
    dimension split over axes ``(a, b)`` has ``size(a)·size(b)`` equal
    blocks, and the device takes block ``coord(a)·size(b) + coord(b)``."""
    sizes = dict(zip(axis_names, mesh_shape))
    at = dict(zip(axis_names, coords))
    out = []
    for i, dim in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        if entry is None:
            out.append(slice(0, dim))
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        n = math.prod(sizes[a] for a in axes)
        if dim % n:
            raise ValueError(f"dimension {i} of {tuple(shape)} does not divide over {axes} ({n} blocks)")
        k = 0
        for a in axes:
            k = k * sizes[a] + at[a]
        size = dim // n
        out.append(slice(k * size, (k + 1) * size))
    return tuple(out)


def _slices(shape, placement: Placement) -> Tuple[slice, ...]:
    mesh = placement.mesh
    sizes = tuple(mesh.shape.values())
    return block_slices(shape, placement.spec, sizes, mesh.axis_names, mesh_coords(sizes, mesh.rank))


def local_shard(tensor, placement: Placement):
    """This rank's block of ``tensor`` (a tensor or a numpy array) under
    ``placement``: a view, as ``NamedSharding`` + ``PartitionSpec`` place
    it."""
    return tensor[_slices(tuple(tensor.shape), placement)]


def gather_block(block: torch.Tensor, placement: Placement, shape: Sequence[int]) -> torch.Tensor:
    """The whole tensor of ``shape`` on every rank, from each rank's
    ``block`` under ``placement``: a ``SUM`` over the placement's axes of
    zero-filled buffers that each hold one rank's disjoint block, so the
    sum is exact (every cell has one nonzero addend)."""
    whole = block.new_zeros(tuple(shape))
    whole[_slices(tuple(shape), placement)] = block
    axes = placement.axes()
    if axes:
        placement.mesh.all_reduce_(whole, dist.ReduceOp.SUM, axes)
    return whole
