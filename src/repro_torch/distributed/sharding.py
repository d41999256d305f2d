"""Placements: the sketch plane's, and the model-sharding rules.

Port of ``src/repro/distributed/sharding.py`` and of what it needs of
``jax.sharding``: a :class:`Placement` is the counterpart of
``NamedSharding(mesh, PartitionSpec(*spec))``, where each entry of
``spec`` names the mesh axis (or tuple of axes) a tensor dimension is split
over, or ``None`` for a whole dimension; dimensions past the spec are
whole.  :func:`local_shard` cuts one rank's block as ``NamedSharding``
places it, and :func:`gather_block` puts the blocks back together.

The model-sharding half (``:20-131``): models annotate parameters and
batches with LOGICAL axis names ("vocab", "heads", "embed", "batch", ...);
:func:`resolve_pspec` maps them onto a mesh by :func:`default_rules`,
REPLICATES any dimension the mesh does not divide (e.g. Arctic's 56 heads
on a 16-way model axis), or splits it over the longest prefix of its axes
that divides it, never uses an axis on two dimensions, trims trailing
``None``s, and records each fallback in a :class:`ResolveReport`.  The
mesh may be a rank :class:`~repro_torch.distributed.mesh.Mesh`, an
:class:`~repro_torch.distributed.mesh.AbstractMesh` (axis sizes, no
ranks: the production layouts) or anything with a ``.shape`` dict of axis
sizes; :meth:`Placement.block_shape` gives a device's block on any of them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed.mesh import Mesh, mesh_coords
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


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
        return tuple(a for a in self.mesh.shape if a in used)

    def block_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """The shape of each device's block of a tensor of ``shape``
        (``NamedSharding.shard_shape``); a dimension its axes do not divide
        raises."""
        names = tuple(self.mesh.shape)
        sizes = tuple(self.mesh.shape.values())
        return tuple(s.stop - s.start for s in block_slices(shape, self.spec, sizes, names, (0,) * len(sizes)))


def check_placement(value, what: str) -> None:
    """A GSPMD constraint's value in the port: a :class:`Placement` or
    ``None``; anything else raises ``TypeError``."""
    if value is not None and not isinstance(value, Placement):
        raise TypeError(f"{what} takes a Placement or None, not {type(value).__name__}")


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


# ---------------------------------------------------------------------------
# the model-sharding rules (reference :20-131)
# ---------------------------------------------------------------------------


def default_rules(mesh) -> Dict[str, Tuple[str, ...]]:
    """Logical axis name -> the mesh axes it splits over."""
    dp = tuple(a for a in ("pod", "data") if a in mesh.shape)
    return {
        # tensor-parallel dims
        "vocab": ("model",),
        "heads": ("model",),
        "kv_heads": ("model",),
        "ffn": ("model",),
        "experts": ("model",),
        "head_dim": ("model",),   # KV-cache contraction-dim sharding
        # FSDP / ZeRO-3 dim
        "embed": dp,
        # data-parallel dims
        "batch": dp,
        "nodes": dp,
        "edges": dp,
        "triplets": dp,
        "candidates": dp,
        "stream": dp,
        # sketch rows (paper plane)
        "sketch_rows": ("model",),
        "seq": ("model",),        # sequence parallelism (long-context KV)
    }


@dataclasses.dataclass
class ResolveReport:
    fallbacks: List[str] = dataclasses.field(default_factory=list)

    def note(self, msg: str):
        self.fallbacks.append(msg)


def resolve_pspec(
    logical: Optional[Tuple],
    shape: Sequence[int],
    mesh,
    rules: Dict[str, Tuple[str, ...]],
    report: Optional[ResolveReport] = None,
    path: str = "",
) -> Tuple:
    """One tensor's logical names -> its spec (the reference's
    ``PartitionSpec`` as a tuple), replicating dimensions the mesh does not
    divide."""
    if logical is None:
        return ()
    parts = []
    used_axes: set = set()
    for dim, name in zip(shape, logical):
        if name is None:
            parts.append(None)
            continue
        axes = tuple(a for a in rules.get(name, ()) if a in mesh.shape and a not in used_axes)
        if not axes:
            parts.append(None)
            continue
        total = math.prod(mesh.shape[a] for a in axes)
        if dim % total != 0:
            # try a prefix of the axes that divides
            ok = None
            for cut in range(len(axes) - 1, 0, -1):
                if dim % math.prod(mesh.shape[a] for a in axes[:cut]) == 0:
                    ok = axes[:cut]
                    break
            if ok is None:
                if report is not None:
                    report.note(f"{path}: dim {dim} ({name}) % mesh{axes}={total} != 0 -> replicated")
                parts.append(None)
                continue
            if report is not None:
                report.note(f"{path}: dim {dim} ({name}) -> partial axes {ok}")
            axes = ok
        used_axes.update(axes)
        parts.append(axes if len(axes) > 1 else axes[0])
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def _is_shaped(x) -> bool:
    return hasattr(x, "shape") and not isinstance(x, type)


def _logical_up_to(shape_tree: Any, logical: Any, out: List) -> None:
    """``logical``'s node at each leaf of ``shape_tree``, in leaf order (the
    reference's ``treedef.flatten_up_to``): a logical tuple or ``None`` is
    one leaf's whole annotation."""
    if _is_shaped(shape_tree):
        out.append(logical)
    elif isinstance(shape_tree, dict):
        for k in sorted(shape_tree):
            _logical_up_to(shape_tree[k], None if logical is None else logical[k], out)
    elif isinstance(shape_tree, (list, tuple)):
        if logical is not None and len(logical) != len(shape_tree):
            raise ValueError(f"logical tree {logical!r} does not match {len(shape_tree)} subtrees")
        for i, sub in enumerate(shape_tree):
            _logical_up_to(sub, None if logical is None else logical[i], out)
    else:
        raise TypeError(f"no shape at a leaf of the shape tree: {shape_tree!r}")


def resolve_tree(
    logical_tree: Any,
    shape_tree: Any,
    mesh,
    rules: Optional[Dict] = None,
    report: Optional[ResolveReport] = None,
) -> Any:
    """A tree of logical tuples + a tree of shaped leaves (tensors, ``meta``
    ones included) -> a tree of :class:`Placement` aligned with
    ``shape_tree``.  Leaves are numbered in flattening order (dict keys
    sorted), the path the reference's fallback notes carry."""
    rules = rules or default_rules(mesh)
    flat_shapes = tree_leaves(shape_tree)
    flat_logical: List = []
    _logical_up_to(shape_tree, logical_tree, flat_logical)
    placements = [
        Placement(mesh, resolve_pspec(lg, tuple(sh.shape), mesh, rules, report, path=str(i)))
        for i, (lg, sh) in enumerate(zip(flat_logical, flat_shapes, strict=True))
    ]
    return tree_unflatten(shape_tree, placements)


def like_tree(logical_leaf_fn, tree) -> Any:
    """Build a logical tree by mapping a fn over the leaves of `tree`."""
    return tree_map(logical_leaf_fn, tree)
