"""Meshes of ``torch.distributed`` ranks: the counterpart of
``jax.make_mesh`` and of ``src/repro/launch/mesh.py:31`` ``make_host_mesh``;
and :class:`AbstractMesh`, axis names and sizes with no ranks behind them.

A :class:`Mesh` lays the ``world_size`` ranks of the default process group
out over named axes, row-major, as ``jax.make_mesh`` lays out devices: rank
``r`` sits at the coordinates of ``r`` in ``numpy.arange(world).reshape(
shape)``.  It builds one process group per axis and per tuple of axes (the
ranks that differ only along those axes), with ``dist.new_group``, so a
collective over ``"model"`` or over ``("pod", "data")`` runs on exactly the
ranks a ``psum`` over those axes would combine.

The caller initialises the default process group, as torch users do
(``dist.init_process_group`` with a ``FileStore`` or a
``tcp://localhost:<port>`` address, the world size and this rank); the port
never does.  Constructing a mesh is collective: every rank constructs the
same mesh at the same point of its program.

Collectives.  The port uses only ``all_reduce`` (``SUM``, ``MIN`` and
``MAX``): gloo
runs only ``all_reduce`` and ``broadcast`` on CUDA tensors (no
``all_gather``, no ``reduce_scatter``, no ``ReduceOp.AVG``, no barrier on
device tensors), and several ranks on one card need gloo, because NCCL
refuses two ranks on one GPU.  A mean is a ``SUM`` divided by the group's
size; a gather is a ``SUM`` of zero-filled buffers that each hold one
rank's disjoint block (exact); a broadcast from rank 0 is a ``SUM`` to which
the other ranks add zeros; a barrier is a ``SUM`` of one element.  For
the same reason the port builds plain groups, not ``DeviceMesh``/``DTensor``,
whose redistributions need ``all_gather`` and ``reduce_scatter``.

Each mesh keeps a record of its last :data:`COLLECTIVE_RECORD_MAXLEN`
``all_reduce_`` calls (``Mesh.collectives``: the op, the payload's bytes,
the group's size and axes), which the roofline's collective term reads
(``repro_torch.roofline.analysis.parse_collectives``) where the reference
parses the post-SPMD HLO.
"""
from __future__ import annotations

import collections
import itertools
import math
from typing import Deque, Dict, List, Sequence, Tuple, Union

import torch
import torch.distributed as dist

Axes = Union[str, Sequence[str]]

# The all-reduces a mesh keeps on record (the oldest drop out first).
COLLECTIVE_RECORD_MAXLEN = 4096


def mesh_coords(shape: Sequence[int], rank: int) -> Tuple[int, ...]:
    """The coordinates of ``rank`` on a row-major mesh of ``shape``."""
    coords = []
    for size in reversed(shape):
        coords.append(rank % size)
        rank //= size
    return tuple(reversed(coords))


def axis_groups(shape: Sequence[int], axis_names: Sequence[str], axes: Sequence[str]):
    """The rank lists of the groups over ``axes``: for each setting of the
    other axes (row-major), the ranks that vary along ``axes`` (row-major
    over them), as ``psum`` over ``axes`` combines devices."""
    sel = [axis_names.index(a) for a in axes]
    rest = [i for i in range(len(shape)) if i not in sel]
    groups = []
    for other in itertools.product(*(range(shape[i]) for i in rest)):
        ranks = []
        for mine in itertools.product(*(range(shape[i]) for i in sel)):
            coords = [0] * len(shape)
            for i, c in zip(rest, other):
                coords[i] = c
            for i, c in zip(sel, mine):
                coords[i] = c
            rank = 0
            for c, size in zip(coords, shape):
                rank = rank * size + c
            ranks.append(rank)
        groups.append(ranks)
    return groups


class Mesh:
    """Named axes over the ranks of the default process group.

    ``shape`` maps each axis name to its size, in mesh order (as
    ``jax.sharding.Mesh.shape``); ``axis_names`` is their tuple; ``rank`` is
    this process's rank and ``coords`` its coordinate on each axis."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        shape = tuple(int(s) for s in shape)
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axis names {axis_names} do not match")
        if not dist.is_initialized():
            raise RuntimeError("initialise the default process group (dist.init_process_group) before a Mesh")
        world = dist.get_world_size()
        if math.prod(shape) != world:
            raise ValueError(f"mesh {shape} holds {math.prod(shape)} ranks; the process group has {world}")
        self.shape: Dict[str, int] = dict(zip(axis_names, shape))
        self.axis_names = axis_names
        self.rank = dist.get_rank()
        self.coords: Dict[str, int] = dict(zip(axis_names, mesh_coords(shape, self.rank)))
        self.collectives: Deque[Dict] = collections.deque(maxlen=COLLECTIVE_RECORD_MAXLEN)
        # Every rank calls new_group for every group, in one order.
        self._groups = {}
        for n in range(1, len(axis_names) + 1):
            for axes in itertools.combinations(axis_names, n):
                for ranks in axis_groups(shape, axis_names, axes):
                    group = dist.new_group(ranks)
                    if self.rank in ranks:
                        self._groups[axes] = group

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"

    def _axes(self, axes: Axes) -> Tuple[str, ...]:
        """``axes`` as a tuple in mesh order."""
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in names if a not in self.shape]
        if unknown or len(set(names)) != len(names):
            raise ValueError(f"axes {names} are not distinct axes of {self.axis_names}")
        return tuple(a for a in self.axis_names if a in names)

    def size(self, axes: Axes) -> int:
        """The number of ranks a collective over ``axes`` combines."""
        return math.prod(self.shape[a] for a in self._axes(axes))

    def index(self, axes: Axes) -> int:
        """This rank's position among them, row-major over ``axes``."""
        k = 0
        for a in self._axes(axes):
            k = k * self.shape[a] + self.coords[a]
        return k

    def group(self, axes: Axes):
        """The process group of this rank over ``axes``."""
        return self._groups[self._axes(axes)]

    def all_reduce_(self, tensor: torch.Tensor, op, axes: Axes) -> torch.Tensor:
        """``dist.all_reduce`` of ``tensor`` in place over ``axes``, kept on
        record in :attr:`collectives`; returns it."""
        dist.all_reduce(tensor, op=op, group=self.group(axes))
        self.collectives.append({
            "op": "all_reduce", "reduce": str(op).split(".")[-1], "bytes": tensor.numel() * tensor.element_size(),
            "group_size": self.size(axes), "axes": self._axes(axes),
        })
        return tensor

    def _to_host(self, values: Sequence[int], op) -> List[int]:
        """``all_reduce`` of int64 ``values`` over all axes, on the CPU for
        gloo and on the current CUDA device for NCCL, read back on the
        host: it returns only once every rank has entered it."""
        group = self.group(self.axis_names)
        device = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
        out = torch.tensor(list(values), dtype=torch.int64, device=device)
        dist.all_reduce(out, op=op, group=group)
        return out.tolist()

    def barrier(self) -> None:
        """Wait on the host for every rank: a ``SUM`` of one element."""
        self._to_host([0], dist.ReduceOp.SUM)

    def from_rank0(self, values: Sequence[int]) -> List[int]:
        """Rank 0's int64 ``values`` on every rank, once rank 0 has reached
        this call: a ``SUM`` to which the other ranks add zeros."""
        return self._to_host(values if self.rank == 0 else [0] * len(values), dist.ReduceOp.SUM)

    def agree(self, values: Sequence[int]) -> bool:
        """Whether every rank passed the same int64 ``values`` (the same
        answer on every rank): one ``MAX`` of ``values`` and their negation."""
        values = list(values)
        both = self._to_host(values + [-v for v in values], dist.ReduceOp.MAX)
        return both[: len(values)] == [-v for v in both[len(values):]]


class AbstractMesh:
    """Named axes and their sizes, with no process group: the counterpart of
    ``jax.sharding.AbstractMesh``.  It places nothing and runs no
    collective; the sharding rules resolve onto it and a
    :class:`~repro_torch.distributed.sharding.Placement` on it gives each
    device's block shape, for meshes larger than the host (the production
    layouts of ``launch/mesh.py``)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        shape = tuple(int(s) for s in shape)
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axis names {axis_names} do not match")
        self.shape: Dict[str, int] = dict(zip(axis_names, shape))
        self.axis_names = axis_names

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def n_devices(mesh) -> int:
    """The devices of any mesh (a :class:`Mesh`, an :class:`AbstractMesh` or
    anything with a ``.shape`` dict of axis sizes)."""
    return math.prod(mesh.shape.values())


def make_host_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A ``(data, model)`` mesh over the default process group (tests and
    smoke runs), as ``src/repro/launch/mesh.py:31`` makes one over devices."""
    return Mesh((data, model), ("data", "model"))
