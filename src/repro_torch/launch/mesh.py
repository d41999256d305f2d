"""Production meshes, the port of ``src/repro/launch/mesh.py``.

``make_production_mesh`` keeps the reference's axis layouts, ``(16, 16)``
over ``("data", "model")`` and ``(2, 16, 16)`` over ``("pod", "data",
"model")``, applied here to 256 or 512 H100s.  One card cannot host 256
ranks, so the mesh is an :class:`~repro_torch.distributed.mesh.AbstractMesh`
(axis sizes, no process group): the sharding rules resolve onto it and the
dry run reads each device's block from it.  The layouts are kept because
the registry's divisibility fallbacks (Arctic's 56 heads on a 16-way model
axis, say) are defined on them; no TPU number is carried over with them.

``make_host_mesh`` is the rank mesh of ``distributed/mesh.py``, re-exported.
"""
from __future__ import annotations

from repro_torch.distributed.mesh import AbstractMesh, make_host_mesh  # noqa: F401

SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """16 x 16 = 256 devices a pod; 2 pods = 512 devices multi-pod."""
    return AbstractMesh(*(MULTI_POD if multi_pod else SINGLE_POD))


def dp_axes(mesh) -> tuple:
    """The data-parallel axes of a mesh (pod axis included when present)."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)
