"""Parity of the port's model-sharding rules
(``src/repro_torch/distributed/sharding.py``: ``default_rules``,
``ResolveReport``, ``resolve_pspec``, ``resolve_tree``, ``like_tree``) with
``src/repro/distributed/sharding.py:20-131``.

Every case of ``tests/test_sharding_resolver.py`` runs against both
packages and gives the same spec tuples and fallback notes; then every leaf
of every live cell's state and batch logical trees, on both production
layouts, resolves to the reference's spec (the reference's
``resolve_pspec`` on the reference's shapes, over an object exposing only
``.shape``, as its own tests do).  ``resolve_tree`` takes the three kinds
of mesh, and a placement on the abstract mesh gives each device's block.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import load_all as ref_load_all
from repro.distributed import sharding as ref_sh
from repro.launch import steps as ref_steps
from repro_torch.configs import all_cells
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.mesh import AbstractMesh
from repro_torch.launch.mesh import dp_axes, make_production_mesh
from repro_torch.tree import tree_leaves


class FakeMesh:
    """An object exposing only ``.shape``, as the reference's tests use."""

    def __init__(self, shape):
        self.shape = dict(shape)


RESOLVER_CASES = [
    # (logical, shape, mesh shape, rules, path): tests/test_sharding_resolver.py
    (("vocab", "embed"), (32768, 6144), {"pod": 2, "data": 16, "model": 16},
     {"vocab": ("model",), "embed": ("pod", "data")}, ""),
    (("heads",), (56,), {"data": 16, "model": 16}, {"heads": ("model",)}, "wq"),
    (("batch",), (16,), {"pod": 2, "data": 16}, {"batch": ("pod", "data")}, ""),
    (("heads", "ffn"), (64, 64), {"model": 16}, {"heads": ("model",), "ffn": ("model",)}, ""),
    ((None, "vocab", None), (5, 32, 7), {"model": 16}, {"vocab": ("model",)}, ""),
]
WANT = [("model", ("pod", "data")), (), ("pod",), ("model",), (None, "model")]


@pytest.mark.parametrize("case,want", list(zip(RESOLVER_CASES, WANT)))
def test_resolver_cases_match_the_reference(case, want):
    logical, shape, mesh_shape, rules, path = case
    rep, ref_rep = sh.ResolveReport(), ref_sh.ResolveReport()
    got = sh.resolve_pspec(logical, shape, FakeMesh(mesh_shape), rules, rep, path=path)
    ref = ref_sh.resolve_pspec(logical, shape, FakeMesh(mesh_shape), rules, ref_rep, path=path)
    assert got == tuple(ref) == want
    assert rep.fallbacks == ref_rep.fallbacks
    # the same on the port's abstract mesh
    mesh = AbstractMesh(tuple(mesh_shape.values()), tuple(mesh_shape))
    assert sh.resolve_pspec(logical, shape, mesh, rules) == want


def test_fallback_notes_read_as_the_references():
    rep = sh.ResolveReport()
    sh.resolve_pspec(("heads",), (56,), FakeMesh({"data": 16, "model": 16}), {"heads": ("model",)}, rep, path="wq")
    sh.resolve_pspec(("batch",), (16,), FakeMesh({"pod": 2, "data": 16}), {"batch": ("pod", "data")}, rep, path="7")
    assert rep.fallbacks == ["wq: dim 56 (heads) % mesh('model',)=16 != 0 -> replicated",
                             "7: dim 16 (batch) -> partial axes ('pod',)"]


@pytest.mark.parametrize("multi_pod", [False, True])
def test_default_rules_and_dp_axes(multi_pod):
    mesh = make_production_mesh(multi_pod=multi_pod)
    shape = {"pod": 2, "data": 16, "model": 16} if multi_pod else {"data": 16, "model": 16}
    assert mesh.shape == shape
    assert sh.default_rules(mesh) == ref_sh.default_rules(FakeMesh(shape))
    assert dp_axes(mesh) == tuple(a for a in ("pod", "data") if a in shape)


@pytest.fixture(scope="module")
def ref_bundles():
    ref_load_all()
    return {cell: ref_steps.build_step(*cell, smoke=False) for cell in all_cells()}


def _ref_specs(logical_tree, shape_tree, mesh_shape):
    """The reference's ``resolve_pspec`` on every leaf, in leaf order, and
    its fallback notes (``resolve_tree``'s numbering)."""
    flat, treedef = jax.tree.flatten(shape_tree, is_leaf=lambda x: hasattr(x, "shape"))
    logical = treedef.flatten_up_to(logical_tree)
    mesh = FakeMesh(mesh_shape)
    rules = ref_sh.default_rules(mesh)
    rep = ref_sh.ResolveReport()
    specs = [tuple(ref_sh.resolve_pspec(lg, tuple(x.shape), mesh, rules, rep, path=str(i)))
             for i, (lg, x) in enumerate(zip(logical, flat))]
    return specs, rep.fallbacks


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod16x16", "pod2x16x16"])
def test_every_cell_resolves_as_the_reference(ref_bundles, multi_pod):
    from repro_torch.launch.steps import build_step

    mesh = make_production_mesh(multi_pod=multi_pod)
    checked = 0
    for cell, ref in ref_bundles.items():
        port = build_step(*cell, mesh=mesh, device="meta")
        for what, logical, shapes, ref_logical, ref_shapes in (
            ("state", port.state_logical, port.state_specs(), ref.state_logical, ref.state_specs()),
            ("batch", port.batch_logical, port.batch_specs, ref.batch_logical, ref.batch_specs),
        ):
            rep = sh.ResolveReport()
            placements = tree_leaves(sh.resolve_tree(logical, shapes, mesh, report=rep))
            want, notes = _ref_specs(ref_logical, ref_shapes, mesh.shape)
            assert [p.spec for p in placements] == want, (cell, what)
            assert rep.fallbacks == notes, (cell, what)
            assert all(p.mesh is mesh for p in placements)
            checked += len(placements)
    assert checked > 1000


def test_resolve_tree_on_a_rank_mesh_and_on_a_shape_only_mesh():
    """A rank Mesh (one gloo rank) and an object with only ``.shape``
    resolve as the abstract mesh does; ``like_tree`` maps a leaf function."""
    from repro_torch.analysis.contracts import one_rank_group
    from repro_torch.distributed.mesh import make_host_mesh

    shapes = {"w": torch.empty((4, 6), device="meta"), "b": [torch.empty((6,), device="meta")]}
    logical = {"w": ("embed", "ffn"), "b": [("ffn",)]}
    with one_rank_group("cpu"):
        ranks = make_host_mesh(1, 1)
        got = sh.resolve_tree(logical, shapes, ranks)
    assert got["w"].spec == ("data", "model") and got["b"][0].spec == ("model",)
    fake = sh.resolve_tree(logical, shapes, FakeMesh({"data": 4, "model": 4}))
    assert fake["w"].spec == ("data",) and fake["b"][0].spec == ()  # 6 % 4: replicated
    assert sh.like_tree(lambda x: (None,) * x.dim(), shapes) == {"w": (None, None), "b": [(None,)]}


def test_block_shape_on_the_abstract_mesh():
    mesh = make_production_mesh(multi_pod=True)
    place = sh.Placement(mesh, (("pod", "data"), "model"))
    assert place.block_shape((256, 4096, 7)) == (8, 256, 7)
    assert place.axes() == ("pod", "data", "model")
    with pytest.raises(ValueError):
        place.block_shape((56, 16))  # 56 rows over 32 devices
    # the same block as the reference's NamedSharding.shard_shape arithmetic
    assert np.prod(place.block_shape((512, 32))) * 512 == 512 * 32
