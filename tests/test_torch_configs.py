"""Parity of the port's architecture registry (``src/repro_torch/configs``)
with the reference's (``src/repro/configs``): the same ids, the same
(arch, shape) cells with their parameters and skip reasons, and every FULL
and SMOKE config's fields equal, dtypes mapped (``jnp`` to ``torch``).

The reference's ``TransformerConfig.scan_layers`` has no counterpart in
the port (an eager loop has no scan): every config leaves it at its
default, which is checked too, as are the sharding knobs (``act_pspec``,
``dispatch_pspec``, the meshes), which only ``launch/steps.py`` sets."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch

from repro import configs as ref_configs
from repro_torch import configs
from repro_torch.configs import base
from repro_torch.data import graphs

ROOT = Path(__file__).resolve().parents[1]
DTYPES = {jnp.dtype(jnp.float32): torch.float32, jnp.dtype(jnp.bfloat16): torch.bfloat16}


def _same_value(port, ref, where):
    if dataclasses.is_dataclass(ref):
        ref_fields = {f.name for f in dataclasses.fields(ref)}
        port_fields = {f.name for f in dataclasses.fields(port)}
        for name in sorted(ref_fields - port_fields):  # the reference's sharding knobs
            assert name == "scan_layers", f"{where}.{name} is not ported"
            default = True
            assert getattr(ref, name) == default, f"{where}.{name} is set in the reference"
        for name in sorted(port_fields):
            if name in ("mesh", "attn_halo_mesh", "act_pspec", "dispatch_pspec", "shard_dispatch"):
                assert getattr(port, name) == getattr(ref, name) in (None, False), f"{where}.{name}"
                continue
            assert name in ref_fields, f"{where}.{name} is not the reference's"
            _same_value(getattr(port, name), getattr(ref, name), f"{where}.{name}")
        return
    if isinstance(port, torch.dtype):
        assert DTYPES[jnp.dtype(ref)] == port, where
        return
    assert type(port) is type(ref) and port == ref, (where, port, ref)


@pytest.fixture(autouse=True)
def _reference_registry():
    """The reference's registry loads only when empty, so a test process
    that imported one of its config modules first sees just that one: load
    them all."""
    ref_configs.load_all()


def _in_arch_order(cells):
    """The reference lists its cells in the order its config modules were
    imported; the port in ``ARCH_IDS`` order.  The same cells, that order."""
    order = [*ref_configs.ARCH_IDS, "glava"]
    return sorted(cells, key=lambda c: order.index(c[0] if isinstance(c, tuple) else c))


def test_arch_ids_and_cells_equal_the_reference():
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS
    assert len(configs.ARCH_IDS) == 10
    assert configs.all_cells() == _in_arch_order(ref_configs.all_cells())
    assert configs.all_cells(include_skipped=True) == _in_arch_order(ref_configs.all_cells(include_skipped=True))
    assert len(configs.all_cells(include_skipped=True)) == 40
    ref_archs = ref_configs.all_archs()
    assert list(configs.all_archs()) == _in_arch_order(list(ref_archs))
    for arch_id, spec in configs.all_archs().items():
        ref = ref_archs[arch_id]
        assert (spec.arch_id, spec.family, spec.notes) == (ref.arch_id, ref.family, ref.notes)
        assert spec.cells() == ref.cells()
        assert list(spec.shapes) == list(ref.shapes)
        for name, shape in spec.shapes.items():
            want = ref.shapes[name]
            assert (shape.name, shape.kind, shape.params, shape.skip) == (want.name, want.kind, want.params,
                                                                          want.skip), (arch_id, name)


@pytest.mark.parametrize("arch_id", [*ref_configs.ARCH_IDS, "glava"])
def test_full_and_smoke_configs_equal_the_reference(arch_id):
    spec, ref = configs.get_arch(arch_id), ref_configs.get_arch(arch_id)
    for which in ("config", "smoke_config"):
        port_cfg, ref_cfg = getattr(spec, which), getattr(ref, which)
        assert type(port_cfg).__name__ == type(ref_cfg).__name__
        assert type(port_cfg).__module__ == type(ref_cfg).__module__.replace("repro.", "repro_torch.", 1)
        _same_value(port_cfg, ref_cfg, f"{arch_id}.{which}")
    if spec.family == "lm":
        for which in ("config", "smoke_config"):
            c, r = getattr(spec, which), getattr(ref, which)
            assert (c.param_count(), c.active_param_count(), c.head_dim) == (
                r.param_count(), r.active_param_count(), r.head_dim)


def test_triplet_budget_has_one_definition():
    assert base.triplet_budget is graphs.triplet_budget
    assert (base.TRIPLET_FACTOR, base.TRIPLET_CAP) == (ref_configs.base.TRIPLET_FACTOR, ref_configs.base.TRIPLET_CAP)
    for e in (0, 8192, 168_960, 1 << 23, 1 << 24):
        assert configs.triplet_budget(e) == ref_configs.triplet_budget(e)
    assert configs.triplet_budget(8192) == 65_536 and configs.triplet_budget(168_960) == 1_351_680


def test_glava_presets_and_stream_shapes():
    from repro.configs import glava as ref_glava
    from repro_torch.configs import glava

    for name in ("WEB", "BASE", "NONSQUARE", "SMOKE"):
        _same_value(getattr(glava, name), getattr(ref_glava, name), name)
    assert {k: (s.kind, s.params) for k, s in glava.STREAM_SHAPES.items()} == {
        k: (s.kind, s.params) for k, s in ref_glava.STREAM_SHAPES.items()}
    assert glava.QUERY_64K == 65_536 and configs.get_arch("glava") is glava.SPEC


def test_registry_loads_whatever_was_imported_first():
    """Importing ``configs.glava`` alone registers one spec; ``get_arch`` of
    another id still finds it (the reference's raises KeyError there)."""
    code = ("import repro_torch.configs.glava\n"
            "from repro_torch.configs import base, get_arch\n"
            "assert list(base._REGISTRY) == ['glava']\n"
            "print(get_arch('bert4rec').config.vocab, len(base._REGISTRY))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.stdout.split() == ["1000448", "11"]
