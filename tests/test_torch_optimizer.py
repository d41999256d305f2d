"""Parity of the port's AdamW (``train/optimizer.py``) with the JAX
reference's on the same numpy inputs: the schedule, the global-norm clip,
and three ``apply_adamw`` steps with float32 and with bfloat16 moments.

The schedule goes through ``cos`` and the bias corrections through ``pow``,
whose float32 implementations in XLA and in PyTorch may differ in the last
ulp; so the schedule is held to rtol=1e-6, and the AdamW steps are held bit
for bit where those functions see exact inputs (``min_lr_frac=1`` makes the
cosine term vanish, and integer-valued gradients keep the clip exact) and
to rtol=1e-6 elsewhere."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as ref_opt
from repro_torch.convert import adamw_state_from_arrays
from repro_torch.train import optimizer as opt

from _torch_parity import numpy_tree

DTYPES = {"fp32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _cfgs(moments, **kw):
    t, j = DTYPES[moments]
    return opt.AdamWConfig(m_dtype=t, v_dtype=t, **kw), ref_opt.AdamWConfig(m_dtype=j, v_dtype=j, **kw)


def test_lr_schedule_matches_reference():
    port, ref = _cfgs("fp32", lr=1e-3, warmup_steps=20, total_steps=200, min_lr_frac=0.1)
    got = np.array([float(opt.lr_schedule(port, torch.tensor(s, dtype=torch.int32))) for s in range(0, 230)])
    want = np.array([float(ref_opt.lr_schedule(ref, jnp.asarray(s, jnp.int32))) for s in range(0, 230)])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got[0] == 0.0 and got[10] == pytest.approx(5e-4) and got[200] == pytest.approx(1e-4, rel=1e-6)


def test_clip_by_global_norm_matches_reference():
    rng = np.random.default_rng(0)
    tree = {"b": rng.integers(-5, 6, (4, 3)).astype(np.float32), "a": {"x": rng.integers(-5, 6, 7).astype(np.float32)}}
    for max_norm in (1.0, 1000.0):
        want, want_norm = ref_opt.clip_by_global_norm(jax.tree.map(jnp.asarray, tree), max_norm)
        got, got_norm = opt.clip_by_global_norm(jax.tree.map(torch.from_numpy, tree), max_norm)
        assert float(got_norm) == float(want_norm)
        np.testing.assert_array_equal(got["b"].numpy(), np.asarray(want["b"]))
        np.testing.assert_array_equal(got["a"]["x"].numpy(), np.asarray(want["a"]["x"]))


@pytest.mark.parametrize("exact", [True, False], ids=["flat-schedule-integer-grads", "cosine-float-grads"])
@pytest.mark.parametrize("moments", ["fp32", "bf16"])
def test_three_adamw_steps_match_reference(moments, exact):
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10, weight_decay=0.1, grad_clip=1.0)
    if exact:
        kw["min_lr_frac"] = 1.0
    port_cfg, ref_cfg = _cfgs(moments, **kw)
    rng = np.random.default_rng(1)
    params = {"w": rng.normal(0, 1, (6, 5)).astype(np.float32), "b": {"v": rng.normal(0, 1, 5).astype(np.float32)}}
    ref_params = jax.tree.map(jnp.asarray, params)
    ref_state = ref_opt.init_adamw(ref_cfg, ref_params)
    port_params = jax.tree.map(torch.from_numpy, params)
    port_state = opt.init_adamw(port_cfg, port_params)
    for _ in range(3):
        if exact:
            grads = jax.tree.map(lambda p: rng.integers(-3, 4, p.shape).astype(np.float32), params)
        else:
            grads = jax.tree.map(lambda p: rng.normal(0, 1, p.shape).astype(np.float32), params)
        ref_params, ref_state, ref_m = ref_opt.apply_adamw(ref_cfg, ref_state, ref_params, jax.tree.map(jnp.asarray, grads))
        port_params, port_state, port_m = opt.apply_adamw(port_cfg, port_state, port_params, jax.tree.map(torch.from_numpy, grads))
    assert int(port_state.step) == int(ref_state.step) == 3
    assert port_state.m["w"].dtype == port_cfg.m_dtype and port_state.v["b"]["v"].dtype == port_cfg.v_dtype
    pairs = [(port_params, ref_params), (port_state.m, ref_state.m), (port_state.v, ref_state.v)]
    pairs.append(({k: v for k, v in port_m.items()}, ref_m))
    for got, want in pairs:
        for g, w in zip(jax.tree.leaves(jax.tree.map(lambda t: t.float().numpy(), got)),
                        jax.tree.leaves(numpy_tree(want))):
            if exact:
                np.testing.assert_array_equal(g, w)
            else:
                np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)


def test_adamw_state_converts_from_reference():
    port_cfg, ref_cfg = _cfgs("bf16")
    params = {"w": jnp.ones((3, 2))}
    st = ref_opt.init_adamw(ref_cfg, params)
    st = st._replace(m={"w": jnp.full((3, 2), 0.3, jnp.bfloat16)}, step=jnp.asarray(7, jnp.int32))
    port = adamw_state_from_arrays(port_cfg, st.step, numpy_tree(st.m), numpy_tree(st.v))
    assert int(port.step) == 7 and port.m["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(port.m["w"].float().numpy(), np.asarray(st.m["w"], np.float32))


def test_sgd_matches_reference():
    p = {"w": np.arange(6, dtype=np.float32)}
    g = {"w": np.ones(6, np.float32)}
    want = ref_opt.sgd(jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, g), 0.5)
    got = opt.sgd(jax.tree.map(torch.from_numpy, p), jax.tree.map(torch.from_numpy, g), 0.5)
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))
