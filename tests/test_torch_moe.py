"""Parity of the port's mixture of experts (``models/layers.py``: ``MoEArgs``,
``moe_capacity``, ``route``, ``moe_block``; through ``models/transformer.py``
``forward``/``loss_fn``) with the JAX reference, at the reference's SMOKE
widths (``src/repro/configs/{mixtral_8x22b,arctic_480b}.py``, float32
compute), on the same numpy inputs.

Tolerances, float32:
- the dispatch gather and the combine's scatter-add, given the reference's
  own routing table and the same expert outputs, are exact (a gather, and
  at most top_k = 2 adds onto zero a row);
- the routing tables are equal where every token's margin between its k-th
  and (k+1)-th probability exceeds 1e-6 (the fp32 router products may
  differ in the last bit between XLA and torch, and ``jax.lax.top_k`` and
  ``torch.topk`` may order ties differently); a token below it is counted
  and printed, and only its experts' choice is excused;
- the block's output, matmuls of widths up to 128 summed in another order:
  atol 1e-5, rtol 1e-5; the aux loss rtol 1e-6;
- ``forward``/``loss_fn`` two layers deep: logits rtol 1e-4 atol 1e-5, the
  loss and aux rtol 1e-5, the flat gradient atol 1e-5 · max|g| (rtol 1e-3),
  as the dense transformer's tests hold them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import arctic_480b, mixtral_8x22b
from repro.models import layers as ref_layers
from repro.models import transformer as ref_tfm
from repro.train.compression import flatten_grads as ref_flatten
from repro_torch.convert import transformer_params_from_arrays
from repro_torch.models import layers, transformer as tfm
from repro_torch.train.compression import flatten_grads
from repro_torch.train.trainer import value_and_grad

from _torch_parity import port_transformer_config, transformer_numpy_params

SMOKES = {"mixtral": mixtral_8x22b.SMOKE, "arctic": arctic_480b.SMOKE}
NEAR_TIE = 1e-6
_ref_moe_block = jax.jit(ref_layers.moe_block, static_argnums=5)
_ref_route = jax.jit(ref_layers._route_local, static_argnums=(2, 3, 4, 5))


def _ref_tree(ref_cfg, seed=0):
    """A numpy tree of the reference's ``init_params`` shapes (read
    abstractly), drawn with numpy."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: ref_tfm.init_params(ref_cfg, jax.random.key(0)))
    return jax.tree.map(lambda s: rng.normal(0, 0.1, s.shape).astype(np.float32), shapes)


def _moe_inputs(ref_cfg, t, seed):
    rng = np.random.default_rng(seed)
    d, f, e = ref_cfg.d_model, ref_cfg.d_ff, ref_cfg.moe.n_experts
    # tokens share a mean direction, as hidden states do, so the experts' loads differ
    x = (rng.normal(0, 1, (t, d)) + rng.normal(0, 1, d)).astype(np.float32)
    router = (rng.normal(0, 1, (d, e)) / np.sqrt(d)).astype(np.float32)
    wg = (rng.normal(0, 1, (e, d, f)) / np.sqrt(d)).astype(np.float32)
    wu = (rng.normal(0, 1, (e, d, f)) / np.sqrt(d)).astype(np.float32)
    wd = (rng.normal(0, 1, (e, f, d)) / np.sqrt(f)).astype(np.float32)
    return x, router, wg, wu, wd


def _args(ref_cfg, capacity_factor):
    m = ref_cfg.moe
    ref = dataclasses.replace(m, capacity_factor=capacity_factor)
    port = layers.MoEArgs(n_experts=m.n_experts, top_k=m.top_k, capacity_factor=capacity_factor,
                          dense_residual=m.dense_residual, aux_loss_coef=m.aux_loss_coef, partition=m.partition)
    return ref, port


def _full(ref_cfg):
    """A capacity factor at which no token can drop: E / k."""
    return ref_cfg.moe.n_experts / ref_cfg.moe.top_k


def _margins(x, router, k):
    """Each token's gap between its k-th and (k+1)-th router probability
    (the reference's float32 softmax)."""
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), axis=-1))
    srt = np.sort(probs, axis=-1)[:, ::-1]
    return srt[:, k - 1] - srt[:, k]


@pytest.mark.parametrize("t", [1, 7, 64, 128, 1000, 32_768])
@pytest.mark.parametrize("cf", [1.0, 1.25, 4.0])
def test_moe_capacity_matches_reference(t, cf):
    for ref_cfg in SMOKES.values():
        ref, port = _args(ref_cfg, cf)
        assert layers.moe_capacity(t, port) == ref_layers.moe_capacity(t, ref)


@pytest.mark.parametrize("name", sorted(SMOKES))
@pytest.mark.parametrize("cf", ["1.25", "full"])
def test_routing_tables_match_reference(name, cf):
    ref_cfg = SMOKES[name]
    factor = 1.25 if cf == "1.25" else _full(ref_cfg)
    x, router, *_ = _moe_inputs(ref_cfg, 96, seed=1)
    e, k = ref_cfg.moe.n_experts, ref_cfg.moe.top_k
    ref, port = _args(ref_cfg, factor)
    c = ref_layers.moe_capacity(96, ref)
    want_table, want_gates, want_aux = _ref_route(jnp.asarray(x), jnp.asarray(router), e, k, factor,
                                                  ref.aux_loss_coef)
    table, gates, aux = layers.route(torch.from_numpy(x), torch.from_numpy(router), e, k, c, port.aux_loss_coef)
    assert table.shape == (e, c) and table.dtype == torch.int64 and gates.dtype == torch.float32
    margins = _margins(x, router, k)
    near = int(np.sum(margins <= NEAR_TIE))
    print(f"{name} at {cf}: {near} of 96 tokens within {NEAR_TIE} of a tie")
    if near == 0:
        np.testing.assert_array_equal(table.numpy(), np.asarray(want_table))
    else:  # a near-tie may take another expert (and shift later slots): compare the clear tokens' experts
        clear = margins > NEAR_TIE
        got_top = torch.topk(torch.softmax(torch.from_numpy(x) @ torch.from_numpy(router), -1), k).indices.numpy()
        want_top = np.asarray(jax.lax.top_k(jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router)), k)[1])
        np.testing.assert_array_equal(np.sort(got_top[clear], -1), np.sort(want_top[clear], -1))
        return
    np.testing.assert_allclose(gates.numpy(), np.asarray(want_gates), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
    dropped = 96 * k - int((np.asarray(want_table) < 96).sum())
    assert (dropped > 0) == (cf == "1.25"), dropped  # drops at 1.25, none at full capacity


@pytest.mark.parametrize("name", sorted(SMOKES))
def test_dispatch_and_combine_exact_given_reference_tables(name):
    ref_cfg = SMOKES[name]
    t = 96
    x, router, wg, wu, wd = _moe_inputs(ref_cfg, t, seed=2)
    e, k = ref_cfg.moe.n_experts, ref_cfg.moe.top_k
    table, gates, _ = _ref_route(jnp.asarray(x), jnp.asarray(router), e, k, 1.25, 0.01)
    table_np = np.asarray(table)
    x_pad = jnp.concatenate([jnp.asarray(x), jnp.zeros((1, x.shape[1]), x.dtype)], axis=0)
    want_xe = np.asarray(x_pad[table])
    got_xe = layers._dispatch(torch.from_numpy(x), torch.from_numpy(table_np.astype(np.int64)))
    np.testing.assert_array_equal(got_xe.numpy(), want_xe)

    ye = np.random.default_rng(3).normal(0, 1, want_xe.shape).astype(np.float32)
    ye[table_np == t] = 0.0  # the unfilled slots' rows are zero, as the experts leave them
    want_y = np.asarray(jnp.zeros((t + 1, x.shape[1]), jnp.float32).at[table.reshape(-1)].add(
        jnp.asarray(ye).reshape(-1, x.shape[1]))[:t])
    got_y = layers._combine(torch.from_numpy(ye), torch.from_numpy(table_np.astype(np.int64)), t, torch.float32)
    np.testing.assert_array_equal(got_y.numpy(), want_y)

    # The experts on the same dispatched tokens and gates, within float32 sums.
    want_ye = jax.nn.silu(jnp.einsum("ecd,edf->ecf", want_xe, wg)) * jnp.einsum("ecd,edf->ecf", want_xe, wu)
    want_ye = jnp.einsum("ecf,efd->ecd", want_ye, wd) * gates[..., None]
    got_ye = layers._experts(got_xe, *map(torch.from_numpy, (wg, wu, wd)), torch.from_numpy(np.array(gates)))
    np.testing.assert_allclose(got_ye.numpy(), np.asarray(want_ye), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,cf,t", [(n, cf, 96) for n in sorted(SMOKES) for cf in ("1.25", "full")]
                         + [("mixtral", "1.25", 5)])
def test_moe_block_matches_reference(name, cf, t):
    ref_cfg = SMOKES[name]
    ref, port = _args(ref_cfg, 1.25 if cf == "1.25" else _full(ref_cfg))
    x, router, wg, wu, wd = _moe_inputs(ref_cfg, t, seed=4)
    assert np.all(_margins(x, router, ref.top_k) > NEAR_TIE)
    want_y, want_aux = _ref_moe_block(*map(jnp.asarray, (x, router, wg, wu, wd)), ref)
    got_y, got_aux = layers.moe_block(*map(torch.from_numpy, (x, router, wg, wu, wd)), port)
    assert got_y.shape == (t, ref_cfg.d_model) and got_y.dtype == torch.float32
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-6)


def test_moe_block_bf16_keeps_the_reference_dtypes():
    ref_cfg = SMOKES["mixtral"]
    ref, port = _args(ref_cfg, 1.25)
    x, router, wg, wu, wd = _moe_inputs(ref_cfg, 32, seed=5)
    got_y, got_aux = layers.moe_block(*(torch.from_numpy(a).to(torch.bfloat16) for a in (x, router, wg, wu, wd)), port)
    want_y, want_aux = _ref_moe_block(*(jnp.asarray(a, jnp.bfloat16) for a in (x, router, wg, wu, wd)), ref)
    assert got_y.dtype == torch.bfloat16 and got_aux.dtype == torch.float32
    want = np.asarray(want_y, np.float32)
    np.testing.assert_allclose(got_y.float().numpy(), want, rtol=0, atol=0.05 * np.abs(want).max())


def _pair(ref_cfg, seed=0, **changes):
    ref_cfg = dataclasses.replace(ref_cfg, **changes)
    cfg = port_transformer_config(ref_cfg)
    tree = transformer_numpy_params(cfg, seed)
    return ref_cfg, cfg, jax.tree.map(jnp.asarray, tree), transformer_params_from_arrays(cfg, tree)


@pytest.mark.parametrize("name", sorted(SMOKES))
def test_forward_loss_aux_and_gradient_match_reference(name):
    """Both configs' logits, loss and aux; the flat gradient on arctic's,
    whose layers hold both FFN branches (experts and the dense residual)."""
    ref_cfg, cfg, ref_params, params = _pair(SMOKES[name])
    tokens = np.random.default_rng(6).integers(0, cfg.vocab, (2, 17)).astype(np.int32)
    if name != "arctic":
        want_logits, want_aux = jax.jit(lambda p, t: ref_tfm.forward(ref_cfg, p, t))(ref_params,
                                                                                     jnp.asarray(tokens[:, :-1]))
        got_logits, got_aux = tfm.forward(cfg, params, torch.from_numpy(tokens[:, :-1]))
        np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-5)
        want_loss, want_info = jax.jit(lambda p, t: ref_tfm.loss_fn(ref_cfg, p, t))(ref_params, jnp.asarray(tokens))
        loss, info = tfm.loss_fn(cfg, params, torch.from_numpy(tokens))
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
        np.testing.assert_allclose(float(info["aux"]), float(want_info["aux"]), rtol=1e-5)
        assert float(info["aux"]) > 0
        return
    (want_loss, want_info), want_grads = jax.jit(jax.value_and_grad(
        lambda p, t: ref_tfm.loss_fn(ref_cfg, p, t), has_aux=True))(ref_params, jnp.asarray(tokens))
    (loss, info), grads = value_and_grad(lambda p, t: tfm.loss_fn(cfg, p, t), params, torch.from_numpy(tokens))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(float(info["aux"]), float(want_info["aux"]), rtol=1e-5)
    assert float(info["aux"]) > 0
    want_flat = np.asarray(ref_flatten(want_grads)[0])
    got_flat = flatten_grads(grads)[0].numpy()
    assert got_flat.shape == want_flat.shape
    np.testing.assert_allclose(got_flat, want_flat, rtol=1e-3, atol=1e-5 * np.abs(want_flat).max())


def test_remat_equals_no_remat():
    _, cfg, _, params = _pair(SMOKES["mixtral"], attn_q_chunk=8, attn_window_slicing=True)
    tokens = torch.from_numpy(np.random.default_rng(7).integers(0, cfg.vocab, (1, 21)).astype(np.int64))
    (loss, info), grads = value_and_grad(lambda p, t: tfm.loss_fn(cfg, p, t), params, tokens)
    remat = dataclasses.replace(cfg, remat=True)
    (loss_r, info_r), grads_r = value_and_grad(lambda p, t: tfm.loss_fn(remat, p, t), params, tokens)
    assert float(loss_r) == float(loss) and float(info_r["aux"]) == float(info["aux"])
    assert torch.equal(flatten_grads(grads_r)[0], flatten_grads(grads)[0])


@pytest.mark.parametrize("name", sorted(SMOKES))
def test_param_specs_counts_and_shapes_match_reference(name):
    ref_cfg = SMOKES[name]
    cfg = port_transformer_config(ref_cfg)
    assert tfm.param_specs(cfg) == ref_tfm.param_specs(ref_cfg)
    assert cfg.param_count() == ref_cfg.param_count()
    assert cfg.active_param_count() == ref_cfg.active_param_count()
    for full in (mixtral_8x22b.FULL, arctic_480b.FULL):
        port_full = port_transformer_config(full)
        assert port_full.param_count() == full.param_count()
        assert port_full.active_param_count() == full.active_param_count()
        assert tfm.param_specs(port_full) == ref_tfm.param_specs(full)
    shapes = jax.eval_shape(lambda: ref_tfm.init_params(ref_cfg, jax.random.key(0)))
    got = tfm.param_shapes(cfg)
    assert jax.tree.structure(jax.tree.map(lambda s: 0, got, is_leaf=lambda s: isinstance(s, tuple))) == \
        jax.tree.structure(jax.tree.map(lambda s: 0, shapes))
    tree = tfm.init_params(cfg, torch.Generator().manual_seed(0))
    for leaf, want in zip(jax.tree.leaves(tree), jax.tree.leaves(shapes)):
        assert tuple(leaf.shape) == want.shape
    assert sum(x.numel() for x in jax.tree.leaves(tree)) == sum(x.size for x in jax.tree.leaves(shapes))


def test_converter_takes_moe_trees_and_refuses_wrong_ones():
    ref_cfg = SMOKES["arctic"]
    cfg = port_transformer_config(ref_cfg)
    tree = _ref_tree(ref_cfg)
    params = transformer_params_from_arrays(cfg, tree)
    assert torch.equal(params["layers"]["moe_down"], torch.from_numpy(tree["layers"]["moe_down"]))
    bad = {**tree, "layers": {**tree["layers"], "moe_gate": tree["layers"]["moe_gate"][:, :, :, :8]}}
    with pytest.raises(ValueError):
        transformer_params_from_arrays(cfg, bad)
    missing = {**tree, "layers": {n: v for n, v in tree["layers"].items() if n != "router"}}
    with pytest.raises(ValueError):
        transformer_params_from_arrays(cfg, missing)
    # a dense tree is not an MoE tree: the dense FFN goes when the experts replace it
    mixtral = port_transformer_config(SMOKES["mixtral"])
    assert "w_gate" not in tfm.param_shapes(mixtral)["layers"]
    with pytest.raises(ValueError):
        transformer_params_from_arrays(mixtral, tree)


def test_act_pspec_still_raises():
    """The layer carry's constraint is a Placement or None; anything else
    (a bare spec tuple, a foreign object) raises."""
    for bad in (object(), ("data", "model", None)):
        with pytest.raises(TypeError, match="Placement"):
            port_transformer_config(SMOKES["mixtral"], act_pspec=bad)
