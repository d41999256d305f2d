"""Parity of the port's dense transformer (``models/layers.py``,
``models/transformer.py``) with the JAX reference on the same numpy
parameters and tokens.

Tolerances, float32: matrix products of widths up to 2,048 summed in
another order than XLA's (relative error ~1e-6 a product, a few layers
deep), so logits and activations are held to rtol=1e-4, atol=1e-5, the loss
to rtol=1e-5, and the flat gradient to atol=1e-5 · max|g| (rtol=1e-3).
bfloat16 compute rounds every activation to 8 bits of mantissa (2^-8 ≈
4e-3 relative), at places where XLA's fusions and PyTorch's kernels may
round differently; the bf16 case holds the loss to rtol=1e-2 and the logits
to atol=0.1 · max|logit|."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as ref_layers
from repro.models import transformer as ref_tfm
from repro.train.compression import flatten_grads as ref_flatten
from repro_torch.convert import transformer_params_from_arrays
from repro_torch.launch.train_lm import PRESETS
from repro_torch.models import layers
from repro_torch.models import transformer as tfm
from repro_torch.train.compression import flatten_grads
from repro_torch.train.trainer import value_and_grad

from _torch_parity import numpy_tree, ref_transformer_config

RNG = np.random.default_rng(5)


def _close(got, want, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), rtol=rtol, atol=atol)


def test_norms_match_reference():
    x = RNG.normal(0, 2, (3, 5, 64)).astype(np.float32)
    w = RNG.normal(1, 0.1, 64).astype(np.float32)
    _close(layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w)), ref_layers.rms_norm(jnp.asarray(x), jnp.asarray(w)))
    _close(layers.layer_norm_nonparam(torch.from_numpy(x)), ref_layers.layer_norm_nonparam(jnp.asarray(x)))
    _close(layers.apply_norm("rmsnorm", torch.from_numpy(x), None), ref_layers.apply_norm("rmsnorm", jnp.asarray(x), None))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = layers.rms_norm(xb, torch.from_numpy(w))
    assert got.dtype == torch.bfloat16
    want = ref_layers.rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w))
    _close(got, np.asarray(want, np.float32), rtol=1e-2, atol=1e-2)


def test_rope_matches_reference_split_half():
    x = RNG.normal(0, 1, (2, 7, 3, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7)[None, :] + 3, (2, 7)).astype(np.int32)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4)
    _close(got, ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4))


@pytest.mark.parametrize("window", [None, 3])
def test_gqa_attention_matches_reference(window):
    q = RNG.normal(0, 1, (2, 9, 4, 8)).astype(np.float32)
    k = RNG.normal(0, 1, (2, 9, 2, 8)).astype(np.float32)
    v = RNG.normal(0, 1, (2, 9, 2, 8)).astype(np.float32)
    got = layers.gqa_attention(*map(torch.from_numpy, (q, k, v)), causal=True, sliding_window=window)
    want = ref_layers.gqa_attention(*map(jnp.asarray, (q, k, v)), causal=True, sliding_window=window)
    _close(got, want)


def test_swiglu_matches_reference():
    x, wg, wu, wd = (RNG.normal(0, 0.3, s).astype(np.float32) for s in ((4, 16), (16, 32), (16, 32), (32, 16)))
    _close(layers.swiglu(*map(torch.from_numpy, (x, wg, wu, wd))), ref_layers.swiglu(*map(jnp.asarray, (x, wg, wu, wd))))


def _pair(cfg, seed=0):
    ref_cfg = ref_transformer_config(cfg)
    ref_params = ref_tfm.init_params(ref_cfg, jax.random.key(seed))
    params = transformer_params_from_arrays(cfg, numpy_tree(ref_params))
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab, (2, 17)).astype(np.int32)
    return ref_cfg, ref_params, params, tokens


def test_tiny_forward_loss_and_gradient_match_reference_f32():
    cfg = PRESETS["tiny"]
    ref_cfg, ref_params, params, tokens = _pair(cfg)
    want_logits, _ = ref_tfm.forward(ref_cfg, ref_params, jnp.asarray(tokens[:, :-1]))
    got_logits, aux = tfm.forward(cfg, params, torch.from_numpy(tokens[:, :-1]))
    assert got_logits.dtype == torch.float32 and float(aux) == 0.0
    _close(got_logits, want_logits)

    (want_loss, _), want_grads = jax.value_and_grad(lambda p: ref_tfm.loss_fn(ref_cfg, p, jnp.asarray(tokens)), has_aux=True)(ref_params)
    (loss, info), grads = value_and_grad(lambda p, t: tfm.loss_fn(cfg, p, t), params, torch.from_numpy(tokens))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    assert float(info["xent"]) == float(loss)
    want_flat = np.asarray(ref_flatten(want_grads)[0])
    got_flat = flatten_grads(grads)[0].numpy()
    np.testing.assert_allclose(got_flat, want_flat, rtol=1e-3, atol=1e-5 * np.abs(want_flat).max())
    for p in jax.tree.leaves(params):  # the parameters themselves are not marked
        assert not p.requires_grad


def test_tiny_bf16_compute_matches_reference_loosely():
    import dataclasses

    cfg = dataclasses.replace(PRESETS["tiny"], compute_dtype=torch.bfloat16)
    ref_cfg, ref_params, params, tokens = _pair(cfg, seed=1)
    want_logits, _ = ref_tfm.forward(ref_cfg, ref_params, jnp.asarray(tokens[:, :-1]))
    got_logits, _ = tfm.forward(cfg, params, torch.from_numpy(tokens[:, :-1]))
    assert got_logits.dtype == torch.bfloat16
    want = np.asarray(want_logits, np.float32)
    _close(got_logits, want, rtol=0, atol=0.1 * np.abs(want).max())
    want_loss, _ = ref_tfm.loss_fn(ref_cfg, ref_params, jnp.asarray(tokens))
    loss, _ = tfm.loss_fn(cfg, params, torch.from_numpy(tokens))
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-2)


def test_module_holds_the_reference_tree():
    cfg = PRESETS["tiny"]
    model = tfm.Transformer(cfg, torch.Generator().manual_seed(0))
    tree = model.param_tree()
    ref_tree = jax.eval_shape(lambda: ref_tfm.init_params(ref_transformer_config(cfg), jax.random.key(0)))
    assert jax.tree.structure(jax.tree.map(lambda t: 0, tree)) == jax.tree.structure(jax.tree.map(lambda t: 0, ref_tree))
    for got, want in zip(jax.tree.leaves(tree), jax.tree.leaves(ref_tree)):
        assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    assert sum(p.numel() for p in model.parameters()) == sum(x.size for x in jax.tree.leaves(ref_tree))
    tokens = torch.randint(0, cfg.vocab, (2, 9), generator=torch.Generator().manual_seed(1))
    logits, _ = model(tokens[:, :-1])
    assert torch.equal(logits, tfm.forward(cfg, tree, tokens[:, :-1])[0])
    assert torch.equal(model.loss_fn(tokens)[0], tfm.loss_fn(cfg, tree, tokens)[0])
    # draws are reproducible from the generator
    again = tfm.Transformer(cfg, torch.Generator().manual_seed(0)).param_tree()
    assert torch.equal(again["layers"]["wq"], tree["layers"]["wq"])


def test_presets_param_counts_match_reference():
    for cfg in PRESETS.values():
        ref_cfg = ref_transformer_config(cfg)
        assert cfg.param_count() == ref_cfg.param_count()
    shapes = jax.eval_shape(lambda: ref_tfm.init_params(ref_transformer_config(PRESETS["100m"]), jax.random.key(0)))
    assert sum(x.size for x in jax.tree.leaves(shapes)) == 65_020_416


@pytest.mark.parametrize("field,value", [("act_pspec", object())])
def test_unported_fields_raise(field, value):
    """``act_pspec`` takes a Placement or None (the layer carry's layout);
    a foreign object raises."""
    import dataclasses

    with pytest.raises(TypeError):
        dataclasses.replace(PRESETS["tiny"], **{field: value})


def test_converter_refuses_wrong_shapes():
    cfg = PRESETS["tiny"]
    tree = numpy_tree(ref_tfm.init_params(ref_transformer_config(cfg), jax.random.key(0)))
    tree["layers"]["wq"] = tree["layers"]["wq"][:, :, :4]
    with pytest.raises(ValueError):
        transformer_params_from_arrays(cfg, tree)
