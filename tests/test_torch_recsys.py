"""Parity of the port's recsys side with the reference: ``data/recsys.py``
(bit-equal for the same ``np.random.default_rng`` seed, the generator left
in the same state), ``models/recsys/bert4rec.py`` and
``convert.py::bert4rec_params_from_arrays``.

In float32 compute (the SMOKE config) ``encode``, both Cloze losses, both
scorers and ``embedding_bag`` agree within ``rtol=1e-5, atol=1e-5``, the
gradients of ``cloze_loss_sampled`` and the parameters after AdamW within
``rtol=1e-4, atol=1e-6``.  In the bf16 default the hidden states agree
within two bf16 steps at the largest value, ``2**-6 × max|h|``, and their
mean error within ``2**-9 × max|h|``: bf16 GEMMs round their outputs where
XLA's and ATen's float32 accumulators meet them in another order; the losses
within ``rtol=1e-3``.  Two traps where torch's defaults differ from the
reference's are planted: a port with ``F.gelu``'s exact default, or with
``torch.var``'s unbiased default, fails its case.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import bert4rec as ref_configs
from repro.data import recsys as ref_data
from repro.models.recsys import bert4rec as ref_b4r
from repro.train import optimizer as ref_opt
from repro_torch.convert import bert4rec_params_from_arrays
from repro_torch.data import recsys as data
from repro_torch.models.recsys import bert4rec, embedding_bag
from repro_torch.train import optimizer as opt_mod
from repro_torch.tree import tree_leaves, tree_unflatten

from _torch_parity import assert_tree_close, numpy_tree

TOL = dict(rtol=1e-5, atol=1e-5)
STEP = dict(rtol=1e-4, atol=1e-6)
DTYPES = {jnp.dtype(jnp.float32): torch.float32, jnp.dtype(jnp.bfloat16): torch.bfloat16}


def _t(x):
    return torch.from_numpy(np.array(x))


def port_config(ref_cfg):
    kw = dataclasses.asdict(ref_cfg)
    kw["compute_dtype"] = DTYPES[jnp.dtype(ref_cfg.compute_dtype)]
    return bert4rec.Bert4RecConfig(**kw)


def _setup(compute_dtype=jnp.float32, seed=0, batch=6):
    """(ref cfg, port cfg, ref params, port params, items, rng): the
    reference's ``init_params`` carried across; ragged left-padded
    histories from ``interaction_sequences``."""
    ref_cfg = dataclasses.replace(ref_configs.SMOKE, compute_dtype=compute_dtype)
    ref_params = jax.jit(ref_b4r.init_params, static_argnums=0)(ref_cfg, jax.random.key(seed))
    cfg = port_config(ref_cfg)
    params = bert4rec_params_from_arrays(cfg, numpy_tree(ref_params))
    rng = np.random.default_rng(seed)
    items = ref_data.interaction_sequences(ref_cfg.n_items, batch, ref_cfg.seq_len, rng)
    assert (items == 0).any()  # PAD slots in the attention mask
    return ref_cfg, cfg, ref_params, params, items, rng


def _jit(fn):
    return jax.jit(fn, static_argnums=0)


# -- data ----------------------------------------------------------------------------


def test_item_popularity_is_bit_equal():
    for n, a in ((500, 1.05), (1_000_000, 1.05), (37, 0.8)):
        got, want = data.item_popularity(n, a), ref_data.item_popularity(n, a)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_items,batch,seq,max_masked", [(500, 16, 12, 1), (10_000, 64, 200, 50)])
def test_sequences_masks_and_stream_are_bit_equal(n_items, batch, seq, max_masked):
    """The whole data path of a training batch on one generator each:
    sequences, both Cloze forms (``max_masked`` small enough to overflow at
    the first size), the interaction stream; then the generators' state."""
    rng_p, rng_r = np.random.default_rng(11), np.random.default_rng(11)
    items = data.interaction_sequences(n_items, batch, seq, rng_p)
    want = ref_data.interaction_sequences(n_items, batch, seq, rng_r)
    assert items.dtype == want.dtype
    np.testing.assert_array_equal(items, want)
    mask_id = n_items + 1
    for got, ref in ((data.cloze_mask(items, mask_id, rng_p), ref_data.cloze_mask(want, mask_id, rng_r)),
                     (data.cloze_mask_positions(items, mask_id, max_masked, rng_p),
                      ref_data.cloze_mask_positions(want, mask_id, max_masked, rng_r))):
        for g, w in zip(got, ref, strict=True):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    users = rng_r.integers(0, 10**6, batch).astype(np.int64)
    assert rng_p.integers(0, 10**6, batch).tolist() == users.tolist()
    got, ref = data.interaction_stream(items, users), ref_data.interaction_stream(want, users)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(got[k], ref[k])
    assert rng_p.integers(0, 2**62) == rng_r.integers(0, 2**62)
    if max_masked == 1:  # the static budget cut some rows' masks
        full = ref_data.cloze_mask(want, mask_id, np.random.default_rng(0))[1]
        assert ((full != 0).sum(1) > 1).any()


# -- the config and the parameters ------------------------------------------------------


@pytest.mark.parametrize("which", ["FULL", "SMOKE"])
def test_config_properties_and_specs_equal_the_reference(which):
    ref_cfg = getattr(ref_configs, which)
    cfg = port_config(ref_cfg)
    assert (cfg.vocab, cfg.mask_id, cfg.max_masked, cfg.param_count()) == (
        ref_cfg.vocab, ref_cfg.mask_id, ref_cfg.max_masked, ref_cfg.param_count())
    assert bert4rec.param_specs(cfg) == ref_b4r.param_specs(ref_cfg)
    shapes = jax.eval_shape(lambda k: ref_b4r.init_params(ref_cfg, k), jax.random.key(0))
    assert jax.tree_util.tree_map(lambda x: x.shape, shapes) == bert4rec.param_shapes(cfg)
    if which == "SMOKE":
        port = bert4rec.init_params(cfg, torch.Generator().manual_seed(0))
        assert [tuple(x.shape) for x in tree_leaves(port)] == [x.shape for x in jax.tree_util.tree_leaves(shapes)]
        assert sum(x.numel() for x in tree_leaves(port)) == cfg.param_count() + cfg.vocab + 4 * cfg.n_blocks * 16
        assert torch.equal(port["blocks"]["ln1_w"], torch.ones(2, 16)) and not port["out_bias"].any()
        bad = numpy_tree(jax.tree_util.tree_map(lambda x: np.zeros(x.shape, np.float32), shapes))
        bad["blocks"]["w1"] = np.zeros((2, 16, 16), np.float32)
        with pytest.raises(ValueError, match="blocks.w1"):
            bert4rec_params_from_arrays(cfg, bad)


# -- float32 parity ---------------------------------------------------------------------


def test_encode_and_losses_match_reference():
    ref_cfg, cfg, ref_params, params, items, rng = _setup()
    want = _jit(ref_b4r.encode)(ref_cfg, ref_params, jnp.asarray(items))
    got = bert4rec.encode(cfg, params, _t(items))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    masked, targets = ref_data.cloze_mask(items, ref_cfg.mask_id, rng)
    loss, aux = bert4rec.cloze_loss(cfg, params, _t(masked), _t(targets))
    rloss, raux = _jit(ref_b4r.cloze_loss)(ref_cfg, ref_params, jnp.asarray(masked), jnp.asarray(targets))
    np.testing.assert_allclose(float(loss), float(rloss), **TOL)
    assert float(aux["n_masked"]) == float(raux["n_masked"])

    m_items, pos, tgt = ref_data.cloze_mask_positions(items, ref_cfg.mask_id, ref_cfg.max_masked, rng)
    negs = rng.integers(1, ref_cfg.n_items + 1, 40).astype(np.int32)
    loss, aux = bert4rec.cloze_loss_sampled(cfg, params, _t(m_items), _t(pos), _t(tgt), _t(negs))
    rloss, raux = _jit(ref_b4r.cloze_loss_sampled)(ref_cfg, ref_params, *map(jnp.asarray, (m_items, pos, tgt, negs)))
    np.testing.assert_allclose(float(loss), float(rloss), **TOL)
    assert float(aux["n_masked"]) == float(raux["n_masked"]) == float((tgt != 0).sum())


def test_scorers_match_reference():
    ref_cfg, cfg, ref_params, params, items, rng = _setup(seed=1)
    got = bert4rec.score_all_items(cfg, params, _t(items))
    want = _jit(ref_b4r.score_all_items)(ref_cfg, ref_params, jnp.asarray(items))
    assert tuple(got.shape) == (items.shape[0], cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    cands = rng.integers(1, ref_cfg.n_items + 1, (items.shape[0], 30)).astype(np.int32)
    scored = bert4rec.score_candidates(cfg, params, _t(items), _t(cands))
    np.testing.assert_allclose(
        scored.numpy(), np.asarray(_jit(ref_b4r.score_candidates)(ref_cfg, ref_params, jnp.asarray(items),
                                                                  jnp.asarray(cands))), **TOL)
    # The candidate scorer is the full scorer gathered at the candidates.
    np.testing.assert_allclose(scored.numpy(), np.take_along_axis(got.numpy(), cands, 1), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_embedding_bag_matches_reference(mode):
    rng = np.random.default_rng(4)
    table = rng.normal(0, 1, (50, 8)).astype(np.float32)
    bags = rng.integers(0, 50, (6, 5)).astype(np.int32)
    mask = rng.random((6, 5)) < 0.6
    mask[2] = False  # an empty bag: 0 in every mode
    got = embedding_bag(_t(table), _t(bags), _t(mask), mode)
    want = ref_b4r.embedding_bag(jnp.asarray(table), jnp.asarray(bags), jnp.asarray(mask), mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not got[2].any()
    with pytest.raises(ValueError):
        embedding_bag(_t(table), _t(bags), _t(mask), "median")


def test_sampled_loss_gradients_and_adamw_step_match_reference():
    ref_cfg, cfg, ref_params, params, items, rng = _setup(seed=2)
    m_items, pos, tgt = ref_data.cloze_mask_positions(items, ref_cfg.mask_id, ref_cfg.max_masked, rng)
    negs = rng.integers(1, ref_cfg.n_items + 1, 40).astype(np.int32)
    args = tuple(map(jnp.asarray, (m_items, pos, tgt, negs)))
    ocfg_kw = dict(lr=1e-3, warmup_steps=2, total_steps=20)
    ref_ocfg, ocfg = ref_opt.AdamWConfig(**ocfg_kw), opt_mod.AdamWConfig(**ocfg_kw)

    @jax.jit
    def ref_step(p):
        (loss, _), grads = jax.value_and_grad(
            lambda q: ref_b4r.cloze_loss_sampled(ref_cfg, q, *args), has_aux=True)(p)
        new, _, _ = ref_opt.apply_adamw(ref_ocfg, ref_opt.init_adamw(ref_ocfg, p), p, grads)
        return loss, grads, new

    ref_loss, ref_grads, ref_new = ref_step(ref_params)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = bert4rec.cloze_loss_sampled(cfg, params, *map(_t, (m_items, pos, tgt, negs)))
    grads = tree_unflatten(params, torch.autograd.grad(loss, leaves))
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=STEP["rtol"])
    assert_tree_close(grads, ref_grads, **STEP)
    new, _, _ = opt_mod.apply_adamw(ocfg, opt_mod.init_adamw(ocfg, params), params, grads)
    assert_tree_close(new, ref_new, **STEP)


# -- bf16 -----------------------------------------------------------------------------


def test_bf16_default_within_bf16_rounding():
    ref_cfg, cfg, ref_params, params, items, rng = _setup(jnp.bfloat16, seed=3, batch=8)
    assert cfg.compute_dtype == torch.bfloat16
    want = np.asarray(_jit(ref_b4r.encode)(ref_cfg, ref_params, jnp.asarray(items)).astype(jnp.float32))
    got = bert4rec.encode(cfg, params, _t(items))
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want)
    scale = float(np.abs(want).max())
    assert err.max() <= 2**-6 * scale and err.mean() <= 2**-9 * scale, (err.max(), err.mean(), scale)
    m_items, pos, tgt = ref_data.cloze_mask_positions(items, ref_cfg.mask_id, ref_cfg.max_masked, rng)
    negs = rng.integers(1, ref_cfg.n_items + 1, 40).astype(np.int32)
    loss, _ = bert4rec.cloze_loss_sampled(cfg, params, *map(_t, (m_items, pos, tgt, negs)))
    rloss, _ = _jit(ref_b4r.cloze_loss_sampled)(ref_cfg, ref_params, *map(jnp.asarray, (m_items, pos, tgt, negs)))
    np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-3)


# -- the planted traps ----------------------------------------------------------------


def _encode_error(monkeypatch, name, replacement):
    """Max |encode - reference| in float32, with ``bert4rec.<name>``
    replaced (or not, for ``replacement=None``)."""
    ref_cfg, cfg, ref_params, params, items, _ = _setup(seed=5)
    want = np.asarray(_jit(ref_b4r.encode)(ref_cfg, ref_params, jnp.asarray(items)))
    if replacement is not None:
        monkeypatch.setattr(bert4rec, name, replacement)
    return float(np.abs(bert4rec.encode(cfg, params, _t(items)).numpy() - want).max())


def test_gelu_is_the_tanh_approximation(monkeypatch):
    """``jax.nn.gelu`` defaults to ``approximate=True``; ``F.gelu`` to the
    exact erf form, which fails the float32 tolerance."""
    x = torch.linspace(-4, 4, 101)
    np.testing.assert_allclose(bert4rec.gelu(x).numpy(), np.asarray(jax.nn.gelu(jnp.asarray(x.numpy()))), **TOL)
    assert _encode_error(monkeypatch, "gelu", None) <= 1e-5
    assert _encode_error(monkeypatch, "gelu", F.gelu) > 1e-4


def test_layer_norm_uses_the_population_variance(monkeypatch):
    """``jnp.var`` is the population variance; ``torch.var``'s default
    (unbiased) fails the float32 tolerance."""
    def unbiased(x, w, b, eps=1e-6):
        return (x - x.mean(-1, keepdim=True)) * torch.rsqrt(torch.var(x, -1, keepdim=True) + eps) * w + b

    rng = np.random.default_rng(9)
    x, w, b = (rng.normal(0, s, shape).astype(np.float32) for s, shape in ((2, (5, 16)), (1, (16,)), (1, (16,))))
    np.testing.assert_allclose(bert4rec._layer_norm(_t(x), _t(w), _t(b)).numpy(),
                               np.asarray(ref_b4r._layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))), **TOL)
    assert _encode_error(monkeypatch, "_layer_norm", None) <= 1e-5
    assert _encode_error(monkeypatch, "_layer_norm", unbiased) > 1e-2
