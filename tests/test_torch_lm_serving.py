"""Parity of the port's LM serving path (``models/layers.py``:
``gqa_attention`` with ``q_offset``/``kv_valid_len``, ``decode_attention``,
``chunked_attention``; ``models/transformer.py``: ``cache_capacity``,
``init_cache``, ``prefill``, ``decode_step``) with the JAX reference, at the
reference's Mixtral SMOKE widths (float32 compute, window 8, 4 experts top-2),
on the same numpy parameters and tokens.

Tolerances, float32:
- attention against the reference's: atol 1e-5, rtol 1e-5 (float32 sums of
  at most 70 keys in another order);
- chunked attention against dense masked attention (the reference's
  ``gqa_attention``): atol 1e-5 at every length, window-sliced or not;
- prefill and decode logits against the reference's: atol 2e-5 (rtol 1e-4;
  the ~1e-6 differences of two layers' matmuls, measured 1.5e-6 to 3.5e-6);
  the cache's k and v atol 1e-5 and its ``len`` exactly;
- the port's decode against its own full ``forward`` at the same positions,
  at a capacity no token can drop from (E / k): atol 2e-5.
The routing sees the same logits to ~1e-6 on both sides: these inputs put
every token's top-k margin far above that (the MoE tests count them).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import mixtral_8x22b
from repro.models import layers as ref_layers
from repro.models import transformer as ref_tfm
from repro_torch.convert import transformer_params_from_arrays
from repro_torch.models import layers, transformer as tfm

from _torch_parity import port_transformer_config, transformer_numpy_params

SMOKE = mixtral_8x22b.SMOKE
_STATIC = ("causal", "sliding_window", "q_chunk", "window_slicing")
ref_gqa = jax.jit(ref_layers.gqa_attention, static_argnames=("causal", "sliding_window"))
ref_chunked = jax.jit(ref_layers.chunked_attention, static_argnames=_STATIC)


def _qkv(b, sq, skv, hq=4, hkv=2, dh=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (b, sq, hq, dh)).astype(np.float32), rng.normal(0, 1, (b, skv, hkv, dh)).astype(np.float32),
            rng.normal(0, 1, (b, skv, hkv, dh)).astype(np.float32))


def _close(got, want, atol=1e-5, rtol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("valid", [None, "scalar", "batch"])
def test_gqa_attention_offset_and_valid_len_match_reference(valid):
    q, k, v = _qkv(3, 5, 12, seed=1)
    kw_ref = {"q_offset": jnp.asarray(7, jnp.int32)}
    kw = {"q_offset": torch.tensor(7, dtype=torch.int32)}
    if valid == "scalar":
        kw_ref["kv_valid_len"], kw["kv_valid_len"] = jnp.asarray(9, jnp.int32), torch.tensor(9, dtype=torch.int32)
    elif valid == "batch":
        lens = np.array([12, 4, 1], np.int32)
        kw_ref["kv_valid_len"], kw["kv_valid_len"] = jnp.asarray(lens), torch.from_numpy(lens)
    for window in (None, 3):
        want = ref_gqa(*map(jnp.asarray, (q, k, v)), causal=True, sliding_window=window, **kw_ref)
        got = layers.gqa_attention(*map(torch.from_numpy, (q, k, v)), causal=True, sliding_window=window, **kw)
        _close(got, want)


@pytest.mark.parametrize("lens", [[16, 16], [3, 16], [1, 9]])
def test_decode_attention_matches_reference(lens):
    q, k, v = _qkv(2, 1, 16, seed=2)
    n = np.array(lens, np.int32)
    want = jax.jit(ref_layers.decode_attention)(*map(jnp.asarray, (q, k, v)), jnp.asarray(n))
    got = layers.decode_attention(*map(torch.from_numpy, (q, k, v)), torch.from_numpy(n))
    _close(got, want)
    if lens[0] == lens[1]:  # a 0-d length, as the ring cache passes it
        got0 = layers.decode_attention(*map(torch.from_numpy, (q, k, v)), torch.tensor(lens[0], dtype=torch.int32))
        _close(got0, want)


@pytest.mark.parametrize("s", [64, 70, 9])
@pytest.mark.parametrize("window,slicing", [(None, False), (8, False), (8, True)], ids=["full", "masked", "sliced"])
def test_chunked_attention_equals_dense_at_every_length(s, window, slicing):
    q, k, v = _qkv(2, s, s, seed=s)
    dense = np.asarray(ref_gqa(*map(jnp.asarray, (q, k, v)), causal=True, sliding_window=window))
    got = layers.chunked_attention(*map(torch.from_numpy, (q, k, v)), causal=True, sliding_window=window, q_chunk=16,
                                   window_slicing=slicing)
    assert got.shape == q.shape
    _close(got, dense)
    if s % 16 == 0:  # where the reference's chunking is right at every setting, the port equals it too
        ref = np.asarray(ref_chunked(*map(jnp.asarray, (q, k, v)), causal=True, sliding_window=window, q_chunk=16,
                                     window_slicing=slicing))
        _close(got, ref)


@pytest.mark.parametrize("s", [60, 70])
def test_reference_window_slicing_is_wrong_at_ragged_lengths_and_the_port_is_not(s):
    """The reference clamps the last chunk's K/V slice start while labelling
    its keys from the unclamped one (``src/repro/models/layers.py:169-171``),
    so at a length that is not a multiple of ``q_chunk`` its sliced
    attention differs from dense attention by O(1); the port's does not."""
    q, k, v = _qkv(2, s, s, seed=s + 1)
    dense = np.asarray(ref_gqa(*map(jnp.asarray, (q, k, v)), causal=True, sliding_window=8))
    ref = np.asarray(ref_chunked(*map(jnp.asarray, (q, k, v)), causal=True, sliding_window=8, q_chunk=16,
                                 window_slicing=True))
    got = layers.chunked_attention(*map(torch.from_numpy, (q, k, v)), causal=True, sliding_window=8, q_chunk=16,
                                   window_slicing=True)
    assert np.abs(ref - dense).max() > 0.5
    _close(got, dense)


def test_chunked_attention_gradient_equals_dense():
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv(1, 40, 40, seed=3))
    out = layers.chunked_attention(q, k, v, causal=True, sliding_window=8, q_chunk=16, window_slicing=True)
    grads = torch.autograd.grad((out * out).sum(), (q, k, v))
    dense = layers.gqa_attention(q, k, v, causal=True, sliding_window=8)
    want = torch.autograd.grad((dense * dense).sum(), (q, k, v))
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


CASES = {
    # prompt, max_seq, config changes: the ring wrapped at prefill (chunked,
    # sliced), not yet wrapped (the cache padded to the window, wrapping while
    # decoding), no window (the cache padded to max_seq), and an empty cache
    "wrapped": (24, 32, dict(attn_q_chunk=8, attn_window_slicing=True)),
    "unwrapped": (5, 24, {}),
    "padded": (10, 24, dict(sliding_window=None)),
    "empty": (0, 12, {}),
}


def _models(changes, capacity_factor=None, seed=0):
    ref_cfg = dataclasses.replace(SMOKE, **changes)
    if capacity_factor is not None:
        ref_cfg = dataclasses.replace(ref_cfg, moe=dataclasses.replace(ref_cfg.moe, capacity_factor=capacity_factor))
    cfg = port_transformer_config(ref_cfg)
    tree = transformer_numpy_params(cfg, seed)
    return ref_cfg, cfg, jax.tree.map(jnp.asarray, tree), transformer_params_from_arrays(cfg, tree)


def _same_cache(got, want):
    assert got["k"].shape == want["k"].shape and got["k"].dtype == torch.float32
    _close(got["k"], want["k"])
    _close(got["v"], want["v"])
    assert got["len"].dtype == torch.int32 and got["len"].dim() == 0 and int(got["len"]) == int(want["len"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_and_decode_match_reference(case):
    prompt, max_seq, changes = CASES[case]
    ref_cfg, cfg, ref_params, params = _models(changes)
    tokens = np.random.default_rng(12).integers(0, cfg.vocab, (2, prompt + 8)).astype(np.int32)
    assert tfm.cache_capacity(cfg, max_seq) == ref_tfm.cache_capacity(ref_cfg, max_seq)
    if prompt:
        want_logits, want_cache = jax.jit(lambda p, t: ref_tfm.prefill(ref_cfg, p, t, max_seq=max_seq))(
            ref_params, jnp.asarray(tokens[:, :prompt]))
        logits, cache = tfm.prefill(cfg, params, torch.from_numpy(tokens[:, :prompt]), max_seq=max_seq)
        assert logits.shape == (2, cfg.vocab) and logits.dtype == torch.float32
        _close(logits, want_logits, atol=2e-5, rtol=1e-4)
    else:
        want_cache = ref_tfm.init_cache(ref_cfg, 2, max_seq)
        cache = tfm.init_cache(cfg, 2, max_seq)
    _same_cache(cache, want_cache)
    step = jax.jit(lambda p, t, c: ref_tfm.decode_step(ref_cfg, p, t, c))
    for j in range(prompt, prompt + 8):
        want_logits, want_cache = step(ref_params, jnp.asarray(tokens[:, j]), want_cache)
        k_before = cache["k"]
        logits, cache = tfm.decode_step(cfg, params, torch.from_numpy(tokens[:, j]), cache)
        assert cache["k"] is k_before  # written in place
        _close(logits, want_logits, atol=2e-5, rtol=1e-4)
        _same_cache(cache, want_cache)


@pytest.mark.parametrize("case", ["wrapped", "padded"])
def test_decode_agrees_with_forward(case):
    """Prefill then decode gives the logits one ``forward`` over the whole
    sequence gives at the same positions, at a capacity no token drops from
    (a decode step routes B tokens, ``forward`` B·S: at the config's 1.25
    they may drop different ones)."""
    prompt, max_seq, changes = CASES[case]
    _, cfg, _, params = _models(changes, capacity_factor=SMOKE.moe.n_experts / SMOKE.moe.top_k)
    tokens = torch.from_numpy(np.random.default_rng(13).integers(0, cfg.vocab, (2, prompt + 8)).astype(np.int64))
    with torch.no_grad():
        full, _ = tfm.forward(cfg, params, tokens)
        logits, cache = tfm.prefill(cfg, params, tokens[:, :prompt], max_seq=max_seq)
        torch.testing.assert_close(logits, full[:, prompt - 1], rtol=1e-4, atol=2e-5)
        for j in range(prompt, prompt + 8):
            logits, cache = tfm.decode_step(cfg, params, tokens[:, j], cache)
            torch.testing.assert_close(logits, full[:, j], rtol=1e-4, atol=2e-5)
    assert int(cache["len"]) == prompt + 8


def test_sliced_prefill_equals_unchunked_at_a_ragged_prompt():
    """The model-level check of the clamp: a 21-token prompt, chunks of 8,
    window slicing on, against the unchunked reference."""
    ref_cfg, _, ref_params, params = _models({})
    cfg = port_transformer_config(ref_cfg, attn_q_chunk=8, attn_window_slicing=True)
    tokens = np.random.default_rng(14).integers(0, cfg.vocab, (2, 21)).astype(np.int32)
    want_logits, want_cache = jax.jit(lambda p, t: ref_tfm.prefill(ref_cfg, p, t))(ref_params, jnp.asarray(tokens))
    logits, cache = tfm.prefill(cfg, params, torch.from_numpy(tokens))
    _close(logits, want_logits, atol=2e-5, rtol=1e-4)
    _same_cache(cache, want_cache)


def test_sharded_configs_refuse_to_serve():
    class FakeMesh:
        shape = {"data": 1, "model": 2}

        def index(self, axes):
            return 0

        def size(self, axes):
            return 2

    cfg = port_transformer_config(SMOKE, attn_halo_mesh=FakeMesh())
    with pytest.raises(ValueError, match="one rank"):
        tfm.prefill(cfg, {}, torch.zeros((1, 4), dtype=torch.int64))
