"""Parity of the port's gradient compressor (``train/compression.py``) with
the JAX reference's on the same numpy inputs and the same converted state:
``roundtrip`` at depth 4 (even: the median averages the two middle values)
and depth 5 (odd), with sketch momentum off and on, over three consecutive
round trips; and the flat-gradient order against ``jax.tree.flatten``.

Integer-valued gradients (every table sum far below 2^24) give bit-equal
updates, error and momentum.  Float gradients are compared with rtol=1e-6,
atol=1e-6 (the median and the top-k are exact selections; only the sums
of the sketch round) and must select the same coordinates."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as ref_tfm
from repro.train import compression as ref_comp
from repro_torch.convert import transformer_params_from_arrays
from repro_torch.launch.train_lm import PRESETS
from repro_torch.train import compression as comp

from _torch_parity import compressor_to_port, numpy_tree, ref_transformer_config

N = 3000


def _grads(kind, rng):
    if kind == "integer":
        return rng.integers(-20, 21, N).astype(np.float32)
    return rng.normal(0, 1, N).astype(np.float32)


@pytest.mark.parametrize("kind", ["integer", "float"])
@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("depth", [4, 5])
def test_roundtrip_matches_reference(depth, momentum, kind):
    ccfg = ref_comp.CompressorConfig(depth=depth, width=256, top_k=64, momentum=momentum)
    ref = ref_comp.init_compressor(ccfg, N, jax.random.key(depth))
    port = compressor_to_port(ref)
    rng = np.random.default_rng(depth * 10 + int(momentum * 10))
    for _ in range(3):
        g = _grads(kind, rng)
        want_up, ref = ref_comp.roundtrip(ref, jnp.asarray(g))
        got_up, port = comp.roundtrip(port, torch.from_numpy(g))
        want_up = np.asarray(want_up)
        np.testing.assert_array_equal(got_up.numpy() != 0, want_up != 0)
        assert (want_up != 0).sum() >= 64
        for got, want in ((got_up, want_up), (port.error, ref.error), (port.momentum, ref.momentum)):
            if kind == "integer":
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            else:
                np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_median_of_even_depth_averages_the_middle_pair():
    vals = torch.tensor([[1.0, 5.0], [2.0, -1.0], [3.0, 0.0], [10.0, 2.0]])
    assert comp._median(vals).tolist() == [2.5, 1.0]
    assert comp._median(vals[:3]).tolist() == [2.0, 0.0]
    np.testing.assert_array_equal(comp._median(vals).numpy(), np.asarray(jnp.median(jnp.asarray(vals.numpy()), axis=0)))


def test_top_k_keeps_every_tie():
    """jnp.sort(|est|)[-k] with ">=": coordinates tied at the threshold all
    pass, so more than k may be selected."""
    ccfg = ref_comp.CompressorConfig(depth=5, width=4096, top_k=2, momentum=0.0)
    ref = ref_comp.init_compressor(ccfg, 8, jax.random.key(0))
    g = np.array([3, -3, 3, 1, 0, 0, 2, 0], np.float32)
    want, _ = ref_comp.roundtrip(ref, jnp.asarray(g))
    got, _ = comp.roundtrip(compressor_to_port(ref), torch.from_numpy(g))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got != 0).sum() == 3


def test_flatten_order_matches_jax_tree_flatten():
    cfg = PRESETS["tiny"]
    ref_params = ref_tfm.init_params(ref_transformer_config(cfg), jax.random.key(0))
    want, _ = ref_comp.flatten_grads(ref_params)
    params = transformer_params_from_arrays(cfg, numpy_tree(ref_params))
    flat, spec = comp.flatten_grads(params)
    assert flat.dtype == torch.float32 and flat.shape[0] == 1_016_448
    np.testing.assert_array_equal(flat.numpy(), np.asarray(want))
    back = comp.unflatten_grads(flat, spec)
    assert list(back) == list(params) and list(back["layers"]) == list(params["layers"])
    for name, leaf in back["layers"].items():
        assert torch.equal(leaf, params["layers"][name]) and leaf.dtype == params["layers"][name].dtype
