"""Parity of the port's gradient compressor (``train/compression.py``) with
the JAX reference's on the same numpy inputs and the same converted state:
``roundtrip`` at depth 4 (even: the median averages the two middle values)
and depth 5 (odd), with sketch momentum off and on, over three consecutive
round trips, also with a NaN in the gradient; the median and the top-k
threshold on non-finite values; and the flat-gradient order against
``jax.tree.flatten``.

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
from repro_torch.kernels.countsketch.ref import median_ref
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
    assert median_ref(vals).tolist() == [2.5, 1.0]
    assert median_ref(vals[:3]).tolist() == [2.0, 0.0]
    np.testing.assert_array_equal(median_ref(vals).numpy(), np.asarray(jnp.median(jnp.asarray(vals.numpy()), axis=0)))


NAN, INF = np.nan, np.inf
# Columns of five values: NaN among finite values, NaN beside infinities,
# an inf/-inf pair in the middle, signed zeros, infinities of one sign,
# NaN first and last, all NaN, and values past half the float32 range
# (their midpoint sum overflows as jnp.median's does).
NON_FINITE_COLUMNS = np.array([
    [1, NAN, INF, -0.0, INF, NAN, 3, NAN, 3e38, -INF],
    [3, 2, -INF, 0.0, 5, 1, 1, NAN, 3e38, INF],
    [5, 3, 1, -0.0, NAN, 2, 2, NAN, 2e38, -INF],
    [7, 8, 2, 0.0, 1, 3, INF, NAN, -1, INF],
    [0, 9, 3, -0.0, 2, 4, NAN, NAN, 3e38, 0],
], np.float32)


@pytest.mark.parametrize("depth", [4, 5])
def test_median_matches_jnp_median_on_non_finite_columns(depth):
    """NaN wherever a column holds a NaN; infinities, their midpoint and
    signed zeros as ``jnp.median`` gives them (``-0.0 == 0.0``)."""
    vals = NON_FINITE_COLUMNS[:depth]
    want = np.asarray(jnp.median(jnp.asarray(vals), axis=0))
    got = median_ref(torch.from_numpy(vals)).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isnan(want).sum() >= 4


@pytest.mark.parametrize("n_nan", ["none", "one", "k-1", "k", "k+1"])
def test_threshold_matches_jnp_sort_with_nans(n_nan):
    """``jnp.sort(|est|)[-k]`` counts NaN as the largest value: finite while
    fewer than k are NaN, NaN from k on; ``mag >= thresh`` never selects a
    NaN and keeps the reference's selection."""
    k, n = 16, 200
    rng = np.random.default_rng(len(n_nan))
    mag = np.abs(rng.integers(-30, 31, n)).astype(np.float32)
    mag[rng.choice(n, 3, replace=False)] = INF
    count = {"none": 0, "one": 1, "k-1": k - 1, "k": k, "k+1": k + 1}[n_nan]
    mag[rng.choice(n, count, replace=False)] = NAN
    want = np.asarray(jnp.sort(jnp.asarray(mag))[-k])
    got = comp._threshold(torch.from_numpy(mag), k)
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.isnan(want) == (count >= k)
    np.testing.assert_array_equal((torch.from_numpy(mag) >= got).numpy(), mag >= want)


@pytest.mark.parametrize("depth", [4, 5])
def test_roundtrip_with_nan_gradient_matches_reference(depth):
    """A NaN in the gradient: the reference's update, error and momentum,
    NaN positions included, over three round trips.  At depth 5 the first
    round trip selects 8 coordinates (the median rule once made it 0)."""
    ccfg = ref_comp.CompressorConfig(depth=depth, width=256, top_k=64, momentum=0.9)
    ref = ref_comp.init_compressor(ccfg, N, jax.random.key(5))
    port = compressor_to_port(ref)
    rng = np.random.default_rng(0)
    for step in range(3):
        g = rng.integers(-20, 21, N).astype(np.float32)
        g[7] = np.nan
        want_up, ref = ref_comp.roundtrip(ref, jnp.asarray(g))
        got_up, port = comp.roundtrip(port, torch.from_numpy(g))
        want_up = np.asarray(want_up)
        if depth == 5 and step == 0:
            assert (want_up != 0).sum() == 8
        for got, want in ((got_up, want_up), (port.error, ref.error), (port.momentum, ref.momentum)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert np.isnan(np.asarray(ref.momentum)).any()


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
