"""Parity of the port's CountSketch with the JAX reference: the plain
version (and the wrapper, which takes it for CPU tensors) against
``repro.kernels.countsketch.ops.countsketch`` (the Pallas kernel in
interpret mode) and ``countsketch_ref``, and the port's
``train/compression.py::_sketch`` against the reference's; the plain
median decode against the reference's ``_unsketch``; the hash at the
coefficients whose sign multiplier ``b | 1`` equals p.

Integer-valued vectors (partial sums far below 2^24) must agree bit for
bit; Gaussian vectors within ``tests/test_kernels.py``'s tolerance
(rtol=1e-6, atol=1e-4), since the one-hot product of the Pallas kernel sums
in another order than a scatter."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.hashing import HashFamily as RefHashFamily
from repro.core.hashing import make_hash_family as ref_make_hash_family
from repro.kernels.countsketch.ops import countsketch as ref_countsketch
from repro.kernels.countsketch.ref import countsketch_ref as ref_countsketch_ref
from repro.train import compression as ref_comp
from repro_torch.core.hashing import MERSENNE_P, HashFamily, affine_hash_np
from repro_torch.kernels import build
from repro_torch.kernels.countsketch import ops
from repro_torch.kernels.countsketch.ref import countsketch_median_ref, countsketch_ref
from repro_torch.train import compression as comp

from _torch_parity import compressor_to_port

SHAPES = [(100, 64, 3), (5000, 256, 5), (3000, 300, 4)]


def _vec(n, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "integer":
        return rng.integers(-8, 9, n).astype(np.float32)
    return rng.normal(0, 1, n).astype(np.float32)


def _assert_same(got, want, kind):
    if kind == "integer":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("kind", ["integer", "gaussian"])
@pytest.mark.parametrize("n,w,d", SHAPES)
def test_countsketch_matches_reference_kernel(n, w, d, kind):
    fam = ref_make_hash_family(jax.random.key(2), d, w)
    vec = _vec(n, kind, n + d)
    idx = jnp.arange(n, dtype=jnp.uint32)
    want = np.asarray(ref_countsketch(jnp.asarray(vec), fam))  # Pallas, interpret mode
    oracle = np.asarray(
        ref_countsketch_ref(jnp.asarray(vec), fam(idx).astype(jnp.int32), fam.signs(idx), w)
    )
    pfam = HashFamily.from_host(np.asarray(fam.a), np.asarray(fam.b), w)
    h, s = ops.hash_indices(pfam, n)
    assert h.dtype == torch.int32 and s.dtype == torch.int8 and tuple(h.shape) == (d, n)
    np.testing.assert_array_equal(h.numpy(), np.asarray(fam(idx)))
    np.testing.assert_array_equal(s.numpy(), np.asarray(fam.signs(idx)))
    v = torch.from_numpy(vec)
    before = ops.countsketch.launches, ops.countsketch_median.launches
    for got in (
        countsketch_ref(v, h, s, w),
        ops.countsketch(v, h, s, w),
        ops.countsketch(v, h, s.to(torch.int32), w),
        ops.countsketch_family(v, pfam),
    ):
        assert tuple(got.shape) == (d, w) and got.dtype == torch.float32
        _assert_same(got.numpy(), want, kind)
        _assert_same(got.numpy(), oracle, kind)
    # ... and the decode of the reference kernel's table is the reference's.
    table = jnp.asarray(want)
    want_est = np.asarray(jnp.median(jnp.take_along_axis(table, fam(idx), axis=1) * fam.signs(idx), axis=0))
    np.testing.assert_array_equal(ops.countsketch_median(torch.tensor(want), pfam, n).numpy(), want_est)
    assert (ops.countsketch.launches, ops.countsketch_median.launches) == before  # CPU tensors launch nothing


def test_hash_indices_chunks_agree(monkeypatch):
    """Hashing in several chunks gives the buckets of one pass."""
    fam = HashFamily.from_host(np.array([12345, 777]), np.array([99, 2**31 - 2]), 300)
    h1, s1 = ops.hash_indices(fam, 1000)
    monkeypatch.setattr(ops, "HASH_CHUNK", 64)
    h2, s2 = ops.hash_indices(fam, 1000)
    assert torch.equal(h1, h2) and torch.equal(s1, s2)


def test_countsketch_wrapper_refuses_other_devices():
    vec = torch.zeros(8, device="meta")
    h = torch.zeros(2, 8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        ops.countsketch(vec, h, h.to(torch.int8), 16)
    fam = HashFamily.from_host(np.array([3, 5]), np.array([7, 9]), 16)
    with pytest.raises(ValueError):
        ops.countsketch_family(vec, fam)
    with pytest.raises(ValueError):
        ops.countsketch_median(torch.zeros(2, 16, device="meta"), fam, 8)


def test_countsketch_wrappers_refuse_bad_operands_on_cpu():
    """The checks run before the CPU path: dtypes, shapes, a float where an
    integer is expected."""
    fam = HashFamily.from_host(np.array([3, 5]), np.array([7, 9]), 16)
    vec = torch.zeros(10)
    h = torch.zeros(2, 10, dtype=torch.int32)
    s = torch.ones(2, 10, dtype=torch.int8)
    table = torch.zeros(2, 16)
    with pytest.raises(TypeError):
        ops.countsketch(vec, h, s, 16.0)
    with pytest.raises(ValueError):
        ops.countsketch(vec, h.float(), s, 16)
    with pytest.raises(ValueError):
        ops.countsketch_family(vec.double(), fam)
    with pytest.raises(ValueError):
        ops.countsketch_family(torch.zeros(2, 5), fam)
    with pytest.raises(TypeError):
        ops.countsketch_median(table, fam, 10.0)
    with pytest.raises(ValueError):
        ops.countsketch_median(table.double(), fam, 10)
    with pytest.raises(ValueError):
        ops.countsketch_median(torch.zeros(2, 15), fam, 10)
    with pytest.raises(ValueError):
        ops.countsketch_median(table, fam, -1)
    assert ops.countsketch_median(table, fam, 0).shape == (0,)


@pytest.mark.parametrize("d", [1, 4, 5])
def test_countsketch_median_ref_matches_reference_unsketch(d):
    """The plain decode (hash, gather, sign, median) against the reference's
    ``_unsketch`` bit for bit, on an integer table with NaN, +inf and -inf
    planted in a few cells."""
    n, w = 2001, 300
    st = ref_comp.init_compressor(ref_comp.CompressorConfig(depth=d, width=w), n, jax.random.key(d))
    rng = np.random.default_rng(d)
    table = rng.integers(-50, 51, (d, w)).astype(np.float32)
    for value, count in ((np.nan, 2), (np.inf, 2), (-np.inf, 2)):
        table.reshape(-1)[rng.choice(d * w, count, replace=False)] = value
    want = np.asarray(ref_comp._unsketch(st, jnp.asarray(table), n))
    port = compressor_to_port(st)
    t = torch.from_numpy(table)
    for got in (countsketch_median_ref(t, port.hash, n), comp._unsketch(port, t, n),
                comp._unsketch(port, t, n, ops.hash_indices(port.hash, n))):
        assert got.shape == (n,) and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    assert np.isnan(want).any()


@pytest.mark.parametrize("w", [4, 16])
def test_countsketch_median_ref_matches_reference_unsketch_on_shared_cells(w):
    """d = 5 on a table so narrow that about n / w coordinates share each
    cell, with values in [-2, 2] (ties everywhere: the midpoint of equal
    middle values) and, at w = 16, NaN, +inf and -inf in one cell each: the
    plain decode against the reference's ``_unsketch`` bit for bit."""
    d, n = 5, 4001
    st = ref_comp.init_compressor(ref_comp.CompressorConfig(depth=d, width=w), n, jax.random.key(w))
    rng = np.random.default_rng(w)
    table = rng.integers(-2, 3, (d, w)).astype(np.float32)
    if w == 16:
        table.reshape(-1)[rng.choice(d * w, 3, replace=False)] = (np.nan, np.inf, -np.inf)
    want = np.asarray(ref_comp._unsketch(st, jnp.asarray(table), n))
    port = compressor_to_port(st)
    for got in (countsketch_median_ref(torch.from_numpy(table), port.hash, n),
                ops.countsketch_median(torch.from_numpy(table), port.hash, n)):
        np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want[np.isfinite(want)])) > 1


@pytest.mark.parametrize("a,b", [(12345, 2**31 - 2), (MERSENNE_P - 1, 99), (MERSENNE_P - 1, 2**31 - 2)])
def test_hash_at_extreme_coefficients_matches_numpy_and_reference(a, b):
    """b = 2^31 - 2 makes the sign multiplier b | 1 equal p itself (every
    sign hash is then a mod p); a = p - 1 is the largest multiplier."""
    n, w = 5000, 300
    keys = np.arange(n, dtype=np.uint32)
    fam = HashFamily.from_host(np.array([a, 7]), np.array([b, 3]), w)
    h, s = ops.hash_indices(fam, n)
    a_, b_ = fam.a_host.astype(np.uint64), fam.b_host.astype(np.uint64)
    for i in range(2):
        np.testing.assert_array_equal(h[i].numpy(), affine_hash_np(keys, a_[i], b_[i], w))
        parity = affine_hash_np(keys, b_[i] | np.uint64(1), a_[i], 2)
        np.testing.assert_array_equal(s[i].numpy(), 1 - 2 * parity)
    ref = RefHashFamily(jnp.asarray(fam.a_host), jnp.asarray(fam.b_host), w)
    np.testing.assert_array_equal(h.numpy(), np.asarray(ref(jnp.asarray(keys))))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ref.signs(jnp.asarray(keys))))


@pytest.mark.parametrize("kind", ["integer", "gaussian"])
def test_sketch_matches_reference_compression_module(kind):
    ccfg = ref_comp.CompressorConfig(depth=4, width=256)
    st = ref_comp.init_compressor(ccfg, 1000, jax.random.key(3))
    vec = _vec(1000, kind, 11)
    want = np.asarray(ref_comp._sketch(st, jnp.asarray(vec)))
    port = compressor_to_port(st)
    got = comp._sketch(port, torch.from_numpy(vec))
    _assert_same(got.numpy(), want, kind)
    # ... and the port's own ops entry point equals its _sketch
    np.testing.assert_array_equal(ops.countsketch_family(torch.from_numpy(vec), port.hash).numpy(), got.numpy())


def test_build_lists_every_cuda_source():
    """``kernels/build.py::SOURCES`` (what ``chip_smoke.py`` builds) names
    every CUDA source of the port, countsketch included."""
    assert "countsketch" in build.SOURCES
    assert sorted(build.SOURCES) == sorted(p.stem for p in build.CSRC_DIR.glob("*.cu"))
