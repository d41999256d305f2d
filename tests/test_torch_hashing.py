"""Parity of the port's hashing and label codec with the JAX reference.

Inputs are made from a seed with numpy and handed to both sides as numpy;
buckets, signs, mixed keys and label keys must be equal exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.api import codec as ref_codec
from repro.core import hashing as H
from repro_torch.api import codec
from repro_torch.core import hashing as T
from repro_torch.device import resolve_device

U32 = st.integers(min_value=0, max_value=2**32 - 1)


def _t(x):
    return T.keys_to_tensor(x)


@settings(max_examples=100, deadline=None)
@given(
    a=st.integers(1, H.MERSENNE_P - 1),
    b=st.integers(0, H.MERSENNE_P - 1),
    x=U32,
    w=st.integers(2, 2**20),
)
def test_affine_hash_matches_bigint_and_reference(a, b, x, w):
    got = int(T.affine_hash(_t([x]), _t([a]), _t([b]), w)[0])
    assert got == ((a * (x % H.MERSENNE_P) + b) % H.MERSENNE_P) % w
    assert got == int(H.affine_hash(jnp.uint32(x), jnp.uint32(a), jnp.uint32(b), w))
    assert int(T.mulmod31(_t([a]), _t([x % H.MERSENNE_P]))[0]) == (a * (x % H.MERSENNE_P)) % H.MERSENNE_P


@pytest.mark.parametrize("w", [2, 777, 12345, 2**20])
def test_affine_hash_batch_matches_reference_and_numpy(w):
    rng = np.random.default_rng(w)
    a = rng.integers(1, H.MERSENNE_P, 4096, dtype=np.uint32)
    b = rng.integers(0, H.MERSENNE_P, 4096, dtype=np.uint32)
    x = rng.integers(0, 2**32, 4096, dtype=np.uint32)
    x[:4] = [0, H.MERSENNE_P, 2**32 - 1, H.MERSENNE_P - 1]  # reduction edges
    got = T.affine_hash(_t(x), _t(a), _t(b), w).numpy()
    np.testing.assert_array_equal(got, T.affine_hash_np(x, a, b, w))
    np.testing.assert_array_equal(got, H.affine_hash_np(x, a, b, w))
    np.testing.assert_array_equal(
        got, np.asarray(H.affine_hash(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b), w))
    )


@pytest.mark.parametrize("depth,width", [(1, 64), (5, 777), (5, 8192)])
def test_family_buckets_and_signs_match_reference(depth, width):
    fam_ref = H.make_hash_family(jax.random.key(depth), depth, width)
    a, b = np.asarray(fam_ref.a), np.asarray(fam_ref.b)
    fam = T.HashFamily.from_host(a, b, width)
    keys = np.random.default_rng(1).integers(0, 2**32, 3000, dtype=np.uint32)
    np.testing.assert_array_equal(fam(_t(keys)).numpy(), np.asarray(fam_ref(jnp.asarray(keys))))
    np.testing.assert_array_equal(
        fam.signs(_t(keys)).numpy(), np.asarray(fam_ref.signs(jnp.asarray(keys)))
    )
    # 2-D keys broadcast like the reference's.
    k2 = keys[:3000].reshape(30, 100)
    np.testing.assert_array_equal(fam(_t(k2)).numpy(), np.asarray(fam_ref(jnp.asarray(k2))))


def test_mix_keys_matches_reference():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 2**32, 5000, dtype=np.uint32)
    y = rng.integers(0, 2**32, 5000, dtype=np.uint32)
    x[:2], y[:2] = 2**32 - 1, [0, 2**32 - 1]
    np.testing.assert_array_equal(
        T.mix_keys(_t(x), _t(y)).numpy(),
        np.asarray(H.mix_keys(jnp.asarray(x), jnp.asarray(y))).astype(np.int64),
    )


def test_make_hash_family_ranges_and_generator():
    fam = T.make_hash_family(torch.Generator().manual_seed(7), 5, 777)
    again = T.make_hash_family(torch.Generator().manual_seed(7), 5, 777)
    assert fam.same_values(again)
    assert fam.a_host.dtype == np.uint32 and fam.a.dtype == torch.int64
    assert np.all((fam.a_host >= 1) & (fam.a_host < H.MERSENNE_P))
    assert np.all(fam.b_host < H.MERSENNE_P)
    np.testing.assert_array_equal(fam.a.numpy(), fam.a_host.astype(np.int64))
    hs = fam(_t(np.arange(1000, dtype=np.uint32)))
    assert hs.shape == (5, 1000) and int(hs.min()) >= 0 and int(hs.max()) < 777


LABELS = [
    ["192.168.29.1", "10.0.0.7", "a", "", "ünïcødé", "x" * 40],
    [0, 1, 7, 2**32 + 7, -1],
    ["1", 1, "b", 2],                 # mixed: per-element path
    ["nul\x00byte", "ok"],            # NUL: per-element path
]


@pytest.mark.parametrize("labels", LABELS)
def test_fnv1a_labels_and_codec_match_reference(labels):
    np.testing.assert_array_equal(T.fnv1a_labels(labels), H.fnv1a_labels(labels))
    np.testing.assert_array_equal(codec.encode_labels(labels), ref_codec.encode_labels(labels))
    for lab in labels:
        assert T.fnv1a_label(lab) == H.fnv1a_label(lab)
        assert codec.encode_label(lab) == ref_codec.encode_label(lab)


def test_fnv1a_labels_dtypes_match_reference():
    for arr in (
        np.arange(10, dtype=np.uint32),
        np.arange(10, dtype=np.uint64) + 2**33,
        np.array([True, False]),
        np.array(["a", "bc"]).reshape(2, 1),
    ):
        got = T.fnv1a_labels(arr)
        np.testing.assert_array_equal(got, H.fnv1a_labels(arr))
        assert got.shape == arr.shape and got.dtype == np.uint32


def test_resolve_device_defaults_to_cuda_and_never_falls_back():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
        with pytest.raises(RuntimeError):
            resolve_device("cuda")
