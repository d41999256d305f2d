"""Parity of the port's ingest plane with the JAX reference: the ingest
kernel's plain version against ``ingest_pallas`` (interpret mode), the
IngestEngine backends and row-shard masking against ``repro.core.ingest``,
and the host pre-aggregation helpers.  Exact for integer weights; float
weights to ``rtol=1e-6, atol=1e-5`` (as ``tests/test_kernels.py``)."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ingest.kernel import ingest_pallas
from repro_torch.core import ingest as T
from repro_torch.kernels.ingest.ops import ingest_scatter
from repro_torch.kernels.ingest.ref import ingest_scatter_ref

# ``repro.core`` re-exports the function ``ingest``, which shadows the module.
ref_ingest = importlib.import_module("repro.core.ingest")


def _batch(rng, d, wr, wc, b, inert_frac=0.1):
    counters = rng.integers(0, 1000, (d, wr, wc)).astype(np.float32)
    rows = rng.integers(0, wr, (d, b)).astype(np.int32)
    rows[rng.random((d, b)) < inert_frac] = -1
    cols = rng.integers(0, wc, (d, b)).astype(np.int32)
    w = rng.integers(1, 9, b).astype(np.float32)
    return counters, rows, cols, w


def test_plain_version_bit_equals_ingest_pallas_interpret():
    counters, rows, cols, w = _batch(np.random.default_rng(0), 2, 256, 256, 512)
    want = np.asarray(
        ingest_pallas(
            jnp.asarray(counters), jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(w),
            interpret=True,
        )
    )
    got = ingest_scatter_ref(
        torch.from_numpy(counters.copy()), torch.from_numpy(rows),
        torch.from_numpy(cols), torch.from_numpy(w),
    )
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("backend", ["scatter", "cuda", "auto"])
@pytest.mark.parametrize("d,wr,wc,b", [(1, 64, 64, 33), (3, 300, 200, 1000)])
def test_engine_backends_match_reference_scatter(backend, d, wr, wc, b):
    counters, rows, cols, w = _batch(np.random.default_rng(d * b), d, wr, wc, b, 0.0)
    want = ref_ingest.ingest(
        jnp.asarray(counters), jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(w),
        backend="scatter",
    )
    c = torch.from_numpy(counters.copy())
    out = T.IngestEngine(backend)(c, torch.from_numpy(rows), torch.from_numpy(cols), torch.from_numpy(w))
    assert out.data_ptr() == c.data_ptr()  # in place: no copy of the counters
    np.testing.assert_array_equal(c.numpy(), np.asarray(want))


def test_float_weights_close_to_reference():
    rng = np.random.default_rng(5)
    rows = rng.integers(0, 128, (2, 700)).astype(np.int32)
    cols = rng.integers(0, 128, (2, 700)).astype(np.int32)
    w = rng.normal(0, 1, 700).astype(np.float32)
    want = ref_ingest.ingest(
        jnp.zeros((2, 128, 128), jnp.float32), jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(w)
    )
    got = ingest_scatter(
        torch.zeros(2, 128, 128), torch.from_numpy(rows), torch.from_numpy(cols), torch.from_numpy(w)
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("wr,wc,shards", [(256, 256, 4), (512, 128, 2)])
def test_row_offset_masking_matches_reference_and_sums_to_whole(wr, wc, shards):
    rng = np.random.default_rng(wr + shards)
    _, rows, cols, w = _batch(rng, 3, wr, wc, 900, 0.0)
    whole = torch.zeros(3, wr, wc)
    T.ingest(whole, torch.from_numpy(rows), torch.from_numpy(cols), torch.from_numpy(w))
    per = wr // shards
    parts = []
    for k in range(shards):
        shard = torch.zeros(3, per, wc)
        T.ingest(shard, torch.from_numpy(rows), torch.from_numpy(cols), torch.from_numpy(w),
                 row_offset=k * per)
        want = ref_ingest.ingest(
            jnp.zeros((3, per, wc), jnp.float32), jnp.asarray(rows), jnp.asarray(cols),
            jnp.asarray(w), row_offset=k * per,
        )
        np.testing.assert_array_equal(shard.numpy(), np.asarray(want))
        parts.append(shard)
    np.testing.assert_array_equal(torch.cat(parts, dim=1).numpy(), whole.numpy())


def test_resolve_backend_by_device_and_names():
    assert T.resolve_backend("auto", torch.device("cpu")) == "scatter"
    assert T.resolve_backend(None, torch.device("cuda")) == "cuda"
    assert T.resolve_backend("scatter", torch.device("cuda")) == "scatter"
    with pytest.raises(ValueError):
        T.resolve_backend("onehot", torch.device("cpu"))
    with pytest.raises(ValueError):
        T.IngestEngine("pallas")


def test_kernel_wrapper_validates_cuda_operands_only():
    # CPU tensors take the plain version; other devices are refused.
    with pytest.raises(ValueError):
        ingest_scatter(torch.zeros(1, 4, 4, device="meta"), torch.zeros(1, 2, dtype=torch.int32),
                       torch.zeros(1, 2, dtype=torch.int32), torch.ones(2))


@pytest.mark.parametrize("seed", [0, 1])
def test_preaggregate_host_matches_reference(seed):
    rng = np.random.default_rng(seed)
    src = rng.zipf(1.5, 3000).astype(np.uint32) % 200
    dst = rng.zipf(1.5, 3000).astype(np.uint32) % 200
    w = rng.integers(-3, 6, 3000).astype(np.float32)
    got, want = T.preaggregate_host(src, dst, w), ref_ingest.preaggregate_host(src, dst, w)
    for field in ("src", "dst", "weights", "src_unique", "src_totals", "dst_unique", "dst_totals"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    assert got.n_pairs == want.n_pairs
    empty = T.preaggregate_host(np.zeros(0, np.uint32), np.zeros(0, np.uint32), np.zeros(0, np.float32))
    assert empty.n_pairs == 0


def test_host_helpers_match_reference():
    for n in (0, 1, 255, 256, 257, 5000):
        assert T.bucket_size(n) == ref_ingest.bucket_size(n)
        x = np.arange(n, dtype=np.uint32)
        np.testing.assert_array_equal(T.pad_bucket(x), ref_ingest.pad_bucket(x))
    rng = np.random.default_rng(2)
    src, dst = rng.integers(0, 50, 300).astype(np.uint32), rng.integers(0, 50, 300).astype(np.uint32)
    for dd, cap in ((None, None), (dst, None), (dst, 10)):
        got, want = T.touched_row_keys(src, dd, cap), ref_ingest.touched_row_keys(src, dd, cap)
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(got, want)
    for mode, b in (("auto", 10), ("auto", 5000), (None, None), ("on", 1), ("off", 10**6)):
        assert T.resolve_preagg(mode, b) == ref_ingest.resolve_preagg(mode, b)
    with pytest.raises(ValueError):
        T.resolve_preagg("sometimes")


# Bucket dtypes the ingest kernels refuse, as (rows, cols) pairs: floats,
# narrow integers, and rows and columns of different dtypes.
BAD_INDEX_DTYPES = [
    (torch.float32, torch.float32), (torch.float64, torch.float64), (torch.int16, torch.int16),
    (torch.uint8, torch.uint8), (torch.int32, torch.int64), (torch.int64, torch.int32),
]


@pytest.mark.parametrize("rows_dtype,cols_dtype", BAD_INDEX_DTYPES, ids=lambda t: str(t)[6:])
def test_wrapper_refuses_other_index_dtypes_on_the_cpu(rows_dtype, cols_dtype):
    counters, rows, cols, w = _batch(np.random.default_rng(1), 2, 16, 16, 8, 0.0)
    c = torch.from_numpy(counters.copy())
    with pytest.raises(ValueError, match="int32 or both int64"):
        ingest_scatter(c, torch.from_numpy(rows).to(rows_dtype), torch.from_numpy(cols).to(cols_dtype),
                       torch.from_numpy(w))
    np.testing.assert_array_equal(c.numpy(), counters)  # refused before any write


def test_wrapper_refuses_non_float32_weights_and_counters():
    counters, rows, cols, w = _batch(np.random.default_rng(2), 2, 16, 16, 8, 0.0)
    r, c = torch.from_numpy(rows), torch.from_numpy(cols)
    with pytest.raises(ValueError, match="weights"):
        ingest_scatter(torch.from_numpy(counters), r, c, torch.from_numpy(w).double())
    with pytest.raises(ValueError, match="weights"):
        ingest_scatter(torch.from_numpy(counters), r, c, torch.from_numpy(w[:-1]))
    with pytest.raises(ValueError, match="counters"):
        ingest_scatter(torch.from_numpy(counters).double(), r, c, torch.from_numpy(w))
    with pytest.raises(ValueError, match="counters"):
        ingest_scatter(torch.from_numpy(counters).transpose(1, 2), r, c, torch.from_numpy(w))


@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64], ids=["int32", "int64"])
@pytest.mark.parametrize("offset", [0, 128])
def test_wrapper_takes_int32_and_int64_buckets_as_ingest_pallas(index_dtype, offset):
    """The wrapper on the CPU, on either bucket dtype, against the Pallas
    kernel in interpret mode behind the reference engine's row-shard masking
    (rows past the shard are inert)."""
    counters, rows, cols, w = _batch(np.random.default_rng(7), 2, 256, 256, 512)
    rows[rows >= 0] = rows[rows >= 0] * 3 // 2  # rows of the next shard too
    want = ref_ingest.ingest(jnp.asarray(counters), jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(w),
                             backend="pallas", row_offset=offset)
    c = torch.from_numpy(counters.copy())
    got = ingest_scatter(c, torch.from_numpy(rows).to(index_dtype), torch.from_numpy(cols).to(index_dtype),
                         torch.from_numpy(w), row_offset=offset)
    assert got.data_ptr() == c.data_ptr()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
