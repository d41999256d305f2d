"""Parity of the ingest kernel's key entry (``kernels/ingest/ops.py::
ingest_keys``, which hashes the keys itself) with the JAX reference: its
plain version against ``ingest_pallas`` (interpret mode) fed the buckets of
``repro.core.hashing.HashFamily``, on the keys at the edges of the hash's
arithmetic (0, p - 1, p, 2p, 2^32 - 1), weight-0 padding and negative
integer weights, non-square widths with distinct row and column families,
row-offset shards and mirrored edges; ``update_preaggregated_`` against the
reference's ``update``; the wrapper's refusals.  Exact: integer weights."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.hashing import HashFamily as RefFamily
from repro.core.sketch import GLavaSketch as RefSketch, SketchConfig as RefConfig
from repro.kernels.ingest.kernel import ingest_pallas
from repro_torch.core.hashing import MERSENNE_P as P, HashFamily, keys_to_tensor
from repro_torch.core.ingest import IngestEngine, pad_bucket, preaggregate_host
from repro_torch.kernels.ingest.ops import ingest_keys
from repro_torch.kernels.ingest.ref import ingest_keys_ref

from _torch_parity import assert_same_sketch, to_port

# ``repro.core`` re-exports the function ``ingest``, which shadows the module.
ref_ingest = importlib.import_module("repro.core.ingest")

# Keys at the edges of h(x) = ((a (x mod p) mod p) + b) mod p mod w.
EDGE_KEYS = np.array([0, 1, P - 1, P, P + 1, 2 * P, 2 * P + 1, 2**32 - 2, 2**32 - 1], np.uint32)


def _families(rng, d, wr, wc, distinct=True):
    """The same (row, column) families for the reference and the port; one
    shared family when not ``distinct`` (a square sketch)."""
    out = []
    for w in ((wr, wc) if distinct else (wr,)):
        a = rng.integers(1, P, d).astype(np.uint32)
        b = rng.integers(0, P, d).astype(np.uint32)
        out.append((RefFamily(jnp.asarray(a), jnp.asarray(b), w), HashFamily.from_host(a, b, w)))
    return out if distinct else out * 2


def _batch(rng, b, pad=0, negative=False):
    """(B,) uint32 keys over the whole uint32 range with the edge keys
    planted, integer weights (negative ones too), ``pad`` trailing slots of
    key 0 and weight 0, as ``pad_bucket`` pads."""
    src = rng.integers(0, 2**32, b, dtype=np.uint64).astype(np.uint32)
    dst = rng.integers(0, 2**32, b, dtype=np.uint64).astype(np.uint32)
    src[: EDGE_KEYS.size] = EDGE_KEYS
    dst[EDGE_KEYS.size: 2 * EDGE_KEYS.size] = EDGE_KEYS
    dst[: EDGE_KEYS.size] = EDGE_KEYS[::-1]
    w = rng.integers(-4 if negative else 1, 9, b).astype(np.float32)
    if pad:
        src[-pad:], dst[-pad:], w[-pad:] = 0, 0, 0.0
    return src, dst, w


def _pallas(counters, row, col, src, dst, w, mirror):
    """The reference: its families' buckets into ``ingest_pallas``
    (interpret mode), and the mirrored edges by a second call."""
    out = ingest_pallas(jnp.asarray(counters), row(jnp.asarray(src)), col(jnp.asarray(dst)), jnp.asarray(w),
                        interpret=True)
    if mirror:
        out = ingest_pallas(out, row(jnp.asarray(dst)), col(jnp.asarray(src)), jnp.asarray(w), interpret=True)
    return np.asarray(out)


def _port(counters, row, col, src, dst, w, mirror, row_offset=0):
    c = torch.from_numpy(counters.copy())
    got = ingest_keys(c, keys_to_tensor(src), keys_to_tensor(dst), torch.from_numpy(w), row, col,
                      row_offset=row_offset, mirror=mirror)
    assert got.data_ptr() == c.data_ptr()  # in place
    return got.numpy()


# (name, d, wr, wc, distinct families, padding slots, negative weights)
CASES = [
    ("edge_keys", 3, 256, 256, False, 0, False),
    ("padding_and_negative_weights", 2, 256, 256, False, 100, True),
    ("nonsquare_distinct_families", 3, 512, 256, True, 37, True),
    ("one_sketch", 1, 256, 512, True, 0, False),
]


@pytest.mark.parametrize("mirror", [False, True], ids=["directed", "mirrored"])
@pytest.mark.parametrize("name,d,wr,wc,distinct,pad,negative", CASES, ids=[c[0] for c in CASES])
def test_plain_version_bit_equals_ingest_pallas_on_reference_buckets(name, d, wr, wc, distinct, pad, negative,
                                                                     mirror):
    rng = np.random.default_rng(d * wr + pad)
    (rrow, prow), (rcol, pcol) = _families(rng, d, wr, wc, distinct)
    counters = rng.integers(0, 1000, (d, wr, wc)).astype(np.float32)
    src, dst, w = _batch(rng, 512, pad, negative)
    want = _pallas(counters, rrow, rcol, src, dst, w, mirror)
    np.testing.assert_array_equal(_port(counters, prow, pcol, src, dst, w, mirror), want)


def test_edge_keys_hash_as_the_reference():
    """The port's families on the edge keys give the reference's buckets
    (the plain version hashes with them), at a power-of-two width and not."""
    rng = np.random.default_rng(3)
    for w in (256, 1000, 8191):
        (ref, port), _ = _families(rng, 4, w, w)
        np.testing.assert_array_equal(port(keys_to_tensor(EDGE_KEYS)).numpy(), np.asarray(ref(jnp.asarray(EDGE_KEYS))))


@pytest.mark.parametrize("mirror", [False, True], ids=["directed", "mirrored"])
@pytest.mark.parametrize("wr,wc,shards", [(512, 256, 4), (768, 256, 3)])
def test_row_offset_shards_match_reference_and_sum_to_whole(wr, wc, shards, mirror):
    """Each shard of rows [k wr/n, (k+1) wr/n) against the reference engine's
    Pallas backend with the same ``row_offset``; the shards stacked equal the
    whole sketch."""
    rng = np.random.default_rng(wr + shards)
    (rrow, prow), (rcol, pcol) = _families(rng, 2, wr, wc)
    src, dst, w = _batch(rng, 700, 20, True)
    whole = _port(np.zeros((2, wr, wc), np.float32), prow, pcol, src, dst, w, mirror)
    per = wr // shards
    passes = [(src, dst), (dst, src)][: 2 if mirror else 1]
    parts = []
    for k in range(shards):
        shard = _port(np.zeros((2, per, wc), np.float32), prow, pcol, src, dst, w, mirror, row_offset=k * per)
        want = jnp.zeros((2, per, wc), jnp.float32)
        for s, t in passes:
            want = ref_ingest.ingest(want, rrow(jnp.asarray(s)), rcol(jnp.asarray(t)), jnp.asarray(w),
                                     backend="pallas", row_offset=k * per)
        np.testing.assert_array_equal(shard, np.asarray(want))
        parts.append(shard)
    np.testing.assert_array_equal(np.concatenate(parts, axis=1), whole)


@pytest.mark.parametrize("backend", ["scatter", "cuda", "auto"])
def test_mirrored_equals_two_calls(backend):
    rng = np.random.default_rng(8)
    (_, prow), (_, pcol) = _families(rng, 3, 96, 40)
    src, dst, w = (torch.from_numpy(x) if x.dtype == np.float32 else keys_to_tensor(x)
                   for x in _batch(rng, 300, 10, True))
    engine = IngestEngine(backend)
    once = engine.keys(torch.zeros(3, 96, 40), src, dst, w, prow, pcol, mirror=True)
    twice = engine.keys(torch.zeros(3, 96, 40), src, dst, w, prow, pcol)
    ingest_keys_ref(twice, dst, src, w, prow, pcol)
    assert torch.equal(once, twice)


CONFIGS = [
    RefConfig(depth=3, width_rows=64, width_cols=64),
    RefConfig(depth=2, width_rows=96, width_cols=40),
    RefConfig(depth=3, width_rows=64, width_cols=64, directed=False),
    RefConfig(depth=2, width_rows=40, width_cols=96, directed=False),
]


@pytest.mark.parametrize("backend", ["auto", "cuda"])
@pytest.mark.parametrize("cfg", CONFIGS, ids=["square", "nonsquare", "undirected", "undirected-nonsquare"])
def test_update_preaggregated_matches_reference_update(cfg, backend):
    """A raw batch through the reference's ``update``; the same batch
    collapsed on the host, padded as a session pads it, through the port's
    ``update_preaggregated_``: counters and both registers bit-equal."""
    rng = np.random.default_rng(cfg.width_rows + cfg.directed)
    ref = RefSketch.empty(cfg, jax.random.key(cfg.width_cols))
    port = to_port(ref)
    for _ in range(2):
        src = rng.zipf(1.3, 3000).astype(np.uint32) % 500
        dst = rng.zipf(1.3, 3000).astype(np.uint32) % 500
        w = rng.integers(-2, 7, 3000).astype(np.float32)
        ref = ref.update(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w), backend="scatter", preagg="off")
        pre = preaggregate_host(src, dst, w)
        port.update_preaggregated_(
            *(keys_to_tensor(pad_bucket(getattr(pre, f))) for f in ("src", "dst")),
            torch.from_numpy(pad_bucket(pre.weights)),
            keys_to_tensor(pad_bucket(pre.src_unique)), torch.from_numpy(pad_bucket(pre.src_totals)),
            keys_to_tensor(pad_bucket(pre.dst_unique)), torch.from_numpy(pad_bucket(pre.dst_totals)),
            backend=backend,
        )
        assert_same_sketch(port, ref)


def _operands(rng):
    (_, prow), (_, pcol) = _families(rng, 2, 32, 16)
    src, dst, w = _batch(rng, 40)
    return torch.zeros(2, 32, 16), keys_to_tensor(src), keys_to_tensor(dst), torch.from_numpy(w), prow, pcol


@pytest.mark.parametrize("dtype", [torch.int32, torch.uint8, torch.int16, torch.float32, torch.float64],
                         ids=lambda t: str(t)[6:])
@pytest.mark.parametrize("which", ["src", "dst", "both"])
def test_wrapper_refuses_other_key_dtypes(dtype, which):
    counters, src, dst, w, row, col = _operands(np.random.default_rng(1))
    if which in ("src", "both"):
        src = src.to(dtype)
    if which in ("dst", "both"):
        dst = dst.to(dtype)
    with pytest.raises(ValueError, match="int64 keys"):
        ingest_keys(counters, src, dst, w, row, col)
    assert not counters.any()  # refused before any write


@pytest.mark.parametrize("dtype", [torch.float64, torch.float16, torch.bfloat16, torch.int32, torch.int64],
                         ids=lambda t: str(t)[6:])
def test_wrapper_refuses_other_weight_dtypes(dtype):
    counters, src, dst, w, row, col = _operands(np.random.default_rng(2))
    with pytest.raises(ValueError, match="weights"):
        ingest_keys(counters, src, dst, w.to(dtype), row, col)
    assert not counters.any()


def test_wrapper_refuses_bad_shapes_families_and_devices():
    counters, src, dst, w, row, col = _operands(np.random.default_rng(3))
    bad = {
        "keys": (counters, src[:-1], dst, w, row, col),
        "weights": (counters, src, dst, w[:-1], row, col),
        "2-d keys": (counters, src[None], dst[None], w, row, col),
        "counters": (counters.double(), src, dst, w, row, col),
        "transposed counters": (counters.transpose(1, 2), src, dst, w, row, col),
        "depth": (torch.zeros(3, 32, 16), src, dst, w, row, col),
        "column width": (counters, src, dst, w, row, row),
        "device": (torch.zeros(2, 32, 16, device="meta"), src, dst, w, row, col),
    }
    for name, args in bad.items():
        with pytest.raises(ValueError):
            ingest_keys(*args)
        assert not counters.any(), name
