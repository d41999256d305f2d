"""Parity of the port's sketch plane beyond GLavaSketch's batched ingest with
the JAX reference: the four baselines (CountMin, node CountMin, CountSketch,
gSketch) carried across with ``convert.py``, the order-dependent sequential
and conservative updates (``kernels/sequential``: on the CPU its plain
version), and the device-side ``preaggregate_edges``.  The same numpy
stream goes to both sides.  Bit-equal in the counting regime; float weights
bit-equal for the counters of the sequential updates (every add happens in
stream order on both sides) and ``rtol=1e-6, atol=1e-5`` for registers."""
import collections
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.hashing import mix_keys as ref_mix_keys
from repro.core.ingest import preaggregate_edges as ref_preaggregate_edges
from repro.core.sketch import (
    CountMin as RefCountMin,
    CountSketch as RefCountSketch,
    GLavaSketch as RefSketch,
    GSketch as RefGSketch,
    NodeCountMin as RefNodeCountMin,
    SketchConfig as RefConfig,
)
from repro_torch.core.hashing import keys_to_tensor, mix_keys
from repro_torch.core.queries import edge_query
from repro_torch.core.ingest import preaggregate_edges
from repro_torch.core.sketch import CountMin, CountSketch, GLavaSketch, GSketch, NodeCountMin
from repro_torch.kernels.sequential import ops as seq_ops
from repro_torch.kernels.sequential.ref import sequential_update_ref

from _torch_parity import (
    assert_same_sketch,
    assert_same_value,
    countmin_to_port,
    countsketch_to_port,
    gsketch_to_port,
    keys_pair,
    node_countmin_to_port,
    to_port,
)


def _stream(seed, n, n_nodes=200, max_w=5, float_w=False):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, n).astype(np.uint32)
    dst = rng.integers(0, n_nodes, n).astype(np.uint32)
    w = rng.normal(2, 1, n) if float_w else rng.integers(1, max_w + 1, n)
    return src, dst, w.astype(np.float32)


def _both(src, dst, w):
    (js, ts), (jd, td) = keys_pair(src, dst)
    return (js, jd, jnp.asarray(w)), (ts, td, torch.from_numpy(np.array(w, copy=True)))


def _exact(src, dst, w):
    cnt = collections.Counter()
    for s, d, x in zip(src, dst, w):
        cnt[(int(s), int(d))] += float(x)
    return np.array([cnt[(int(s), int(d))] for s, d in zip(src, dst)])


# -- baselines -------------------------------------------------------------------


@pytest.mark.parametrize("d,w", [(4, 512), (3, 97)])
def test_countmin_update_and_edge_query_match_reference(d, w):
    src, dst, wt = _stream(8, 500, n_nodes=80)
    (js, jd, jw), (ts, td, tw) = _both(src, dst, wt)
    ref = RefCountMin.empty(d, w, jax.random.key(d))
    port = countmin_to_port(ref)
    ref, new = ref.update(js, jd, jw), port.update(ts, td, tw)
    assert_same_value(new.counters, ref.counters)
    assert not port.counters.any()  # update is functional
    est = new.edge_query(ts[:64], td[:64])
    assert_same_value(est, ref.edge_query(js[:64], jd[:64]))
    assert (est.numpy() >= _exact(src, dst, wt)[:64]).all()
    assert_same_value(new.merge(new).counters, ref.merge(ref).counters)
    assert_same_value(countmin_to_port(ref).update_(ts, td).counters, ref.update(js, jd).counters)


def test_node_countmin_flows_match_reference_and_counters_are_not_aliased():
    src, dst, wt = _stream(9, 400, n_nodes=50)
    (js, jd, jw), (ts, td, tw) = _both(src, dst, wt)
    ref = RefNodeCountMin.empty(4, 256, jax.random.key(0))
    port = node_countmin_to_port(ref)
    empty = NodeCountMin.empty(4, 256, 0)
    assert empty.counters_out.data_ptr() != empty.counters_in.data_ptr()
    assert port.counters_out.data_ptr() != port.counters_in.data_ptr()
    ref, new = ref.update(js, jd, jw), port.update_(ts, td, tw)
    assert new is port
    assert_same_value(new.counters_out, ref.counters_out)
    assert_same_value(new.counters_in, ref.counters_in)
    assert not torch.equal(new.counters_out, new.counters_in)
    (jk, tk), = keys_pair(np.arange(50))
    assert_same_value(new.out_flow(tk), ref.out_flow(jk))
    assert_same_value(new.in_flow(tk), ref.in_flow(jk))
    exact_out = np.bincount(src, weights=wt, minlength=50)
    assert (new.out_flow(tk).numpy() >= exact_out - 1e-5).all()
    empty.update_(ts, td, tw)
    assert torch.equal(empty.counters_out.sum(), empty.counters_in.sum())
    assert not torch.equal(empty.counters_out, empty.counters_in)


@pytest.mark.parametrize("d", [4, 5])
def test_countsketch_update_and_median_query_match_reference(d):
    """d=4 takes jnp.median's midpoint of the two middle values."""
    src, dst, wt = _stream(10, 1000, n_nodes=60)
    keys = np.asarray(ref_mix_keys(jnp.asarray(src), jnp.asarray(dst)))
    (jk, tk), = keys_pair(keys)
    assert torch.equal(tk, mix_keys(keys_to_tensor(src), keys_to_tensor(dst)))
    ref = RefCountSketch.empty(d, 64, jax.random.key(d))
    port = countsketch_to_port(ref)
    ref, port = ref.update(jk, jnp.asarray(wt)), port.update(tk, torch.from_numpy(wt))
    assert_same_value(port.counters, ref.counters)
    est = port.query(tk[:200])
    assert_same_value(est, ref.query(jk[:200]))
    if d == 4:
        srt = np.sort(np.asarray(torch.gather(port.counters, 1, port.hash(tk[:200]))
                                 * port.hash.signs(tk[:200])), axis=0)
        assert (srt[1] != srt[2]).any()  # the midpoint is exercised
        assert not np.array_equal(est.numpy(), srt[1])
    err = est.numpy() - _exact(src, dst, wt)[:200]
    assert (err > 0).any() and (err < 0).any()  # errors of both signs
    assert_same_value(port.merge(port).counters, ref.merge(ref).counters)


def test_gsketch_widths_update_and_query_match_reference():
    src, dst, wt = _stream(11, 600, n_nodes=100)
    (js, jd, jw), (ts, td, tw) = _both(src, dst, wt)
    sample = src[:100]
    ref = RefGSketch.from_sample(4, 1024, 4, sample, jax.random.key(0))
    port = gsketch_to_port(ref)
    widths = GSketch.allocate_widths(port.part_hash, sample, 4, 1024)
    assert widths.dtype == np.int64
    np.testing.assert_array_equal(widths, np.asarray(ref.widths))
    assert_same_value(port.widths, ref.widths)
    ref, new = ref.update(js, jd, jw), port.update(ts, td, tw)
    assert_same_value(new.partitions.counters, ref.partitions.counters)
    assert not port.partitions.counters.any()
    est = new.edge_query(ts[:64], td[:64])
    assert_same_value(est, ref.edge_query(js[:64], jd[:64]))
    assert (est.numpy() >= _exact(src, dst, wt)[:64]).all()


@pytest.mark.parametrize("k,total", [(4, 1024), (8, 5000), (3, 40)])
def test_gsketch_from_sample_allocates_as_the_reference(k, total):
    rng = np.random.default_rng(k)
    sample = (rng.zipf(1.3, 500) % 1000).astype(np.uint32)
    gs = GSketch.from_sample(3, total, k, sample, torch.Generator().manual_seed(k))
    part_of = gs.part_hash(keys_to_tensor(sample)).numpy()[0]
    mass = np.bincount(part_of, minlength=k).astype(np.float64) + 1.0
    want = np.maximum(8, (total * mass / mass.sum()).astype(np.int64))
    np.testing.assert_array_equal(gs.widths.numpy(), want)
    assert gs.partitions.counters.shape == (k, 3, want.max()) and gs.partitions.hash.w == want.max()
    assert gs.part_hash.depth == 1 and gs.part_hash.w == k


# -- the order-dependent updates --------------------------------------------------

CONFIGS = [
    RefConfig(depth=3, width_rows=32, width_cols=32),
    RefConfig(depth=2, width_rows=24, width_cols=40),
    RefConfig(depth=3, width_rows=32, width_cols=32, directed=False),
]
IDS = ["square", "nonsquare", "undirected"]


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
@pytest.mark.parametrize("float_w", [False, True], ids=["int", "float"])
def test_update_sequential_matches_reference(cfg, float_w):
    src, dst, wt = _stream(3, 300, n_nodes=60, float_w=float_w)
    (js, jd, jw), (ts, td, tw) = _both(src, dst, wt)
    ref0 = RefSketch.empty(cfg, jax.random.key(1)).update(js, jd, jw)
    port0 = to_port(ref0)
    ref = ref0.update_sequential(js, jd, jw)
    port = port0.update_sequential(ts, td, tw)
    assert_same_sketch(port, ref, exact=not float_w)
    if cfg.directed:  # the mirrored half goes through the batched ingest
        assert_same_value(port.counters, ref.counters)
    assert_same_sketch(port0, ref0)  # functional: the input is left as it was
    assert port0.update_sequential_(ts, td, tw) is port0
    assert torch.equal(port0.counters, port.counters)


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
@pytest.mark.parametrize("float_w", [False, True], ids=["int", "float"])
def test_update_conservative_matches_reference(cfg, float_w):
    src, dst, wt = _stream(7, 400, n_nodes=100, float_w=float_w)
    (js, jd, jw), (ts, td, tw) = _both(src, dst, wt)
    ref = RefSketch.empty(cfg, jax.random.key(2)).update_conservative(js, jd, jw)
    port = to_port(RefSketch.empty(cfg, jax.random.key(2))).update_conservative(ts, td, tw)
    assert_same_value(port.counters, ref.counters)
    assert_same_sketch(port, ref, exact=not float_w)
    if not cfg.directed:  # undirected edges are not mirrored, as in the reference
        directed = dataclasses.replace(cfg, directed=True)
        one_way = to_port(RefSketch.empty(directed, jax.random.key(2))).update_conservative(ts, td, tw)
        assert torch.equal(port.counters, one_way.counters)


def test_update_conservative_split_equals_whole_and_is_dominated_by_vanilla():
    cfg = RefConfig(depth=3, width_rows=32, width_cols=32)
    rng = np.random.default_rng(7)
    src = rng.integers(0, 10, 400).astype(np.uint32)
    dst = rng.integers(0, 10, 400).astype(np.uint32)
    wt = rng.integers(1, 9, 400).astype(np.float32)
    _, (ts, td, tw) = _both(src, dst, wt)
    empty = to_port(RefSketch.empty(cfg, jax.random.key(2)))
    assert "preagg" not in inspect.signature(GLavaSketch.update_conservative).parameters
    whole = empty.update_conservative(ts, td, tw)
    split = empty.update_conservative(ts[:200], td[:200], tw[:200]).update_conservative_(ts[200:], td[200:], tw[200:])
    assert_same_sketch(split, whole)
    vanilla = empty.update(ts, td, tw)
    est_c, est_v = edge_query(whole, ts, td).numpy(), edge_query(vanilla, ts, td).numpy()
    assert (est_c >= _exact(src, dst, wt)).all() and (est_c <= est_v).all()
    assert (whole.counters <= vanilla.counters).all() and (whole.counters < vanilla.counters).any()


@pytest.mark.parametrize("conservative", [False, True])
@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64], ids=["int32", "int64"])
def test_sequential_wrapper_takes_int32_and_int64_buckets_on_the_cpu(conservative, index_dtype):
    rng = np.random.default_rng(4)
    counters = torch.from_numpy(rng.integers(0, 5, (5, 16, 8)).astype(np.float32))
    rows = torch.from_numpy(rng.integers(0, 16, (5, 200))).to(index_dtype)
    cols = torch.from_numpy(rng.integers(0, 8, (5, 200))).to(index_dtype)
    w = torch.from_numpy(rng.normal(1, 2, 200).astype(np.float32))
    got = seq_ops.sequential_update(counters.clone(), rows, cols, w, conservative)
    want = counters.clone().numpy()
    for e in range(200):  # numpy, edge by edge
        cells = (np.arange(5), rows[:, e].numpy(), cols[:, e].numpy())
        cur = want[cells]
        want[cells] = np.maximum(cur, cur.min() + w[e].numpy()) if conservative else cur + w[e].numpy()
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, sequential_update_ref(counters.clone(), rows.long(), cols.long(), w, conservative))


def test_sequential_wrapper_refuses_bad_operands_on_the_cpu():
    counters = torch.zeros(3, 8, 8)
    rows = torch.zeros(3, 10, dtype=torch.int64)
    w = torch.ones(10)
    before = seq_ops.sequential_update.launches
    for bad_rows, bad_cols, match in (
        (rows.float(), rows.float(), "int32 or both int64"),
        (rows, rows.int(), "int32 or both int64"),
        (rows.short(), rows.short(), "int32 or both int64"),
        (rows[:2], rows[:2], "rows/cols must be"),
    ):
        with pytest.raises(ValueError, match=match):
            seq_ops.sequential_update(counters, bad_rows, bad_cols, w, False)
    with pytest.raises(ValueError, match="weights"):
        seq_ops.sequential_update(counters, rows, rows, w.double(), True)
    with pytest.raises(ValueError, match="at most 32"):
        seq_ops.sequential_update(torch.zeros(33, 8, 8), torch.zeros(33, 10, dtype=torch.int64),
                                  torch.zeros(33, 10, dtype=torch.int64), w, True)
    with pytest.raises(ValueError, match="buckets must lie"):
        seq_ops.sequential_update(counters, rows - 1, rows, w, False)
    assert seq_ops.sequential_update.launches == before  # CPU tensors launch nothing


# -- preaggregate_edges ------------------------------------------------------------


def _ref_preagg(src, dst, w, out_size):
    return jax.jit(lambda s, d, x: ref_preaggregate_edges(s, d, x, out_size))(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w)
    )


def _assert_same_preagg(src, dst, w, out_size):
    want = _ref_preagg(src, dst, w, out_size)
    got = preaggregate_edges(keys_to_tensor(src), keys_to_tensor(dst), torch.from_numpy(w), out_size)
    for g, x in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x).astype(np.int64))
    assert_same_value(got[2], want[2])
    assert got[3].dtype == torch.int32 and int(got[3]) == int(want[3])
    return got


@pytest.mark.parametrize("out_size", [256, 32], ids=["fits", "overflows"])
def test_preaggregate_edges_matches_reference(out_size):
    rng = np.random.default_rng(1)
    src = rng.integers(0, 12, 1024).astype(np.uint32)
    dst = rng.integers(0, 12, 1024).astype(np.uint32)
    w = rng.integers(-8, 9, 1024).astype(np.float32)
    w[w == 0] = 1
    s_rep, d_rep, w_agg, n_seg = _assert_same_preagg(src, dst, w, out_size)
    n = int(n_seg)
    assert (n <= out_size) == (out_size == 256)
    if n <= out_size:
        want = collections.Counter()
        for s, d, x in zip(src, dst, w):
            want[(int(s), int(d))] += float(x)
        got = {(int(s), int(d)): float(x) for s, d, x in zip(s_rep[:n], d_rep[:n], w_agg[:n])}
        assert got == dict(want) and not w_agg[n:].any()


def _colliding_pair():
    """Two distinct (src, dst) pairs with equal 32-bit mixed keys, found by
    a birthday search over a seeded numpy draw."""
    rng = np.random.default_rng(0)
    src = rng.integers(0, 2**32, 300_000, dtype=np.uint64).astype(np.uint32)
    dst = rng.integers(0, 2**32, 300_000, dtype=np.uint64).astype(np.uint32)
    keys = mix_keys(keys_to_tensor(src), keys_to_tensor(dst)).numpy()
    order = np.argsort(keys, kind="stable")
    same = np.flatnonzero(keys[order][1:] == keys[order][:-1])
    for i in same:
        a, b = order[i], order[i + 1]
        if (src[a], dst[a]) != (src[b], dst[b]):
            return (src[a], dst[a]), (src[b], dst[b])
    raise AssertionError("no collision in the draw")


@pytest.mark.parametrize("pattern", ["interleaved", "grouped"])
def test_preaggregate_edges_on_colliding_keys_matches_the_stable_sort(pattern):
    p, q = _colliding_pair()
    key = lambda x: int(np.asarray(ref_mix_keys(jnp.asarray([x[0]], jnp.uint32), jnp.asarray([x[1]], jnp.uint32)))[0])  # noqa: E731
    assert p != q and key(p) == key(q)
    seq = [p, q, p, q, p] if pattern == "interleaved" else [p, p, q, q, p]
    rng = np.random.default_rng(2)
    other = list(zip(rng.integers(0, 50, 40).astype(np.uint32), rng.integers(0, 50, 40).astype(np.uint32)))
    pairs = other[:20] + seq + other[20:]
    src = np.array([s for s, _ in pairs], np.uint32)
    dst = np.array([d for _, d in pairs], np.uint32)
    w = np.arange(1, len(pairs) + 1, dtype=np.float32)
    _, _, _, n_seg = _assert_same_preagg(src, dst, w, 64)
    distinct = len(set(pairs))
    # Colliding pairs split into runs in stream order: more segments than pairs.
    assert int(n_seg) == distinct + (3 if pattern == "interleaved" else 1)
