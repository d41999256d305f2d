"""Parity of the port's query plane beyond the served families with the JAX
reference: the wildcard, bound-wildcard and triangle queries, the global
triangle estimate, PageRank on the summary (function and session), the
bounded-hop reach, the heavy-hitter buckets and the Section-4.2 monitor.
The same numpy stream goes into a reference sketch, whose leaves are
carried across with ``convert.py``.  Bit-equal (integer weights), except
PageRank: float32 sums in another order, ``rtol=1e-5, atol=1e-7``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import queries as ref_q
from repro.core import reach as ref_reach
from repro.core.sketch import GLavaSketch as RefSketch, SketchConfig as RefConfig
from repro_torch.core import queries, reach
from repro_torch.core.hashing import keys_to_tensor

from _torch_parity import assert_same_value, keys_pair, open_pair, to_port

SQUARE = RefConfig(depth=4, width_rows=64, width_cols=64)
CONFIGS = [
    SQUARE,
    RefConfig(depth=3, width_rows=48, width_cols=80),
    RefConfig(depth=3, width_rows=64, width_cols=64, directed=False),
]
IDS = ["square", "nonsquare", "undirected"]


def _loaded(cfg, seed=0, n=600, n_nodes=120):
    """A reference sketch with ``n`` integer-weight edges and its port twin;
    the stream holds the triangles 1->2->3->1 and 4->5->6->4."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([[1, 2, 3, 4, 5, 6], rng.integers(0, n_nodes, n)]).astype(np.uint32)
    dst = np.concatenate([[2, 3, 1, 5, 6, 4], rng.integers(0, n_nodes, n)]).astype(np.uint32)
    w = rng.integers(1, 6, src.size).astype(np.float32)
    ref = RefSketch.empty(cfg, jax.random.key(seed)).update(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w), backend="scatter", preagg="off"
    )
    return ref, to_port(ref)


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
@pytest.mark.parametrize("form", ["edge", "src_wild", "dst_wild", "both_wild"])
def test_wildcard_edge_query_matches_reference(cfg, form):
    ref, port = _loaded(cfg)
    rng = np.random.default_rng(1)
    (js, ts), (jd, td) = keys_pair(rng.integers(0, 120, 50), rng.integers(0, 120, 50))
    args = {"edge": ((js, jd), (ts, td)), "src_wild": ((js, None), (ts, None)),
            "dst_wild": ((None, jd), (None, td)), "both_wild": ((None, None), (None, None))}[form]
    assert_same_value(queries.wildcard_edge_query(port, *args[1]), ref_q.wildcard_edge_query(ref, *args[0]))


@pytest.mark.parametrize("cfg", [CONFIGS[0], CONFIGS[2]], ids=["square", "undirected"])
def test_bound_wildcard_path2_matches_reference(cfg):
    ref, port = _loaded(cfg)
    rng = np.random.default_rng(2)
    (jb, tb), (jc, tc) = keys_pair(rng.integers(0, 120, 40), rng.integers(0, 120, 40))
    got = queries.bound_wildcard_path2(port, tb, tc)
    assert_same_value(got, ref_q.bound_wildcard_path2(ref, jb, jc))
    assert float(got.max()) > 0


def test_bound_wildcard_path2_refuses_a_non_square_sketch():
    ref, port = _loaded(CONFIGS[1])
    (jb, tb), (jc, tc) = keys_pair(np.arange(4), np.arange(4))
    with pytest.raises(ValueError, match="square"):
        ref_q.bound_wildcard_path2(ref, jb, jc)
    with pytest.raises(ValueError, match="square"):
        queries.bound_wildcard_path2(port, tb, tc)


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
def test_triangle_query_matches_reference(cfg):
    ref, port = _loaded(cfg)
    triples = [(1, 2, 3), (3, 1, 2), (1, 3, 2), (4, 5, 6), (6, 5, 4), (7, 8, 9), (10, 10, 10)]
    triples += [tuple(t) for t in np.random.default_rng(3).integers(0, 120, (8, 3))]
    found = 0
    for a, b, c in triples:
        want = ref_q.triangle_query(ref, *(jnp.asarray(x, jnp.uint32) for x in (a, b, c)))
        got = queries.triangle_query(port, *(torch.tensor(int(x)) for x in (a, b, c)))
        assert_same_value(got, want)
        found += float(got) > 0
    assert found >= 2  # the planted triangles


@pytest.mark.parametrize("cfg,n", [(RefConfig(depth=3, width_rows=16, width_cols=16), 120),
                                   (RefConfig(depth=4, width_rows=32, width_cols=32), 300)], ids=["w16", "w32"])
def test_global_triangle_estimate_matches_reference(cfg, n):
    rng = np.random.default_rng(n)
    src, dst = rng.integers(0, 60, n).astype(np.uint32), rng.integers(0, 60, n).astype(np.uint32)
    w = rng.integers(1, 3, n).astype(np.float32)
    ref = RefSketch.empty(cfg, jax.random.key(4)).update(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w))
    port = to_port(ref)
    m = np.asarray(ref.counters).astype(np.float64)
    exact = np.einsum("dij,djk,dki->d", m, m, m)
    assert 0 < exact.max() < 2**24  # every partial sum is an exact float32 integer
    got = queries.global_triangle_estimate(port)
    assert_same_value(got, ref_q.global_triangle_estimate(ref))
    assert float(got) == exact.min()


@pytest.mark.parametrize("cfg", [CONFIGS[0], CONFIGS[2]], ids=["square", "undirected"])
@pytest.mark.parametrize("damping,iters", [(0.85, 32), (0.5, 5)])
def test_sketch_pagerank_matches_reference(cfg, damping, iters):
    ref, port = _loaded(cfg)
    got = queries.sketch_pagerank(port, damping, iters)
    want = np.asarray(ref_q.sketch_pagerank(ref, damping, iters))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got.sum(dim=1).numpy(), 1.0, atol=1e-5)


@pytest.mark.parametrize("k", [0, 1, 2, 3])
def test_k_hop_reach_matches_reference(k):
    ref, port = _loaded(RefConfig(depth=3, width_rows=48, width_cols=48), n=60)
    assert_same_value(reach.k_hop_reach(port.counters, k), ref_reach.k_hop_reach(ref.counters, k))
    chain = np.array([[0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1], [0, 0, 0, 0]], np.float32)
    assert_same_value(reach.k_hop_reach(torch.from_numpy(chain), k), ref_reach.k_hop_reach(jnp.asarray(chain), k))


def test_k_hop_reach_grows_to_the_closure():
    _, port = _loaded(RefConfig(depth=2, width_rows=32, width_cols=32), n=40)
    hops = [reach.k_hop_reach(port.counters, k) for k in (1, 2, 4, 33)]
    for a, b in zip(hops, hops[1:]):
        assert bool((a <= b).all())
    assert torch.equal(hops[-1], reach.transitive_closure(port.counters))


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
@pytest.mark.parametrize("theta", [0.0, 20.0, 60.0])
def test_heavy_hitter_buckets_match_reference(cfg, theta):
    ref, port = _loaded(cfg)
    got, want = queries.heavy_hitter_buckets(port, theta), ref_q.heavy_hitter_buckets(ref, theta)
    for g, w in zip(got, want):
        assert_same_value(g, w)


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
def test_monitor_step_matches_reference(cfg):
    ref, port = _loaded(cfg)
    rng = np.random.default_rng(5)
    watch = np.uint32(2)
    src = rng.integers(0, 120, 30).astype(np.uint32)
    dst = np.where(rng.random(30) < 0.3, watch, rng.integers(0, 120, 30)).astype(np.uint32)
    w = rng.integers(1, 4, 30).astype(np.float32)
    (js, ts), (jd, td) = keys_pair(src, dst)
    inflow = float(queries.node_in_flow(port, keys_to_tensor(np.atleast_1d(watch)))[0])
    for theta in (inflow - 1, inflow + 2, inflow + 1000):
        alarm, new = queries.monitor_step(port, ts, td, torch.from_numpy(w), torch.tensor(int(watch)), theta)
        ref_alarm, ref_new = ref_q.monitor_step(ref, js, jd, jnp.asarray(w), jnp.asarray(watch), theta)
        assert alarm.dtype == torch.bool and bool(alarm) == bool(ref_alarm)
        for name in ("counters", "row_flows", "col_flows"):
            assert_same_value(getattr(new, name), getattr(ref_new, name))
    assert not torch.equal(new.counters, port.counters)  # functional: the input is left as it was
    assert_same_value(port.counters, ref.counters)


@pytest.mark.parametrize("cfg", [CONFIGS[0], CONFIGS[2]], ids=["square", "undirected"])
def test_graphstream_pagerank_matches_reference(cfg):
    ref, port = open_pair(cfg, seed=3)
    rng = np.random.default_rng(6)
    for _ in range(3):
        src, dst = rng.integers(0, 200, 400), rng.integers(0, 200, 400)
        w = rng.integers(1, 5, 400).astype(np.float32)
        ref.ingest(src, dst, w)
        port.ingest(src, dst, w)
    got, want = port.pagerank(), ref.pagerank()
    assert isinstance(got, np.ndarray) and got.shape == want.shape == (cfg.depth, cfg.width_rows)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(port.pagerank(0.5, 4), ref.pagerank(0.5, 4), rtol=1e-5, atol=1e-7)


def test_path_queries_are_re_exported():
    assert queries.reach_query is reach.reach_query
    assert queries.reach_query_precomputed is reach.reach_query_precomputed
    assert queries.transitive_closure is reach.transitive_closure
