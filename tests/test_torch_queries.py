"""Parity of the port's query plane with the JAX reference: every family the
``QueryEngine`` registers, on both port backends (``cuda`` runs its plain
version on CPU tensors) against the reference engine; the multi-query and
closure kernels' plain versions against ``multi_query_pallas`` and
``closure_step_pallas`` in interpret mode; ``closure_refresh`` against a
full rebuild; and the engine's closure-cache fallbacks."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import reach as ref_reach
from repro.core.query_engine import QueryEngine as RefEngine
from repro.core.sketch import GLavaSketch as RefSketch, SketchConfig as RefConfig
from repro.kernels.closure.kernel import closure_step_pallas
from repro.kernels.query.kernel import multi_query_pallas
from repro.kernels.query.ops import edge_query_min as ref_edge_query_min
from repro_torch.core import reach
from repro_torch.core.hashing import keys_to_tensor
from repro_torch.core.query_engine import QueryEngine
from repro_torch.kernels.closure.ops import closure_step, transitive_closure as closure_loop
from repro_torch.kernels.closure.ref import closure_step_ref
from repro_torch.kernels.query.ops import edge_query_min
from repro_torch.kernels.query.ref import edge_query_min_ref

from _torch_parity import to_port

N_NODES = 400


def _loaded(cfg, seed=0, n=3000):
    rng = np.random.default_rng(seed)
    sk = RefSketch.empty(cfg, jax.random.key(seed))
    src = rng.integers(0, N_NODES, n).astype(np.uint32)
    dst = rng.integers(0, N_NODES, n).astype(np.uint32)
    src[:50] = dst[:50]  # self-loops exercise the undirected correction
    w = rng.integers(1, 6, n).astype(np.float32)
    return sk.update(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w), preagg="off")


SQUARE = RefConfig(depth=3, width_rows=64, width_cols=64)
NONSQUARE = RefConfig(depth=2, width_rows=80, width_cols=48)
UNDIRECTED = RefConfig(depth=3, width_rows=64, width_cols=64, directed=False)


def _np(x):
    return tuple(_np(v) for v in x) if isinstance(x, tuple) else np.asarray(x)


def _host(x):
    return tuple(_host(v) for v in x) if isinstance(x, tuple) else x.cpu().numpy()


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("cfg", [SQUARE, NONSQUARE, UNDIRECTED], ids=["square", "nonsquare", "undirected"])
def test_every_family_matches_reference_engine(cfg, backend):
    ref = _loaded(cfg, seed=cfg.width_cols)
    port = to_port(ref)
    rng = np.random.default_rng(1)
    q = 700  # pads to 768 and, with chunk_q=256, runs in three chunks
    u = rng.integers(0, N_NODES, q).astype(np.uint32)
    v = rng.integers(0, N_NODES, q).astype(np.uint32)
    v[:20] = u[:20]
    thetas = rng.uniform(0.0, 0.05, q).astype(np.float32)
    ju, jv, jt = jnp.asarray(u), jnp.asarray(v), jnp.asarray(thetas)
    tu, tv, tt = keys_to_tensor(u), keys_to_tensor(v), torch.from_numpy(thetas)
    re, pe = RefEngine("jnp", chunk_q=256), QueryEngine(backend, chunk_q=256)
    pairs = [
        (re.edge(ref, ju, jv), pe.edge(port, tu, tv)),
        (re.in_flow(ref, ju), pe.in_flow(port, tu)),
        (re.out_flow(ref, ju), pe.out_flow(port, tu)),
        (re.flow(ref, ju), pe.flow(port, tu)),
        (re.heavy(ref, ju, 40.0), pe.heavy(port, tu, 40.0)),
        (re.heavy_vec(ref, ju, jt * 1000), pe.heavy_vec(port, tu, tt * 1000)),
        (re.heavy_rel_vec(ref, ju, jt), pe.heavy_rel_vec(port, tu, tt)),
        (re.subgraph(ref, ju[:5], jv[:5]), pe.subgraph(port, tu[:5], tv[:5])),
        (re.subgraph(ref, ju[:5], jv[:5], optimized=True), pe.subgraph(port, tu[:5], tv[:5], optimized=True)),
    ]
    n, k = 6, 4
    mask = rng.random((n, k)) < 0.7
    mask[:, 0] = True
    su, sv = u[: n * k].reshape(n, k), v[: n * k].reshape(n, k)
    pairs.append((
        re.subgraph_batch(ref, jnp.asarray(su), jnp.asarray(sv), jnp.asarray(mask)),
        pe.subgraph_batch(port, keys_to_tensor(su), keys_to_tensor(sv), torch.from_numpy(mask)),
    ))
    if cfg.is_square:
        pairs.append((re.reach(ref, ju, jv, epoch=1), pe.reach(port, tu, tv, epoch=1)))
    for i, (want, got) in enumerate(pairs):
        want, got = _np(want), _host(got)
        for w_, g_ in zip(want if isinstance(want, tuple) else (want,), got if isinstance(got, tuple) else (got,)):
            assert g_.dtype == w_.dtype and g_.shape == w_.shape, (i, g_.dtype, w_.dtype)
            np.testing.assert_array_equal(g_, w_, err_msg=f"family #{i}")
    assert pe.dispatches["edge"] == 1


def test_multi_query_plain_version_bit_equals_pallas_interpret():
    rng = np.random.default_rng(2)
    counters = rng.integers(0, 100, (2, 256, 256)).astype(np.float32)
    rows = rng.integers(0, 256, (2, 256)).astype(np.int32)
    cols = rng.integers(0, 256, (2, 256)).astype(np.int32)
    want = np.asarray(multi_query_pallas(
        jnp.asarray(counters), jnp.asarray(rows), jnp.asarray(cols), interpret=True))
    t = torch.from_numpy
    np.testing.assert_array_equal(edge_query_min_ref(t(counters), t(rows), t(cols)).numpy(), want)
    np.testing.assert_array_equal(edge_query_min(t(counters), t(rows), t(cols)).numpy(), want)


@pytest.mark.parametrize("d", [1, 3, 9])
def test_multi_query_on_int64_hashed_buckets_bit_equals_pallas_interpret(d):
    """The serve path's buckets: int64 from the port's ``hash_edges``, handed
    to the wrapper as they are, against ``multi_query_pallas`` (through the
    reference's padding wrapper) on the same buckets."""
    rng = np.random.default_rng(d)
    cfg = RefConfig(depth=d, width_rows=200, width_cols=256)
    src = rng.integers(0, N_NODES, 2000).astype(np.uint32)
    dst = rng.integers(0, N_NODES, 2000).astype(np.uint32)
    w = rng.integers(1, 6, 2000).astype(np.float32)
    port = to_port(RefSketch.empty(cfg, jax.random.key(d)).update(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w)))
    qs = np.concatenate([src[:250], rng.integers(0, N_NODES, 250)]).astype(np.uint32)
    qd = np.concatenate([dst[:250], rng.integers(0, N_NODES, 250)]).astype(np.uint32)
    rows, cols = port.hash_edges(keys_to_tensor(qs), keys_to_tensor(qd))
    assert rows.dtype == cols.dtype == torch.int64
    want = np.asarray(ref_edge_query_min(jnp.asarray(port.counters.numpy()), jnp.asarray(rows.numpy()),
                                         jnp.asarray(cols.numpy()), interpret=True))
    np.testing.assert_array_equal(edge_query_min(port.counters, rows, cols).numpy(), want)
    np.testing.assert_array_equal(edge_query_min(port.counters, rows.int(), cols.int()).numpy(), want)
    np.testing.assert_array_equal(edge_query_min_ref(port.counters, rows, cols).numpy(), want)


@pytest.mark.parametrize("density", [0.01, 0.0, 1.0])
def test_closure_step_plain_version_bit_equals_pallas_interpret(density):
    """The plain version and the CPU wrapper take the port's 8-bit storage;
    the Pallas kernel takes float32 0/1.  All ones makes every sum w."""
    rng = np.random.default_rng(3)
    a = (rng.random((256, 256)) < density).astype(np.float32)
    want = np.asarray(closure_step_pallas(jnp.asarray(a), interpret=True)).astype(np.uint8)
    a8 = torch.from_numpy(a.astype(np.uint8))
    got = closure_step_ref(a8)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    out, out_t = torch.empty(1, 256, 256, dtype=torch.uint8), torch.empty(1, 256, 256, dtype=torch.uint8)
    res, res_t = closure_step(a8[None], a8.T.contiguous()[None], out=out, out_t=out_t)
    assert res is out and res_t is out_t
    np.testing.assert_array_equal(out[0].numpy(), want)
    np.testing.assert_array_equal(out_t[0].numpy(), want.T)


@pytest.mark.parametrize("w", [64, 200])
def test_closure_loop_and_plain_closure_match_reference(w):
    rng = np.random.default_rng(w)
    adj = (rng.random((3, w, w)) < 2.0 / w).astype(np.float32) * 3.0
    want = np.asarray(ref_reach.transitive_closure(jnp.asarray(adj)))
    np.testing.assert_array_equal(reach.transitive_closure(torch.from_numpy(adj)).numpy(), want)
    got = closure_loop(torch.from_numpy(adj))  # pads 200 to 256
    assert got.dtype == torch.bool and got.shape == (3, w, w)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_closure_refresh_equals_full_rebuild(seed):
    rng = np.random.default_rng(seed)
    w = 96
    before = (rng.random((2, w, w)) < 1.0 / w).astype(np.float32)
    closure = reach.transitive_closure(torch.from_numpy(before))
    touched = rng.choice(w, 10, replace=False)
    after = before.copy()
    for r in touched:  # additions only, confined to the touched rows
        after[:, r, rng.integers(0, w, 3)] += 1.0
    rows = np.concatenate([np.tile(touched, (2, 1)), np.zeros((2, 6), np.int64)], axis=1)
    got = reach.closure_refresh(closure, torch.from_numpy(after), torch.from_numpy(rows))
    want = reach.transitive_closure(torch.from_numpy(after))
    assert torch.equal(got, want)
    ref = ref_reach.closure_refresh(
        jnp.asarray(np.asarray(closure)), jnp.asarray(after), jnp.asarray(rows.astype(np.int32)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_closure_cache_and_refresh_fallbacks_match_reference():
    ref = _loaded(SQUARE, seed=9, n=200)
    port = to_port(ref)
    re, pe = RefEngine("jnp"), QueryEngine("torch")
    small = np.arange(5, dtype=np.uint32)
    many = np.arange(40, dtype=np.uint32)  # > 25% of 64 rows
    steps = [(None, 1), (None, 2), (many, 3), (small, 4), (small, 4), (np.zeros(0, np.uint32), 5)]
    for keys, epoch in steps:
        a = re.refresh_closure(ref, keys, epoch)
        b = pe.refresh_closure(port, keys, epoch)
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        assert (pe.closure_refreshes, pe.closure_incremental_refreshes) == (
            re.closure_refreshes, re.closure_incremental_refreshes)
    assert (pe.closure_refreshes, pe.closure_incremental_refreshes) == (3, 1)
    pe.closure_for(port, 5)
    assert pe.closure_refreshes == 3  # fresh: same epoch and family
    other = to_port(_loaded(SQUARE, seed=10, n=200))
    pe.closure_for(other, 5)
    assert pe.closure_refreshes == 4  # same epoch, another family: rebuild


def test_staleness_budget_forces_full_rebuild():
    port = to_port(_loaded(SQUARE, seed=3, n=100))
    pe = QueryEngine("torch", closure_staleness_budget=2)
    pe.refresh_closure(port, None, 0)
    for epoch in (1, 2, 3):
        pe.refresh_closure(port, np.arange(3, dtype=np.uint32), epoch)
    assert (pe.closure_refreshes, pe.closure_incremental_refreshes) == (2, 2)


def test_query_backend_resolution():
    from repro_torch.core.query_engine import resolve_query_backend

    assert resolve_query_backend("auto", torch.device("cpu")) == "torch"
    assert resolve_query_backend(None, torch.device("cuda")) == "cuda"
    with pytest.raises(ValueError):
        QueryEngine("pallas")
