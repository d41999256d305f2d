"""Parity of the port's fused-ingest plane with the JAX reference: the
one-pass fused ingest's plain version against ``fused_ingest`` (interpret
mode, the Pallas kernel body) and ``fused_ingest_ref``; ``update_fused``
directed and undirected on a converted reference sketch; the bitmap form of
``refresh_closure``; and fused sessions against reference fused sessions
(counters, registers, receipt bitmaps, closure refresh counts, subscription
transcript).  Exact for integer weights; float weights to ``rtol=1e-6,
atol=1e-5`` (as ``tests/test_kernels.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import GLavaSketch as RefSketch, QueryEngine as RefEngine, SketchConfig as RefConfig
from repro.kernels.ingest_fused.ops import fused_ingest as ref_fused_ingest
from repro.kernels.ingest_fused.ref import fused_ingest_ref as ref_fused_ingest_ref
from repro_torch.api import Query
from repro_torch.core.hashing import keys_to_tensor
from repro_torch.core.query_engine import QueryEngine
from repro_torch.kernels.ingest_fused.ops import fused_ingest
from repro_torch.kernels.ingest_fused.ref import fused_ingest_ref

from _torch_parity import assert_same_sketch, hashed_batch, open_pair, to_port, torch_copies

# tests/test_kernels.py::FUSED_SHAPES: non-multiple widths, odd batch sizes.
FUSED_SHAPES = [(1, 64, 64, 33), (2, 256, 128, 512), (3, 300, 200, 1000)]


def _assert_outputs_equal(got, want, exact=True):
    for name, g, w in zip(("counters", "row_flows", "col_flows", "touched"), got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (name, g.dtype, w.dtype)
        if exact or name == "touched":
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("fn", [fused_ingest_ref, fused_ingest], ids=["plain", "wrapper-on-cpu"])
@pytest.mark.parametrize("d,wr,wc,b", FUSED_SHAPES)
def test_plain_version_bit_equals_reference_kernel_and_ref(fn, d, wr, wc, b):
    arrays = hashed_batch(np.random.default_rng(d * b), d, wr, wc, b, inert_frac=0.1, zero_frac=0.1)
    ref_args = [jnp.asarray(a) for a in arrays]
    want_kernel = ref_fused_ingest(*ref_args, interpret=True)
    want_ref = ref_fused_ingest_ref(*ref_args)
    state = torch_copies(*arrays)
    got = fn(*state)
    for out, inp in zip(got[:3], state[:3]):
        assert out.data_ptr() == inp.data_ptr()  # in place
    _assert_outputs_equal(got, want_kernel)
    _assert_outputs_equal(got, want_ref)


def test_weight_zero_slot_marks_its_row_and_inert_rows_touch_nothing():
    counters, rf, cf = np.zeros((2, 8, 8), np.float32), np.zeros((2, 8), np.float32), np.zeros((2, 8), np.float32)
    rows = np.array([[3, -1, 5], [-1, 2, 2]], np.int32)
    cols = np.array([[1, 7, 4], [6, 0, 0]], np.int32)
    w = np.array([0.0, 4.0, 2.0], np.float32)
    got = fused_ingest_ref(*torch_copies(counters, rf, cf, rows, cols, w))
    _assert_outputs_equal(got, ref_fused_ingest_ref(*(jnp.asarray(a) for a in (counters, rf, cf, rows, cols, w))))
    c, r, col, touched = (t.numpy() for t in got)
    assert touched[0].nonzero()[0].tolist() == [3, 5] and touched[1].nonzero()[0].tolist() == [2]
    assert c.sum() == 2 + 4 + 2 and r[0, 3] == 0 and r[1, 2] == 6 and col[0, 7] == 0 and col[1, 6] == 0


def test_all_inert_batch_changes_nothing():
    arrays = hashed_batch(np.random.default_rng(3), 2, 64, 64, 40, inert_frac=1.0)
    got = fused_ingest_ref(*torch_copies(*arrays))
    for out, before in zip(got[:3], arrays[:3]):
        np.testing.assert_array_equal(out.numpy(), before)
    assert not bool(got[3].any())


def test_float_weights_close_to_reference():
    rng = np.random.default_rng(5)
    counters = np.zeros((2, 128, 128), np.float32)
    rf, cf = np.zeros((2, 128), np.float32), np.zeros((2, 128), np.float32)
    rows = rng.integers(0, 128, (2, 700)).astype(np.int32)
    cols = rng.integers(0, 128, (2, 700)).astype(np.int32)
    w = rng.normal(0, 1, 700).astype(np.float32)
    want = ref_fused_ingest(*(jnp.asarray(a) for a in (counters, rf, cf, rows, cols, w)), interpret=True)
    _assert_outputs_equal(fused_ingest_ref(*torch_copies(counters, rf, cf, rows, cols, w)), want, exact=False)


def test_wrapper_refuses_devices_other_than_cuda_and_cpu():
    meta = [torch.empty(s, device="meta") for s in ((1, 8, 8), (1, 8), (1, 8))]
    idx = torch.zeros(1, 4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fused_ingest(*meta, idx, idx, torch.ones(4, device="meta"))


@pytest.mark.parametrize("directed", [True, False], ids=["directed", "undirected"])
@pytest.mark.parametrize("wr,wc", [(128, 128), (96, 160)])
def test_update_fused_matches_reference(directed, wr, wc):
    cfg = RefConfig(depth=3, width_rows=wr, width_cols=wc, directed=directed)
    rng = np.random.default_rng(wr + directed)
    ref = RefSketch.empty(cfg, jax.random.key(5)).update(
        jnp.asarray(rng.integers(0, 900, 400), jnp.uint32), jnp.asarray(rng.integers(0, 900, 400), jnp.uint32))
    src = rng.integers(0, 900, 600).astype(np.uint32)
    dst = rng.integers(0, 900, 600).astype(np.uint32)
    w = rng.integers(0, 5, 600).astype(np.float32)
    want, want_touched = ref.update_fused(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w))
    port = to_port(ref)
    assert (port.col_hash is port.row_hash) == (wr == wc)
    before = port.counters.clone()
    new, touched = port.update_fused(keys_to_tensor(src), keys_to_tensor(dst), torch.from_numpy(w))
    assert torch.equal(port.counters, before)  # the functional form leaves its operand
    assert_same_sketch(new, want)
    np.testing.assert_array_equal(touched.numpy(), np.asarray(want_touched))
    same, touched_ = port.update_fused_(keys_to_tensor(src), keys_to_tensor(dst), torch.from_numpy(w))
    assert same is port and torch.equal(touched_, touched)
    assert_same_sketch(port, want)


@pytest.mark.parametrize("form", ["numpy", "torch"])
def test_refresh_closure_bitmap_matches_full_rebuild(form):
    """tests/test_ingest_fastpath.py's bitmap refresh, on the port and against
    the reference engine: the incremental answer equals a full rebuild."""
    cfg = RefConfig(depth=2, width_rows=64, width_cols=64)
    rng = np.random.default_rng(13)
    sk0 = RefSketch.empty(cfg, jax.random.key(13))
    src1, dst1 = rng.integers(0, 20, 300).astype(np.uint32), rng.integers(0, 20, 300).astype(np.uint32)
    sk1 = sk0.update(jnp.asarray(src1), jnp.asarray(dst1))
    src2, dst2 = rng.integers(0, 8, 120).astype(np.uint32), rng.integers(0, 8, 120).astype(np.uint32)
    sk2 = sk1.update(jnp.asarray(src2), jnp.asarray(dst2))
    p1, p2 = to_port(sk1), to_port(sk2)
    q = np.arange(6, dtype=np.uint32)
    bitmap = np.zeros((2, 64), bool)
    rows = np.asarray(sk1.row_hash(jnp.asarray(np.unique(src2))))
    for di in range(2):
        bitmap[di, np.unique(rows[di])] = True

    want = RefEngine("jnp", pad_q=8).reach(sk2, jnp.asarray(q), jnp.asarray(q), epoch=1)
    full = QueryEngine("torch", pad_q=8).reach(p2, keys_to_tensor(q), keys_to_tensor(q), epoch=1)
    inc = QueryEngine("torch", pad_q=8)
    inc.reach(p1, keys_to_tensor(q), keys_to_tensor(q), epoch=0)
    inc.refresh_closure(p2, bitmap if form == "numpy" else torch.from_numpy(bitmap), epoch=1)
    got = inc.reach(p2, keys_to_tensor(q), keys_to_tensor(q), epoch=1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), full.numpy())
    assert (inc.closure_refreshes, inc.closure_incremental_refreshes) == (1, 1)
    # The same refresh through the reference engine takes the same route.
    ref_inc = RefEngine("jnp", pad_q=8)
    ref_inc.reach(sk1, jnp.asarray(q), jnp.asarray(q), epoch=0)
    ref_inc.refresh_closure(sk2, bitmap, epoch=1)
    assert (ref_inc.closure_refreshes, ref_inc.closure_incremental_refreshes) == (1, 1)


def test_refresh_closure_bitmap_fallbacks():
    cfg = RefConfig(depth=2, width_rows=64, width_cols=64)
    sk = to_port(RefSketch.empty(cfg, jax.random.key(1)).update(
        jnp.arange(10, dtype=jnp.uint32), jnp.arange(1, 11, dtype=jnp.uint32)))
    eng = QueryEngine("torch")
    eng.closure_for(sk, epoch=0)
    eng.refresh_closure(sk, np.zeros((2, 64), bool), epoch=1)  # nothing touched: retag only
    assert (eng.closure_refreshes, eng.closure_incremental_refreshes, eng._closure_epoch) == (1, 0, 1)
    wide = np.zeros((2, 64), bool)
    wide[1, :17] = True  # 17 > 0.25 * 64 in the most-touched depth
    eng.refresh_closure(sk, wide, epoch=2)
    assert (eng.closure_refreshes, eng.closure_incremental_refreshes) == (2, 0)
    wide[1, 16] = False  # 16 rows: still incremental
    eng.refresh_closure(sk, wide, epoch=3)
    assert (eng.closure_refreshes, eng.closure_incremental_refreshes) == (2, 1)


def _dup_heavy(rng, n, n_keys=40, lo_key=1, signed=False):
    src = rng.integers(lo_key, lo_key + n_keys, n).astype(np.uint32)
    dst = rng.integers(lo_key, lo_key + n_keys, n).astype(np.uint32)
    w = rng.integers(-8 if signed else 1, 9, n)
    w[w == 0] = 1
    return src, dst, w.astype(np.float32)


@pytest.mark.parametrize("directed", [True, False], ids=["directed", "undirected"])
@pytest.mark.parametrize("n", [3000, 500], ids=["preaggregated", "raw"])
def test_fused_session_matches_reference_fused_session(directed, n):
    """Counters, registers and the receipt's bitmap, with key 0 absent from
    the batch: a pre-aggregated batch is padded with (0, 0; 0) slots, which
    are valid in the fused kernel and so mark row_hash(0) in every depth."""
    cfg = RefConfig(depth=3, width_rows=128, width_cols=128, directed=directed)
    ref, port = open_pair(cfg, seed=2, ingest_backend="fused")
    src, dst, w = _dup_heavy(np.random.default_rng(n), n)
    a, b = ref.ingest(src, dst, w), port.ingest(src, dst, w)
    assert a.touched_keys is None and b.touched_keys is None
    assert b.touched_rows.dtype == torch.bool and tuple(b.touched_rows.shape) == (3, 128)
    np.testing.assert_array_equal(b.touched_rows.numpy(), np.asarray(a.touched_rows))
    zero_rows = port._live().row_hash(keys_to_tensor(np.zeros(1, np.uint32)))[:, 0]
    assert bool(b.touched_rows[torch.arange(3), zero_rows].all()) == (n >= 1024)
    ref.flush()
    assert_same_sketch(port._live(), ref._sketch)
    assert port.ingest_backend == ref.ingest_backend == "fused"


def test_fused_session_bitmap_drives_incremental_refresh():
    """Reach answers of port and reference fused sessions agree with a plain
    port session, after the second tick rode the bitmap refresh."""
    cfg = RefConfig(depth=3, width_rows=128, width_cols=128)
    ref, port = open_pair(cfg, seed=4, ingest_backend="fused")
    _, plain = open_pair(cfg, seed=4)
    rng = np.random.default_rng(4)
    q_src, q_dst = rng.integers(0, 30, 16).astype(np.uint32), rng.integers(0, 30, 16).astype(np.uint32)
    for tick_seed in (10, 11):
        rng2 = np.random.default_rng(tick_seed)
        src = rng2.integers(0, 30, 500).astype(np.uint32)
        dst = rng2.integers(0, 30, 500).astype(np.uint32)
        for gs in (ref, port, plain):
            gs.ingest(src, dst)
            gs.reachable(q_src, q_dst)
    want = np.asarray(ref.reachable(q_src, q_dst))
    np.testing.assert_array_equal(port.reachable(q_src, q_dst), want)
    np.testing.assert_array_equal(plain.reachable(q_src, q_dst), want)
    assert port.engine.closure_refreshes == ref.engine.closure_refreshes == 1
    assert port.engine.closure_incremental_refreshes == ref.engine.closure_incremental_refreshes >= 1


def test_fused_session_deletes_force_full_rebuild():
    cfg = RefConfig(depth=3, width_rows=128, width_cols=128)
    ref, port = open_pair(cfg, seed=0, ingest_backend="fused")
    src, dst = np.arange(10, dtype=np.uint32), np.arange(10, 20, dtype=np.uint32)
    for gs in (ref, port):
        gs.ingest(src, dst)
        gs.reachable(src[:2], dst[:2])
        assert gs.engine.closure_refreshes == 1
        receipt = gs.ingest(src, dst, np.full(10, -1.0, np.float32))  # turnstile delete
        assert receipt.touched_rows is None and receipt.touched_keys is None
        gs.reachable(src[:2], dst[:2])
        assert gs.engine.closure_refreshes == 2
    ref.flush()
    assert_same_sketch(port._live(), ref._sketch)


def test_fused_session_transcript_matches_reference():
    """A standing reach/edge/flow workload, ticked every batch, over a run of
    pre-aggregated and raw batches and one delete."""
    cfg = RefConfig(depth=3, width_rows=256, width_cols=256)
    ref, port = open_pair(cfg, seed=6, ingest_backend="fused")
    from repro.api import Query as RefQuery

    rng = np.random.default_rng(6)
    u, v = rng.integers(0, 300, 64).astype(np.uint32), rng.integers(0, 300, 64).astype(np.uint32)
    subs = [gs.subscribe(Q.edge(u, v), Q.reach(u[:24], v[:24]), Q.in_flow(u[:16]), every=1, name="w")
            for gs, Q in ((ref, RefQuery), (port, Query))]
    for i, n in enumerate([3000, 40, 2500, 60, 80, 2000]):
        src = rng.integers(0, 300, n).astype(np.uint32)
        dst = rng.integers(0, 300, n).astype(np.uint32)
        if i == 3:
            ref.delete(src, dst), port.delete(src, dst)
        else:
            ref.ingest(src, dst), port.ingest(src, dst)
    got, want = subs[1].poll(), subs[0].poll()
    assert [(e.tick, e.epoch) for e in got] == [(e.tick, e.epoch) for e in want] and len(got) == 6
    for g, w in zip(got, want):
        for rg, rw in zip(g.results, w.results):
            np.testing.assert_array_equal(np.asarray(rg.value), np.asarray(rw.value))
    assert (port.engine.closure_refreshes, port.engine.closure_incremental_refreshes) == (
        ref.engine.closure_refreshes, ref.engine.closure_incremental_refreshes)
    assert port.engine.closure_incremental_refreshes > 0
    assert_same_sketch(port.sketch, ref.sketch)


def test_fused_session_keeps_one_bitmap_between_closure_syncs():
    """Without a closure consumer the per-batch bitmaps fold into one device
    accumulator instead of piling up; the accumulator is their OR."""
    ref, port = open_pair(RefConfig(depth=2, width_rows=64, width_cols=64), ingest_backend="fused")
    rng = np.random.default_rng(9)
    union = np.zeros((2, 64), bool)
    for _ in range(5):
        src, dst, w = _dup_heavy(rng, 50, n_keys=200)
        union |= port.ingest(src, dst, w).touched_rows.numpy()
    assert len(port._touched) == 1
    np.testing.assert_array_equal(port._touched[0].numpy(), union)


# Bucket dtypes the fused kernel refuses, as (rows, cols) pairs: floats,
# narrow integers, and rows and columns of different dtypes.
BAD_INDEX_DTYPES = [
    (torch.float32, torch.float32), (torch.float64, torch.float64), (torch.int16, torch.int16),
    (torch.uint8, torch.uint8), (torch.int32, torch.int64), (torch.int64, torch.int32),
]


@pytest.mark.parametrize("rows_dtype,cols_dtype", BAD_INDEX_DTYPES, ids=lambda t: str(t)[6:])
def test_wrapper_refuses_other_index_dtypes_on_the_cpu(rows_dtype, cols_dtype):
    arrays = hashed_batch(np.random.default_rng(4), 2, 16, 16, 8)
    counters, rf, cf, rows, cols, w = torch_copies(*arrays)
    with pytest.raises(ValueError, match="int32 or both int64"):
        fused_ingest(counters, rf, cf, rows.to(rows_dtype), cols.to(cols_dtype), w)
    for got, before in zip((counters, rf, cf), arrays[:3]):
        np.testing.assert_array_equal(got.numpy(), before)  # refused before any write


def test_wrapper_refuses_bad_weights_registers_and_bitmap():
    counters, rf, cf, rows, cols, w = torch_copies(*hashed_batch(np.random.default_rng(5), 2, 16, 8, 8))
    with pytest.raises(ValueError, match="weights"):
        fused_ingest(counters, rf, cf, rows, cols, w.double())
    with pytest.raises(ValueError, match="row_flows"):
        fused_ingest(counters, rf.double(), cf, rows, cols, w)
    with pytest.raises(ValueError, match="col_flows"):
        fused_ingest(counters, rf, rf, rows, cols, w)  # (d, wr) where (d, wc) is due
    for bad in (torch.zeros(2, 16, dtype=torch.uint8), torch.zeros(2, 8, dtype=torch.bool),
                torch.zeros(16, 2, dtype=torch.bool).t()):
        with pytest.raises(ValueError, match="touched"):
            fused_ingest(counters, rf, cf, rows, cols, w, bad)


@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64], ids=["int32", "int64"])
def test_wrapper_takes_int32_and_int64_buckets_as_fused_ingest_pallas(index_dtype):
    arrays = hashed_batch(np.random.default_rng(8), 2, 256, 128, 512, inert_frac=0.1, zero_frac=0.1)
    want = ref_fused_ingest(*(jnp.asarray(a) for a in arrays), interpret=True)
    counters, rf, cf, rows, cols, w = torch_copies(*arrays)
    got = fused_ingest(counters, rf, cf, rows.to(index_dtype), cols.to(index_dtype), w)
    _assert_outputs_equal(got, want)


@pytest.mark.parametrize("fn", [fused_ingest_ref, fused_ingest], ids=["plain", "wrapper-on-cpu"])
def test_given_bitmap_is_ored_into_as_two_launches_of_the_reference(fn):
    """The second launch of an undirected sketch ORs its rows into the first
    launch's bitmap: the same bitmap as the reference's ``touched |
    touched2``, in the same tensor, and the same counters and registers."""
    rng = np.random.default_rng(11)
    counters, rf, cf, rows, cols, w = hashed_batch(rng, 3, 64, 64, 300, inert_frac=0.2, zero_frac=0.1)
    rows2 = rng.integers(-1, 64, rows.shape).astype(np.int32)
    cols2 = rng.integers(0, 64, cols.shape).astype(np.int32)
    a = ref_fused_ingest(*(jnp.asarray(x) for x in (counters, rf, cf, rows, cols, w)), interpret=True)
    b = ref_fused_ingest(*a[:3], jnp.asarray(rows2), jnp.asarray(cols2), jnp.asarray(w), interpret=True)
    state = torch_copies(counters, rf, cf)
    *_, touched = fn(*state, *torch_copies(rows, cols, w))
    first = touched.clone()
    got = fn(*state, *torch_copies(rows2, cols2, w), touched)
    assert got[3] is touched
    assert bool((touched >= first).all())  # nothing the first launch marked is cleared
    _assert_outputs_equal(got, (*b[:3], np.asarray(a[3]) | np.asarray(b[3])))
