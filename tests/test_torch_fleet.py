"""Parity of the port's fleet (``repro_torch.fleet``) with the reference's
(``repro.fleet``) on the CPU.

Both sides get the same numpy inputs, and the port's fleet opens on the
reference fleet's hash family (``fleet_from_arrays``).  Weights are integers,
so every comparison is bit for bit: the stacked scatter, every query family
of windowed and plain, directed and undirected fleets, standing
subscriptions, eviction and fault-in, shards and WAL lanes read by the other
package, ``recover()``, ``SketchServer(tenants=N)`` and the serve entry
point's ``--tenants`` mode.  Port-only properties are tested beside them:
each tenant against an independent port session, tenant-id permutations,
the stacked offsets past 2^31 cells."""
import json
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.fleet as ref_fleet_pkg
from repro.api import Query, QueryBatch
from repro.core.sketch import SketchConfig as RefConfig
from repro.core.sketch import scatter_stacked as ref_scatter_stacked
from repro.fleet import SketchFleet as RefFleet
from repro.launch import serve as ref_serve
from repro_torch.api import GraphStream
from repro_torch.api import Query as PQuery
from repro_torch.core.sketch import scatter_stacked, scatter_stacked_
from repro_torch.fleet import SketchFleet
from repro_torch.kernels.ingest_stacked.ref import stacked_ingest_ref, stacked_offsets
from repro_torch.launch import serve
from repro_torch.serve.engine import SketchServer

from _torch_parity import assert_same_value, port_config, port_fleet

SEED = 11
CFG = RefConfig(depth=3, width_rows=64, width_cols=64)
CFG_UNDIRECTED = RefConfig(depth=3, width_rows=64, width_cols=64, directed=False)
CLI_CFG = RefConfig(depth=3, width_rows=128, width_cols=128)


def _batch(rng, n=32, nodes=500):
    return (
        rng.integers(0, nodes, n).astype(np.uint32),
        rng.integers(0, nodes, n).astype(np.uint32),
        rng.integers(1, 4, n).astype(np.float32),
    )


def _suite(rng, nodes=500):
    qs = rng.integers(0, nodes, 12).astype(np.uint32)
    qd = rng.integers(0, nodes, 12).astype(np.uint32)
    return [
        (Query.edge(qs, qd), PQuery.edge(qs, qd)),
        (Query.in_flow(qs), PQuery.in_flow(qs)),
        (Query.out_flow(qs), PQuery.out_flow(qs)),
        (Query.flow(qs), PQuery.flow(qs)),
        (Query.heavy(qs, 0.05), PQuery.heavy(qs, 0.05)),
        (Query.reach(qs, qd), PQuery.reach(qs, qd)),
        (Query.subgraph(qs[:3], qd[:3]), PQuery.subgraph(qs[:3], qd[:3])),
    ]


def _assert_same_tenant(port, ref, tid, err=""):
    """One tenant's window-summed sketch, epoch and stats, bit for bit."""
    got, want = port.tenant(tid).sketch, ref.tenant(tid).sketch
    for name in ("counters", "row_flows", "col_flows"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=f"tenant {tid} {name} {err}")
    assert port.tenant(tid).epoch == ref.tenant(tid).epoch


def _assert_same_events(got, want):
    assert [(e.tick, e.epoch) for e in got] == [(e.tick, e.epoch) for e in want] and got
    for g, w in zip(got, want):
        for rg, rw in zip(g.results, w.results, strict=True):
            assert_same_value(rg.value, rw.value)


# ---------------------------------------------------------------------------
# scatter_stacked and the stacked offsets
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("plane_dtype", [np.int32, np.int64], ids=["plane32", "plane64"])
@pytest.mark.parametrize("index_dtype", [np.int32, np.int64], ids=["int32", "int64"])
def test_scatter_stacked_matches_reference(index_dtype, plane_dtype):
    """Several planes, negative weights, and slots of -1 rows: the port's
    plain version, ``scatter_stacked`` and ``scatter_stacked_`` against the
    reference's scatter (fed the batch without its inert slots, since the
    reference has no inert row: its -1 lands in the row before)."""
    rng = np.random.default_rng(0)
    n, d, wr, wc, b = 6, 3, 40, 24, 700
    counters = rng.integers(0, 100, (n, d, wr, wc)).astype(np.float32)
    rf = counters.sum(axis=3)
    cf = counters.sum(axis=2)
    plane = rng.integers(0, n, b).astype(plane_dtype)
    rows = rng.integers(0, wr, (d, b)).astype(index_dtype)
    cols = rng.integers(0, wc, (d, b)).astype(index_dtype)
    w = rng.integers(-5, 9, b).astype(np.float32)
    inert = rng.random(b) < 0.1
    rows[:, inert] = -1
    keep = ~inert
    want = ref_scatter_stacked(
        jnp.asarray(counters), jnp.asarray(rf), jnp.asarray(cf), jnp.asarray(plane[keep].astype(np.int32)),
        jnp.asarray(rows[:, keep].astype(np.int32)), jnp.asarray(cols[:, keep].astype(np.int32)),
        jnp.asarray(w[keep]),
    )
    t = [torch.from_numpy(x.copy()) for x in (counters, rf, cf)]
    args = [torch.from_numpy(x) for x in (plane, rows, cols, w)]
    outs = {
        "stacked_ingest_ref": stacked_ingest_ref(*[x.clone() for x in t], *args),
        "scatter_stacked": scatter_stacked(*t, *args, backend="scatter"),
        "scatter_stacked_": scatter_stacked_(*[x.clone() for x in t], *args, backend="auto"),
        "cuda wrapper on the CPU": scatter_stacked_(*[x.clone() for x in t], *args, backend="cuda"),
    }
    for label, got in outs.items():
        for g, x, name in zip(got, want, ("counters", "row_flows", "col_flows")):
            np.testing.assert_array_equal(g.numpy(), np.asarray(x), err_msg=f"{label} {name}")
    assert np.array_equal(t[0].numpy(), counters)  # the functional form left its operands alone


def _duplicate_heavy_batch(pattern, n, d, wr, wc, b, seed):
    """A batch that repeats addresses as a warp sees them: every slot in one
    row of one plane, in one cell, zipf(1.2) sources and destinations grouped
    by plane, or one cell with weights that cancel in pairs (slot 2k + 1
    takes -w[2k])."""
    rng = np.random.default_rng(seed)
    plane = np.zeros(b, np.int32)
    rows = np.full((d, b), 3, np.int32)
    cols = np.full((d, b), 5, np.int32)
    w = rng.integers(1, 9, b).astype(np.float32)
    if pattern == "one_row":
        cols = rng.integers(0, wc, (d, b)).astype(np.int32)
    elif pattern == "zipf":
        plane = np.sort(rng.integers(0, n, b)).astype(np.int32)
        mult = rng.integers(1, 1 << 20, (d, 1))
        rows = ((rng.zipf(1.2, b) % 1000)[None, :] * mult % wr).astype(np.int32)
        cols = ((rng.zipf(1.2, b) % 1000)[None, :] * mult % wc).astype(np.int32)
    elif pattern == "cancelling":
        w = np.where(np.arange(b) % 2 == 0, w, -np.roll(w, 1)).astype(np.float32)
    return plane, rows, cols, w


@pytest.mark.parametrize("pattern", ["one_row", "one_cell", "zipf", "cancelling"])
def test_stacked_ingest_ref_matches_reference_on_duplicate_heavy_batches(pattern):
    """The semantics the stacked kernel's warp aggregation must keep: the
    port's plain version against the reference's ``scatter_stacked`` bit for
    bit on batches whose slots repeat rows and cells (integer weights), with
    weights that cancel leaving the stack as it was; the same batch with
    inert slots (rows -1, planes past N) added gives the same stack."""
    n, d, wr, wc, b = 4, 3, 32, 16, 1500
    rng = np.random.default_rng(1)
    counters = rng.integers(0, 100, (n, d, wr, wc)).astype(np.float32)
    rf, cf = counters.sum(axis=3), counters.sum(axis=2)
    plane, rows, cols, w = _duplicate_heavy_batch(pattern, n, d, wr, wc, b, seed=len(pattern))
    want = ref_scatter_stacked(*(jnp.asarray(x) for x in (counters, rf, cf, plane, rows, cols, w)))
    state = [torch.from_numpy(x.copy()) for x in (counters, rf, cf)]
    got = stacked_ingest_ref(*[x.clone() for x in state], *(torch.from_numpy(x) for x in (plane, rows, cols, w)))
    inert_rows = np.full((d, 64), -1, np.int32)
    padded = (np.concatenate([plane, np.zeros(64, np.int32), np.full(64, n, np.int32)]),
              np.concatenate([rows, inert_rows, np.zeros((d, 64), np.int32)], axis=1),
              np.concatenate([cols, np.zeros((d, 128), np.int32)], axis=1),
              np.concatenate([w, np.ones(128, np.float32)]))
    got_padded = stacked_ingest_ref(*[x.clone() for x in state], *(torch.from_numpy(x) for x in padded))
    for g, gp, x, name in zip(got, got_padded, want, ("counters", "row_flows", "col_flows")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x), err_msg=name)
        np.testing.assert_array_equal(gp.numpy(), np.asarray(x), err_msg=f"{name} with inert slots")
    if pattern == "cancelling":
        np.testing.assert_array_equal(got[0].numpy(), counters)


def test_stacked_offsets_are_int64_past_2_31_cells():
    """The offsets of an (80, 5, 8192, 8192) stack (16 BASE tenants, 5.4e9
    cells) without allocating it: int64 and exact at the last plane, where
    the reference's int32 index arithmetic wraps."""
    n, d, w = 80, 5, 8192
    assert n * d * w * w > 2**31
    plane = torch.tensor([0, n - 1, n - 1], dtype=torch.int32)
    rows = torch.tensor([[0, w - 1, 5]] * d, dtype=torch.int32)
    cols = torch.tensor([[0, w - 1, 7]] * d, dtype=torch.int32)
    valid, flat_c, flat_r, flat_col = stacked_offsets((n, d, w, w), plane, rows, cols)
    assert valid.all()
    for flat in (flat_c, flat_r, flat_col):
        assert flat.dtype == torch.int64
    for i in range(d):
        for b in range(3):
            p, r, c = int(plane[b]), int(rows[i, b]), int(cols[i, b])
            assert int(flat_c[i, b]) == ((p * d + i) * w + r) * w + c
            assert int(flat_r[i, b]) == (p * d + i) * w + r
            assert int(flat_col[i, b]) == (p * d + i) * w + c
    assert int(flat_c[d - 1, 1]) == n * d * w * w - 1  # the stack's last cell
    # The reference's arithmetic in int32 wraps there.
    wrapped = ((np.int32(n - 1) * np.int32(d) + np.int32(d - 1)) * np.int32(w) + np.int32(w - 1))
    with np.errstate(over="ignore"):
        assert int(wrapped * np.int32(w) + np.int32(w - 1)) != n * d * w * w - 1


def test_stacked_inert_slots_and_planes():
    """Rows outside [0, wr) and planes outside [0, N) add nothing, anywhere."""
    n, d, wr, wc = 3, 2, 8, 8
    state = [torch.zeros(n, d, wr, wc), torch.zeros(n, d, wr), torch.zeros(n, d, wc)]
    plane = torch.tensor([0, 1, 3, -1, 2])
    rows = torch.tensor([[-1, 8, 1, 1, 2], [3, -1, 1, 1, 2]])
    cols = torch.tensor([[1, 1, 1, 1, 3], [2, 2, 1, 1, 3]])
    w = torch.tensor([1.0, 1.0, 1.0, 1.0, 5.0])
    stacked_ingest_ref(*state, plane, rows, cols, w)
    assert float(state[0].sum()) == 1.0 + 10.0
    assert float(state[0][0, 1, 3, 2]) == 1.0 and float(state[0][2, :, 2, 3].sum()) == 10.0
    assert torch.equal(state[1], state[0].sum(dim=3)) and torch.equal(state[2], state[0].sum(dim=2))


def test_fleet_sketch_functional_forms_and_views():
    """The functional twins leave their stack alone and equal the in-place
    forms; a K=1 tenant sketch is a view of the stack, a K=2 one a sum; a
    shard loads back where it came from."""
    from repro_torch.core.hashing import keys_to_tensor
    from repro_torch.fleet import FleetSketch

    rng = np.random.default_rng(6)
    slots = torch.from_numpy(rng.integers(0, 3, 200).astype(np.int32))
    src, dst = (keys_to_tensor(rng.integers(0, 500, 200).astype(np.uint32)) for _ in range(2))
    w = torch.from_numpy(rng.integers(1, 5, 200).astype(np.float32))
    for k in (1, 2):
        st = FleetSketch.empty(port_config(CFG), 3, 0, k)
        steps = [("update", lambda: (slots, src, dst, w)), ("advance", lambda: (1,)), ("clear_tenant", lambda: (2,)),
                 ("load_tenant", lambda: (0, {n: x.clone() for n, x in st.tenant_shard(1).items()}))]
        for name, make_args in steps:
            args = make_args()
            before = [x.clone() for x in (st.counters, st.row_flows, st.col_flows, st.cursor)]
            new = getattr(st, name)(*args)
            assert all(torch.equal(a, b) for a, b in zip(before, (st.counters, st.row_flows, st.col_flows, st.cursor)))
            getattr(st, name + "_")(*args)
            for n in ("counters", "row_flows", "col_flows", "cursor"):
                assert torch.equal(getattr(new, n), getattr(st, n)), (k, name, n)
        assert torch.equal(st.counters[0], st.counters[1]) and float(st.counters[2].abs().sum()) == 0.0
        sk = st.tenant_sketch(1)
        assert torch.equal(sk.counters, st.counters[1].sum(dim=0)) and torch.equal(sk.row_flows, sk.counters.sum(dim=2))
        assert (sk.counters.data_ptr() == st.counters[1, 0].data_ptr()) == (k == 1)


# ---------------------------------------------------------------------------
# The fleet against the reference fleet
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg", [CFG, CFG_UNDIRECTED], ids=["directed", "undirected"])
@pytest.mark.parametrize("window_slices", [None, 3], ids=["K1", "K3"])
def test_fleet_matches_reference_every_family(cfg, window_slices):
    """The port of ``tests/test_fleet.py``'s isolation test against the
    reference fleet itself: an interleaved mixed stream with a delete and a
    window advance; the stack, every tenant's sketch and epoch, all seven
    query families and a standing subscription's ticks, bit for bit."""
    t_count = 4
    rng = np.random.default_rng(0)
    ref = RefFleet.open(cfg, capacity=t_count, seed=SEED, window_slices=window_slices)
    port = port_fleet(cfg, SEED, capacity=t_count, window_slices=window_slices)
    keys, src, dst = np.arange(8, dtype=np.uint32), np.arange(4, dtype=np.uint32), np.arange(4, 8, dtype=np.uint32)
    r_sub = ref.tenant(0).subscribe(QueryBatch([Query.in_flow(keys), Query.reach(src, dst)]), every=2, name="t0")
    p_sub = port.tenant(0).subscribe(PQuery.in_flow(keys), PQuery.reach(src, dst), every=2, name="t0")
    for step in range(6):
        ids = rng.integers(0, t_count, 120)
        src, dst, w = _batch(rng, 120)
        receipts = [f.ingest_mixed(ids, src, dst, w) for f in (ref, port)]
        assert {t: (r.epoch, r.n_edges) for t, r in receipts[1].items()} == {
            t: (r.epoch, r.n_edges) for t, r in receipts[0].items()}
        if step == 2:
            ds, dd, dw = _batch(rng, 8)
            for f in (ref, port):
                f.tenant(1).delete(ds, dd, dw)
        if step == 3:
            for f in (ref, port):
                f.tenant(2).advance_window()
    for name in ("counters", "row_flows", "col_flows", "cursor"):
        np.testing.assert_array_equal(getattr(port._state, name).numpy(), np.asarray(getattr(ref._state, name)))
    for t in range(t_count):
        _assert_same_tenant(port, ref, t)
        for rq, pq in _suite(np.random.default_rng(5)):
            assert_same_value(port.tenant(t).query(pq).value, ref.tenant(t).query(rq).value)
    _assert_same_events(p_sub.poll(), r_sub.poll())
    assert port.summary() == {**ref.summary(), "ingest_edges_per_s": port.summary()["ingest_edges_per_s"]}


def test_fleet_tenants_equal_independent_port_sessions():
    """A port fleet opened with seed s against one port ``GraphStream(seed=s)``
    a tenant, each fed its tenant's sub-stream (the hash families agree by
    construction): counters, registers, epochs, every family and a
    subscription's ticks."""
    t_count = 5
    cfg = port_config(CFG)
    rng = np.random.default_rng(1)
    fleet = SketchFleet.open(cfg, capacity=t_count, seed=SEED, device="cpu")
    sessions = [GraphStream.open(cfg, seed=SEED, device="cpu") for _ in range(t_count)]
    sub_q = [PQuery.edge(np.arange(6, dtype=np.uint32), np.arange(6, 12, dtype=np.uint32)),
             PQuery.reach(np.arange(4, dtype=np.uint32), np.arange(4, 8, dtype=np.uint32))]
    subs = [fleet.tenant(3).subscribe(*sub_q, every=1), sessions[3].subscribe(*sub_q, every=1)]
    for _ in range(5):
        ids = rng.integers(0, t_count, 1500)
        src, dst, w = _batch(rng, 1500)
        fleet.ingest_mixed(ids, src, dst, w)
        for t in range(t_count):
            m = ids == t
            if m.any():
                sessions[t].ingest(src[m], dst[m], w[m])
    for t in range(t_count):
        got, want = fleet.tenant(t).sketch, sessions[t].sketch
        for name in ("counters", "row_flows", "col_flows"):
            assert torch.equal(getattr(got, name), getattr(want, name)), (t, name)
        assert fleet.tenant(t).epoch == sessions[t].epoch
        for _, pq in _suite(np.random.default_rng(t)):
            assert_same_value(fleet.tenant(t).query(pq).value, sessions[t].query(pq).value)
    _assert_same_events(subs[0].poll(), subs[1].poll())


def test_tenant_permutation_leaves_answers_and_counts_unchanged():
    """Permuted tenant ids: every tenant's answers follow it, and the ingest
    dispatches (one a batch) and query dispatches (one a family a call) do
    not depend on which tenants a batch or a query addresses."""
    t_count = 6
    perm = np.random.default_rng(2).permutation(t_count)
    cfg = port_config(CFG)
    fleets = [SketchFleet.open(cfg, capacity=t_count, seed=SEED, device="cpu") for _ in range(2)]
    rng = np.random.default_rng(3)
    for _ in range(4):
        ids = rng.integers(0, t_count, 400)
        src, dst, w = _batch(rng, 400)
        fleets[0].ingest_mixed(ids, src, dst, w)
        fleets[1].ingest_mixed(perm[ids], src, dst, w)
    assert fleets[0]._ingest.dispatches == fleets[1]._ingest.dispatches == 4
    for order in (range(t_count), reversed(range(t_count))):
        before = [f.engine.dispatches.copy() for f in fleets]
        for t in order:
            for _, pq in _suite(np.random.default_rng(9)):
                assert_same_value(fleets[1].tenant(int(perm[t])).query(pq).value, fleets[0].tenant(t).query(pq).value)
        grew = [f.engine.dispatches - b for f, b in zip(fleets, before)]
        assert grew[0] == grew[1] and grew[0]["edge"] == t_count and grew[0]["reach_pre"] == t_count


# ---------------------------------------------------------------------------
# Residency: eviction, fault-in, capacity groups
# ---------------------------------------------------------------------------


def test_eviction_and_fault_in_match_reference(tmp_path):
    """Capacity 2, three tenants: the coldest is evicted to a shard and
    faulted back in, bit-identical to the reference fleet doing the same,
    and the port's shard holds the reference's arrays and metadata."""
    rng = np.random.default_rng(3)
    ref = RefFleet.open(CFG, capacity=2, seed=SEED, checkpoint_dir=str(tmp_path / "ref"))
    port = port_fleet(CFG, SEED, capacity=2, checkpoint_dir=str(tmp_path / "port"))
    batches = {tid: _batch(rng, 64) for tid in ("a", "b", "c")}
    for tid, b in batches.items():
        for f in (ref, port):
            f.tenant(tid).ingest(*b)
    for f in (ref, port):
        assert f.stats.evictions == 1 and "a" not in f.resident_tenants
    ref_shard = next((tmp_path / "ref" / "tenants").iterdir())
    port_shard = tmp_path / "port" / "tenants" / ref_shard.name
    want = np.load(next(ref_shard.iterdir()) / "arrays.npz")
    got = np.load(next(port_shard.iterdir()) / "arrays.npz")
    for key in want.files:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])
    manifest = lambda p: json.loads((next(p.iterdir()) / "manifest.json").read_text())  # noqa: E731
    assert manifest(port_shard)["index"] == manifest(ref_shard)["index"]
    assert manifest(port_shard)["metadata"] == manifest(ref_shard)["metadata"]
    for tid in ("a", "b", "c", "a"):
        _assert_same_tenant(port, ref, tid)
    assert port.stats.fault_ins == ref.stats.fault_ins >= 1
    qs = rng.integers(0, 500, 6).astype(np.uint32)
    assert_same_value(port.tenant("a").query(PQuery.out_flow(qs)).value,
                      ref.tenant("a").query(Query.out_flow(qs)).value)


def test_batch_with_more_tenants_than_capacity_splits_into_groups(tmp_path):
    """One mixed batch over 5 tenants into 2 slots: three groups, three
    dispatches, the reference's receipts and per-tenant state."""
    rng = np.random.default_rng(9)
    ref = RefFleet.open(CFG, capacity=2, seed=SEED, checkpoint_dir=str(tmp_path / "ref"))
    port = port_fleet(CFG, SEED, capacity=2, checkpoint_dir=str(tmp_path / "port"))
    for _ in range(2):
        ids = rng.integers(0, 5, 100)
        src, dst, w = _batch(rng, 100)
        before = port._ingest.dispatches
        got, want = port.ingest_mixed(ids, src, dst, w), ref.ingest_mixed(ids, src, dst, w)
        assert port._ingest.dispatches - before == 3
        assert {t: (r.epoch, r.n_edges) for t, r in got.items()} == {t: (r.epoch, r.n_edges) for t, r in want.items()}
    assert port.resident_tenants == ref.resident_tenants and port.stats.evictions == ref.stats.evictions > 0
    for t in range(5):
        _assert_same_tenant(port, ref, t)


def test_over_capacity_without_checkpoint_dir_raises():
    fleet = SketchFleet.open(port_config(CFG), capacity=1, seed=SEED, device="cpu")
    fleet.tenant("a")
    with pytest.raises(ValueError, match="checkpoint_dir"):
        fleet.tenant("b")
    src = np.arange(4, dtype=np.uint32)
    with pytest.raises(ValueError, match="weights"):
        fleet.ingest_mixed("a", src, src, np.ones(3, np.float32))


# ---------------------------------------------------------------------------
# The closure cache
# ---------------------------------------------------------------------------


def test_evicted_then_readmitted_tenant_gets_fresh_closure(tmp_path):
    """The reference's stale-closure regression on both fleets: A caches a
    closure at epoch 1, B takes A's slot and reaches epoch 1 with other
    edges, A faults back in; every answer and build count equal."""
    rng = np.random.default_rng(4)
    fleets = (RefFleet.open(CFG, capacity=1, seed=SEED, checkpoint_dir=str(tmp_path / "ref")),
              port_fleet(CFG, SEED, capacity=1, checkpoint_dir=str(tmp_path / "port")))
    a_batch, b_batch = _batch(rng, 32), _batch(rng, 32)
    pair = (np.asarray([a_batch[0][0]]), np.asarray([a_batch[1][0]]))
    answers, counts = [], []
    for f, q in zip(fleets, (Query, PQuery)):
        f.tenant("A").ingest(*a_batch)
        out = [f.tenant("A").query(q.reach(*pair)).value]
        count = [f.engine.closure_builds]
        f.tenant("B").ingest(*b_batch)
        count.append(f.tenant("B").epoch)
        out.append(f.tenant("B").query(q.reach(*pair)).value)
        count.append(f.engine.closure_builds)
        out.append(f.tenant("A").query(q.reach(*pair)).value)
        count.append(f.engine.closure_builds)
        answers.append(out)
        counts.append(count)
    assert counts[1] == counts[0] == [1, 1, 2, 3]
    for g, w in zip(answers[1], answers[0]):
        assert_same_value(g, w)


def test_cancel_reach_subscription_drops_slot_closure():
    rng = np.random.default_rng(5)
    fleet = port_fleet(CFG, SEED, capacity=2)
    sess = fleet.tenant("x")
    sub = sess.subscribe(PQuery.reach(np.asarray([1], np.uint32), np.asarray([2], np.uint32)), every=1)
    sess.ingest(*_batch(rng, 16))
    assert sub.ticks == 1 and sess._slot in fleet.engine._closures
    sub.cancel()
    assert sess._slot not in fleet.engine._closures
    sess.query(PQuery.reach(np.asarray([1], np.uint32), np.asarray([2], np.uint32)))
    assert sess._slot in fleet.engine._closures
    slot = sess._slot
    sess.close()
    assert slot not in fleet.engine._closures and fleet.tenants == ()


@pytest.mark.parametrize("batch", [8, 60], ids=["incremental", "rebuild"])
def test_subscription_closure_counts_match_reference(batch):
    """A standing reach on two tenants ticking together: one shared closure
    sync a tick, the reference's count of full builds and incremental
    refreshes (small batches refresh, large ones rebuild), equal events."""
    rng = np.random.default_rng(7)
    ref, port = RefFleet.open(CFG, capacity=4, seed=SEED), port_fleet(CFG, SEED, capacity=4)
    qs, qd = np.arange(4, dtype=np.uint32), np.arange(4, 8, dtype=np.uint32)
    subs = [[f.tenant(t).subscribe(q.reach(qs, qd), q.edge(qs, qd), every=1) for t in ("s", "t")]
            for f, q in ((ref, Query), (port, PQuery))]
    for _ in range(4):
        ids = np.where(rng.random(2 * batch) < 0.5, "s", "t")
        src, dst, w = _batch(rng, 2 * batch)
        for f in (ref, port):
            f.ingest_mixed(ids, src, dst, w)
    assert (port.engine.closure_builds, port.engine.closure_incremental_refreshes) == (
        ref.engine.closure_builds, ref.engine.closure_incremental_refreshes)
    assert port.engine.dispatches["closure"] == ref.engine.dispatches["closure"]
    if batch == 8:
        assert port.engine.closure_builds == 2 and port.engine.closure_incremental_refreshes == 6
    for r_sub, p_sub in zip(*subs):
        _assert_same_events(p_sub.poll(), r_sub.poll())


# ---------------------------------------------------------------------------
# Interchange: WAL lanes, shards and recovery across packages
# ---------------------------------------------------------------------------


def _fleet_batches(n_batches, n_tenants=4, seed=0):
    rng = np.random.default_rng(seed)
    return [
        (rng.integers(0, n_tenants, 30), rng.integers(0, 200, 30).astype(np.uint32),
         rng.integers(0, 200, 30).astype(np.uint32), rng.integers(1, 5, 30).astype(np.float32))
        for _ in range(n_batches)
    ]


def _durable(package, tmp_path, **kw):
    kw = dict(capacity=2, checkpoint_dir=str(tmp_path / "ckpt"), wal_dir=str(tmp_path / "wal"), **kw)
    if package == "ref":
        return RefFleet(CFG, seed=3, **kw)
    return port_fleet(CFG, 3, **kw)


def test_wal_lanes_are_byte_identical(tmp_path):
    """The same stream (with evictions, an advance-free fleet, timestamps)
    through both fleets: every lane's segments and tenant.json, byte for
    byte, and the shards' metadata."""
    fleets = {p: _durable(p, tmp_path / p) for p in ("ref", "port")}
    for ids, s, d, w in _fleet_batches(5):
        for f in fleets.values():
            f.ingest_mixed(ids, s, d, w, timestamps=np.arange(ids.size, dtype=np.float64))
    for f in fleets.values():
        f.tenant(2).ingest([1, 2], [3, 4])
        f.flush()
        for lane in f._wal_lanes.values():
            lane.sync()
    lanes = {p: sorted((tmp_path / p / "wal").iterdir()) for p in fleets}
    assert [x.name for x in lanes["port"]] == [x.name for x in lanes["ref"]] and len(lanes["ref"]) == 4
    for got, want in zip(lanes["port"], lanes["ref"]):
        files = sorted(p.name for p in want.iterdir())
        assert sorted(p.name for p in got.iterdir()) == files
        for name in files:
            assert (got / name).read_bytes() == (want / name).read_bytes(), (got.name, name)
    for shard in (tmp_path / "ref" / "ckpt" / "tenants").iterdir():
        mine = tmp_path / "port" / "ckpt" / "tenants" / shard.name
        meta = [json.loads((next(x.iterdir()) / "manifest.json").read_text())["metadata"] for x in (mine, shard)]
        assert meta[0] == meta[1]


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref"), ("port", "port")])
def test_recover_reproduces_the_fleet_across_packages(tmp_path, writer, reader):
    """The port of ``tests/test_eventtime.py``'s lane recovery: capacity 2
    for 4 tenants (evictions and lane GC mid-stream), a crash after 4
    batches, ``recover()`` by the other package from the shards and lanes
    on disk, 2 more batches; every tenant equals an uninterrupted fleet."""
    batches = _fleet_batches(6)
    oracle = RefFleet(CFG, capacity=4, seed=3)
    for ids, s, d, w in batches:
        oracle.ingest_mixed(ids, s, d, w)
    first = _durable(writer, tmp_path)
    for ids, s, d, w in batches[:4]:
        first.ingest_mixed(ids, s, d, w)
    first.flush()
    assert first.stats.evictions > 0
    del first  # crash
    second = _durable(reader, tmp_path)
    reports = second.recover()
    assert set(reports) == set(range(4))
    for ids, s, d, w in batches[4:]:
        second.ingest_mixed(ids, s, d, w)
    second.flush()
    for t in range(4):
        np.testing.assert_array_equal(np.asarray(second.tenant(t).sketch.counters),
                                      np.asarray(oracle.tenant(t).sketch.counters), err_msg=f"t={t}")
        assert second.tenant(t).epoch == oracle.tenant(t).epoch


def test_close_retires_the_lane_and_receipts_carry_wal_seqs(tmp_path):
    fleet = _durable("port", tmp_path)
    r = fleet.tenant("x").ingest([1, 2], [3, 4], timestamps=[1.0, 2.0])
    assert r.wal_seq is not None
    fleet.tenant("a").ingest([1, 2], [3, 4])
    fleet.tenant("a").close()
    assert set(_durable("ref", tmp_path).recover()) == {"x"}


# ---------------------------------------------------------------------------
# The server and the serve entry point
# ---------------------------------------------------------------------------


def test_serve_cli_tenants_matches_reference(monkeypatch, capsys):
    """``python -m repro_torch.launch.serve --device cpu --tenants 8`` against
    the reference's ``--tenants 8`` run on the same family: equal
    subscription events, equal per-tenant counters, equal summary fields
    other than times and compile counts."""
    argv = ["--depth", "3", "--width", "128", "--nodes", "2000", "--edges", "12000", "--batch", "2000",
            "--every", "2", "--tenants", "8"]
    opened = []

    class Capture:
        @staticmethod
        def open(cfg, **kwargs):
            opened.append(RefFleet.open(cfg, **kwargs))
            return opened[-1]

    def on_reference_family(cfg, capacity, window_slices, wal_dir, device, **kwargs):
        assert cfg == port_config(CLI_CFG) and device == "cpu" and capacity == 8
        return port_fleet(CLI_CFG, 0, capacity=capacity, window_slices=window_slices, wal_dir=wal_dir, **kwargs)

    with monkeypatch.context() as m:
        m.setattr(ref_fleet_pkg, "SketchFleet", Capture)
        m.setattr("sys.argv", ["serve", *argv])
        ref_serve.main()
    with monkeypatch.context() as m:
        m.setattr(serve, "SketchFleet", SimpleNamespace(open=on_reference_family))
        fleet, subs = serve.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "[serve-fleet] ingest compiles=1" in out and "[serve-fleet] ingest launches=0" in out
    ref = opened[0]
    for t in range(8):
        _assert_same_tenant(fleet, ref, t)
    for t, sub in enumerate(subs):
        _assert_same_events(sub.poll(), ref._sessions[t].subscriptions[0].poll())
    got, want = fleet.summary(), ref.summary()
    assert {k: v for k, v in got.items() if k != "ingest_edges_per_s"} == {
        k: v for k, v in want.items() if k != "ingest_edges_per_s"}
    assert got["subscription_ticks"] == 9 and got["ingest_dispatches"] == 6


def test_serve_cli_tenants_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--tenants", "2", "--width", "64", "--edges", "10", "--batch", "10"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SketchServer(port_config(CFG), tenants=2)
