"""A mesh session of the port (``GraphStream.open(mesh=...)``) against the
reference's LOCAL session, which is what the reference's own mesh session
must equal (``tests/test_api.py::test_graphstream_mesh_matches_local``) and
what runs on this host's jax.

Four gloo ranks on a (2, 2) ``("data", "model")`` mesh open the session on
the reference session's hash family and take the same batches: odd lengths,
batches the host pre-aggregates (at least 1,024 edges), and small ones
whose touched rows let reach refresh incrementally.  A standing query batch
(edge, in/out flow, heavy, subgraph, reach) ticks after every batch.
Integer weights: receipts, the transcript, the answers, the closure's full
and incremental refresh counts and the summary are identical.  Checkpoints
move both ways: the mesh session's restores in a reference local session,
the reference's in a mesh session.  The refusals match the reference's.
"""
import numpy as np
import pytest

from repro.api import GraphStream as RefStream, Query as RefQuery, QueryBatch as RefBatch
from repro.core.sketch import SketchConfig as RefConfig

import _torch_dist
from repro_torch.api import GraphStream

CASES = {
    "directed": (RefConfig(depth=3, width_rows=64, width_cols=64), 0),
    "nonsquare": (RefConfig(depth=3, width_rows=64, width_cols=48), 1),
    "undirected": (RefConfig(depth=3, width_rows=64, width_cols=64, directed=False), 2),
}


def _batches(rng):
    """A pre-aggregated batch, two small ones (few touched rows: the closure
    refreshes incrementally), an odd pre-aggregated batch and an odd small
    one; integer weights."""
    out = []
    for n, nodes in ((1200, 400), (5, 4), (7, 6), (1501, 400), (257, 400)):
        src = rng.integers(0, nodes, n).astype(np.uint32)
        dst = rng.integers(0, 400, n).astype(np.uint32)
        out.append((src, dst, rng.integers(1, 5, n).astype(np.float32)))
    return out


def _ref_batch(u, v, reach):
    """The standing batch (``tests/_torch_dist.py::mesh_session`` builds the
    port's); reach needs a square sketch."""
    q = RefQuery
    return RefBatch([
        q.edge(u, v), q.in_flow(u[:16]), q.out_flow(u[:16]), q.heavy(u[:8], theta=0.05),
        q.subgraph(u[:3], v[:3]), q.subgraph(u[3:8], v[3:8]), *([q.reach(u[:12], v[:12])] if reach else []),
    ])


def _values(results):
    return [tuple(np.asarray(x) for x in r.value) if isinstance(r.value, tuple) else np.asarray(r.value)
            for r in results]


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, tuple):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_array_equal(g, w)
            assert np.asarray(g).dtype == np.asarray(w).dtype


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """The reference's local sessions (in this process) and the port's mesh
    sessions (four spawned ranks) on the same cases."""
    tmp = tmp_path_factory.mktemp("mesh-session")
    refs, paths = {}, []
    for tag, (cfg, seed) in CASES.items():
        rng = np.random.default_rng(seed)
        batches = _batches(rng)
        u = np.concatenate([batches[0][0][:20], rng.integers(0, 400, 12).astype(np.uint32)])
        v = np.concatenate([batches[0][1][:20], rng.integers(0, 400, 12).astype(np.uint32)])
        ref = RefStream.open(cfg, seed=seed, query_backend="jnp", ingest_backend="scatter",
                             checkpoint_dir=str(tmp / f"ref-{tag}"))
        empty = ref.sketch  # its leaves are read now: ingest donates the live buffers
        coefs = {"row_a": np.asarray(empty.row_hash.a), "row_b": np.asarray(empty.row_hash.b)}
        if not cfg.is_square:
            coefs["col_a"], coefs["col_b"] = np.asarray(empty.col_hash.a), np.asarray(empty.col_hash.b)
        sub = ref.subscribe(_ref_batch(u, v, cfg.is_square), every=1, name="standing")
        receipts = [ref.ingest(*b) for b in batches]
        events = sub.poll()
        results = ref.query(_ref_batch(u, v, cfg.is_square))
        ref.checkpoint()
        refs[tag] = dict(ref=ref, receipts=receipts, events=events, results=results, u=u, v=v)
        arrays = {"shape": np.asarray([cfg.depth, cfg.width_rows, cfg.width_cols]),
                  "directed": np.asarray(cfg.directed), "n_batches": np.asarray(len(batches)),
                  "q/u": u, "q/v": v, "ref_ckpt": np.asarray(str(tmp / f"ref-{tag}")), **coefs}
        for i, (s, d, w) in enumerate(batches):
            arrays[f"b{i}/src"], arrays[f"b{i}/dst"], arrays[f"b{i}/w"] = s, d, w
        np.savez(tmp / f"{tag}.npz", **arrays)
        paths.append(str(tmp / f"{tag}.npz"))
    ranks = _torch_dist.run_ranks(_torch_dist.mesh_session, 4, tmp, timeout=120, mesh_shape=(2, 2), cases=paths)
    return refs, ranks, tmp


@pytest.mark.parametrize("tag", list(CASES))
def test_mesh_session_matches_reference_local_session(mesh_run, tag):
    """Receipts, the 5-tick transcript, the query batch and the summary of
    every rank equal the reference's local session's."""
    refs, ranks, _ = mesh_run
    want = refs[tag]
    ref = want["ref"]
    for res in ranks:
        got_receipts = res[f"{tag}/receipts"]
        assert [r[:2] for r in got_receipts] == [(r.epoch, r.n_edges) for r in want["receipts"]]
        for (_, _, keys), r in zip(got_receipts, want["receipts"]):
            assert (keys is None) == (r.touched_keys is None)
            if keys is not None:
                np.testing.assert_array_equal(keys, np.asarray(r.touched_keys))
        events = res[f"{tag}/events"]
        assert [(t, e) for t, e, _ in events] == [(ev.tick, ev.epoch) for ev in want["events"]]
        for (_, _, values), ev in zip(events, want["events"]):
            _same(values, _values(ev.results))
        _same(res[f"{tag}/results"], _values(want["results"]))
        counters, rows, cols = res[f"{tag}/sketch"]
        sk = ref.sketch
        np.testing.assert_array_equal(counters, np.asarray(sk.counters))
        np.testing.assert_array_equal(rows, np.asarray(sk.row_flows))
        np.testing.assert_array_equal(cols, np.asarray(sk.col_flows))
        assert res[f"{tag}/shard_rows"] == ref.config.width_rows // 2
    assert len(want["events"]) == 5


@pytest.mark.parametrize("tag", ["directed", "undirected"])
def test_mesh_session_reach_refreshes_as_the_local_session(mesh_run, tag):
    """Reach on the gathered counters: the same full builds and incremental
    refreshes as the local session (small batches refresh incrementally)."""
    refs, ranks, _ = mesh_run
    ref = refs[tag]["ref"]
    want = (ref.stats.closure_refreshes, ref.stats.closure_incremental_refreshes)
    assert want[1] >= 2 and want[0] >= 1
    for res in ranks:
        assert res[f"{tag}/refreshes"] == want


@pytest.mark.parametrize("tag", list(CASES))
def test_mesh_checkpoints_move_to_and_from_local_sessions(mesh_run, tag):
    """The mesh session's checkpoint (written once, by rank 0) restores in a
    reference local session; the reference's restores in a mesh session,
    whose answers are then the reference's."""
    refs, ranks, tmp = mesh_run
    want = refs[tag]
    ref = want["ref"]
    cfg, seed = CASES[tag]
    back = RefStream.open(cfg, seed=seed, query_backend="jnp",
                          checkpoint_dir=str(tmp / "ranks-mesh_session" / f"ckpt-{tag}"))
    assert back.restore() == ranks[0][f"{tag}/step"] == ref.epoch
    for f in ("counters", "row_flows", "col_flows"):
        np.testing.assert_array_equal(np.asarray(getattr(back.sketch, f)), np.asarray(getattr(ref.sketch, f)))
    _same(_values(back.query(_ref_batch(want["u"], want["v"], cfg.is_square))), _values(want["results"]))
    for res in ranks:
        assert res[f"{tag}/ref_restored_step"] == ref.epoch
        for got, f in zip(res[f"{tag}/ref_restored"], ("counters", "row_flows", "col_flows")):
            np.testing.assert_array_equal(got, np.asarray(getattr(ref.sketch, f)))
        _same(res[f"{tag}/ref_restored_results"], _values(want["results"]))


def test_mesh_session_refusals_match_the_reference(mesh_run):
    """Mesh + window and mesh + fused raise the reference's ValueErrors word
    for word; a WAL, recover() and merge() with a local session, which the
    reference accepts on a mesh session, succeed
    (``tests/test_torch_distributed_durable.py`` holds them to it)."""
    _, ranks, _ = mesh_run
    small = RefConfig(depth=2, width_rows=32, width_cols=32)
    with pytest.raises(ValueError) as window:
        RefStream.open(small, mesh=object(), window_slices=4)
    with pytest.raises(ValueError) as fused:
        RefStream.open(small, ingest_backend="fused", window_slices=2)
    for res in ranks:
        kinds = res["refusals"]
        assert kinds[0] == ("ValueError", str(window.value))
        assert kinds[1] == ("ValueError", str(fused.value))
        assert kinds[2:] == [("none", "")] * 3
    with pytest.raises(TypeError, match="Mesh"):
        GraphStream.open("smoke", device="cpu", mesh=object())

