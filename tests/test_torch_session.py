"""End-to-end parity of a port session with a reference session.

The port's ``GraphStream`` is opened on the reference session's converted
sketch (``repro_torch.convert``), so both hash identically; then the same
batches go through both.  Integer weights: QueryResults, receipts and the
subscription transcript (epoch, tick, values, alarm) must be identical;
the float-weighted ``examples/ddos_monitor.py`` scenario must alarm on the
same tick with in-flows equal to ``rtol=1e-6, atol=1e-5``."""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from repro.api import Query as RefQuery, SketchConfig as RefConfig
from repro_torch.api import GraphStream, Query, QueryBatch
from repro_torch.launch import serve

from _torch_parity import assert_same_sketch, assert_same_value, open_pair, port_config, to_port

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _workload(mod, rng, n_nodes):
    u = rng.integers(0, n_nodes, 96).astype(np.uint32)
    v = rng.integers(0, n_nodes, 96).astype(np.uint32)
    return [
        mod.Query.edge(u, v),
        mod.Query.in_flow(u[:32]),
        mod.Query.out_flow(int(u[0])),
        mod.Query.flow(u[:8]),
        mod.Query.heavy(u[:16], theta=0.01),
        mod.Query.reach(u[:24], v[:24]),
        mod.Query.subgraph(u[:3], v[:3]),
        mod.Query.edge(int(u[1]), int(v[1])),
        mod.Query.subgraph(u[3:8], v[3:8]),
    ]


class _RefMod:
    Query = RefQuery


class _PortMod:
    Query = Query


def _assert_same_results(got, want, exact=True):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.family == w.family and g.query.scalar == w.query.scalar
        assert (g.error.epsilon, g.error.delta, g.error.side) == (w.error.epsilon, w.error.delta, w.error.side)
        assert_same_value(g.value, w.value, exact)


def _assert_same_events(got, want, exact=True):
    assert [(e.tick, e.epoch, e.alarm, e.name) for e in got] == [
        (e.tick, e.epoch, e.alarm, e.name) for e in want
    ]
    for g, w in zip(got, want):
        _assert_same_results(g.results, w.results, exact)


@pytest.mark.parametrize(
    "cfg,n_nodes",
    [
        (RefConfig(depth=3, width_rows=256, width_cols=256), 400),
        (RefConfig(depth=3, width_rows=256, width_cols=256, directed=False), 400),
        (RefConfig(depth=4, width_rows=1024, width_cols=1024), 150),
    ],
    ids=["smoke", "smoke-undirected", "w1024"],
)
def test_session_transcript_and_results_match_reference(cfg, n_nodes):
    ref, port = open_pair(cfg, seed=3)
    rng = np.random.default_rng(cfg.width_rows)
    wl_rng = np.random.default_rng(7)
    ref_sub = ref.subscribe(*_workload(_RefMod, wl_rng, n_nodes), every=2, name="w",
                            alarm=lambda rs: bool(np.any(rs[4].value[0])))
    wl_rng = np.random.default_rng(7)
    port_sub = port.subscribe(*_workload(_PortMod, wl_rng, n_nodes), every=2, name="w",
                              alarm=lambda rs: bool(np.any(rs[4].value[0])))
    for i, n in enumerate([3000, 40, 2500, 1500, 60, 2000]):
        src = rng.integers(0, n_nodes, n).astype(np.uint32)
        dst = rng.integers(0, n_nodes, n).astype(np.uint32)
        w = rng.integers(1, 5, n).astype(np.float32)
        if i == 3:
            a, b = ref.delete(src[:50], dst[:50]), port.delete(src[:50], dst[:50])
        else:
            a, b = ref.ingest(src, dst, w), port.ingest(src, dst, w)
        assert (a.epoch, a.n_edges) == (b.epoch, b.n_edges)
        assert (a.touched_keys is None) == (b.touched_keys is None)
        if a.touched_keys is not None:
            np.testing.assert_array_equal(b.touched_keys, a.touched_keys)
    _assert_same_events(port_sub.poll(), ref_sub.poll())
    _assert_same_events(list(port.events()), list(ref.events()))
    wl_ref, wl_port = _workload(_RefMod, np.random.default_rng(8), n_nodes), _workload(
        _PortMod, np.random.default_rng(8), n_nodes)
    _assert_same_results(port.query(QueryBatch(wl_port)), ref.query(*wl_ref))
    assert_same_sketch(port.sketch, ref.sketch)
    assert (port.engine.closure_refreshes, port.engine.closure_incremental_refreshes) == (
        ref.engine.closure_refreshes, ref.engine.closure_incremental_refreshes)
    rs, ps = ref.summary(), port.summary()
    for key in ("edges_ingested", "queries_served", "closure_refreshes",
                "closure_incremental_refreshes", "subscription_ticks", "events_dropped"):
        assert ps[key] == rs[key], key


def _load_ddos():
    spec = importlib.util.spec_from_file_location("ddos_monitor", ROOT / "examples" / "ddos_monitor.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ddos_monitor_alarms_on_the_same_tick():
    ddos = _load_ddos()
    ref, ref_sub = ddos._open()
    port = GraphStream.open(sketch=to_port(ref.sketch), device="cpu")
    port_sub = port.subscribe(
        Query.heavy(ddos.TARGET, ddos.THETA),
        Query.in_flow(ddos.TARGET),
        every=1,
        alarm=lambda results: bool(np.asarray(results[0].value[0])),
        name="ddos-watch",
    )
    alarms = {"ref": None, "port": None}
    for t, (src, dst, nbytes) in enumerate(ddos._make_batches(ddos.N_BATCHES)):
        for key, gs, sub in (("ref", ref, ref_sub), ("port", port, port_sub)):
            gs.ingest(src, dst, nbytes)
            (event,) = sub.poll()
            if event.alarm and alarms[key] is None:
                alarms[key] = t
        got, want = port_sub.last_event, ref_sub.last_event
        assert (got.tick, got.alarm) == (want.tick, want.alarm)
        _assert_same_results(got.results, want.results, exact=False)
    assert alarms["port"] == alarms["ref"] is not None and alarms["ref"] >= ddos.ATTACK_AT
    assert_same_sketch(port.sketch, ref.sketch, exact=False)


def test_merge_string_labels_and_monitor_match_reference():
    cfg = RefConfig(depth=3, width_rows=64, width_cols=64)
    ra, pa = open_pair(cfg, seed=5)
    rb, pb = open_pair(cfg, seed=5)
    src = ["alice", "bob", "carol", "alice", "dave"]
    dst = ["bob", "carol", "alice", "bob", "alice"]
    for gs in (ra, pa):
        gs.ingest(src, dst)
    for gs in (rb, pb):
        gs.ingest(dst, src, [2, 2, 2, 2, 2])
    ra.merge(rb)
    pa.merge(pb)
    assert_same_sketch(pa.sketch, ra.sketch)
    assert pa.epoch == ra.epoch and pa.stats.edges_ingested == ra.stats.edges_ingested
    np.testing.assert_array_equal(pa.reachable("alice", "dave"), ra.reachable("alice", "dave"))
    np.testing.assert_array_equal(pa.edge_frequency(src, dst), ra.edge_frequency(src, dst))
    np.testing.assert_array_equal(pa.in_flow(src), ra.in_flow(src))
    np.testing.assert_array_equal(pa.out_flow(src), ra.out_flow(src))
    np.testing.assert_array_equal(pa.heavy_hitters(src, 0.2), ra.heavy_hitters(src, 0.2))
    assert pa.subgraph_weight(src[:2], dst[:2]) == ra.subgraph_weight(src[:2], dst[:2])
    for _ in range(3):
        assert pa.monitor(src, ["alice"] * 5, None, "alice", 0.3) == ra.monitor(
            src, ["alice"] * 5, None, "alice", 0.3)
    with pytest.raises(ValueError, match="hash families"):
        pa.merge(GraphStream.open(port_config(cfg), seed=6, device="cpu"))


def test_sketch_property_is_a_snapshot():
    gs = GraphStream.open("smoke", device="cpu")
    gs.ingest([1, 2], [2, 3])
    snap = gs.sketch
    gs.ingest([1, 2], [2, 3])
    assert float(snap.counters.sum()) == 2 * 3 and float(gs.sketch.counters.sum()) == 4 * 3
    assert snap.counters.data_ptr() != gs._live().counters.data_ptr()
    # Opening on a sketch takes a private copy too.
    other = GraphStream.open(sketch=snap)
    other.ingest([5], [6])
    assert float(snap.counters.sum()) == 6.0


def test_open_presets_and_unported_options_raise():
    assert GraphStream.open("smoke", device="cpu").config.width_rows == 256
    gs = GraphStream.open(epsilon=0.01, delta=0.05, device="cpu")
    assert gs.config == port_config(RefConfig.for_error(0.01, 0.05))
    with pytest.raises(ValueError):
        GraphStream.open("nope", device="cpu")
    with pytest.raises(ValueError):
        GraphStream.open()
    # The distributed plane is ported (tests/test_torch_distributed_session.py):
    # a mesh must be a repro_torch Mesh.
    with pytest.raises(TypeError, match="Mesh"):
        GraphStream.open("smoke", device="cpu", mesh=object())
    with pytest.raises(ValueError, match="windowed"):
        GraphStream.open("smoke", device="cpu", mesh=object(), window_slices=4)
    # The fused session mode is ported: it opens and keeps its mode name.
    assert GraphStream.open("smoke", device="cpu", ingest_backend="fused").ingest_backend == "fused"
    assert GraphStream.open("smoke", device="cpu", window_slices=4)._window.n_slices == 4
    # Durability is ported: without its directory each method says which.
    for method, option in (("checkpoint", "checkpoint_dir"), ("restore", "checkpoint_dir"), ("recover", "wal_dir")):
        with pytest.raises(ValueError, match=option):
            getattr(gs, method)()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            GraphStream.open("smoke")


def test_serve_runs_on_cpu_and_refuses_unported_modes(capsys):
    argv = ["--device", "cpu", "--nodes", "500", "--edges", "6000", "--batch", "1500",
            "--width", "128", "--depth", "3", "--every", "2"]
    stream, sub, events = serve.main(argv)
    out = capsys.readouterr().out
    assert "[serve] edges_ingested=6,000.0" in out and "2 ticks" in out
    assert [e.tick for e in events] == [1, 2] and stream.engine.closure_refreshes >= 1
    plain, _, plain_events = serve.main(argv + ["--ingest-backend", "scatter", "--query-backend", "torch"])
    assert torch.equal(plain._live().counters, stream._live().counters)
    _assert_same_events(plain_events, events)
    # --tenants runs the fleet (ported), on the same traffic.
    fleet, subs = serve.main(argv + ["--tenants", "4"])
    assert "[serve-fleet] edges_ingested=6,000.0" in capsys.readouterr().out
    assert fleet.capacity == 4 and len(fleet.tenants) == 4 and [s.ticks for s in subs] == [2, 2, 2]
    # --slice-width without --window-slices is refused as in the reference.
    with pytest.raises(ValueError, match="window_slices"):
        serve.main(argv + ["--slice-width", "1"])
    windowed, _, windowed_events = serve.main(argv + ["--window-slices", "2"])
    assert windowed._window.n_slices == 2 and len(windowed_events) == 2
