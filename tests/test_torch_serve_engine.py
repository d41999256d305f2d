"""Parity of the port's serving engine with the reference's.

``tests/test_serve_engine.py``'s six cases run on the port's
``SketchServer`` and on the reference's, whose sessions share one hash
family (the port server's session is opened on the reference's sketch), and
every answer must agree (integer weights: bit for bit); so does the fleet
mode (``tenants=N``).  The serve entry
point with the durable, windowed event-time flags (``--window-slices``,
``--slice-width``, ``--max-lateness``, ``--wal-dir``) must give the
reference entry point's transcript, window, watermark and counts at a small
size, and its WAL must replay into the same state."""
from types import SimpleNamespace

import numpy as np
import pytest

from repro.api import GraphStream as RefStream
from repro.core.sketch import SketchConfig as RefConfig
from repro.launch import serve as ref_serve
from repro.serve.engine import SketchServer as RefServer
from repro_torch.launch import serve
from repro_torch.serve.engine import SketchServer

from _torch_parity import assert_same_value, head_relative, port_config, port_fleet, port_session

CFG = RefConfig(depth=3, width_rows=128, width_cols=128)


def _servers(**kw):
    """A reference server and a port server on the CPU sharing its family."""
    ref = RefServer(CFG, **kw)
    port = SketchServer(port_config(CFG), device="cpu", **kw)
    assert port.stream.config == port_config(CFG) and port.stream.device.type == "cpu"
    port.stream = port_session(CFG, **kw)
    return ref, port


@pytest.fixture()
def servers():
    return _servers()


def test_ingest_and_edge_query(servers):
    ref, port = servers
    rng = np.random.default_rng(0)
    src = rng.integers(0, 1000, 500).astype(np.uint32)
    dst = rng.integers(0, 1000, 500).astype(np.uint32)
    for server in servers:
        server.ingest(src, dst)
    est = port.edge_frequency(src[:50], dst[:50])
    assert np.all(est >= 1) and port.stats.edges_ingested == 500
    np.testing.assert_array_equal(est, ref.edge_frequency(src[:50], dst[:50]))


def test_closure_cache_invalidation(servers):
    ref, port = servers
    one, two, three, four = (np.array([k], np.uint32) for k in (1, 2, 3, 4))
    counts = []
    for server in servers:
        server.ingest(np.array([1, 2], np.uint32), np.array([2, 3], np.uint32))
        assert bool(server.reachable(one, three)[0])
        server.reachable(two, three)  # cached closure, no refresh
        server.ingest(three, four)    # additions only: an incremental refresh
        assert bool(server.reachable(one, four)[0])
        counts.append((server.stats.closure_refreshes, server.stats.closure_incremental_refreshes))
    assert counts[0] == counts[1] == (1, 1)


def test_windowed_server_expiry():
    ref, port = _servers(window_slices=2)
    k10, k20 = np.array([10], np.uint32), np.array([20], np.uint32)
    for server in (ref, port):
        server.ingest(k10, k20)
        assert server.edge_frequency(k10, k20)[0] == 1
        server.advance_window()
        server.advance_window()  # wraps: the slice holding (10, 20) is zeroed
        assert server.edge_frequency(k10, k20)[0] == 0
    for got, want in zip(head_relative(port.stream), head_relative(ref.stream)):
        np.testing.assert_array_equal(got, want)


def test_heavy_hitter_monitor(servers):
    ref, port = servers
    rng = np.random.default_rng(1)
    src = rng.integers(0, 100, 2000).astype(np.uint32)
    dst = np.full(2000, 7, np.uint32)  # flood node 7: 100% of in-flow
    for server in servers:
        server.ingest(src, dst)
    flags = port.heavy_hitters(np.arange(10, dtype=np.uint32), theta=0.5)
    assert flags[7] and not flags[3]
    np.testing.assert_array_equal(flags, ref.heavy_hitters(np.arange(10, dtype=np.uint32), theta=0.5))
    assert port.monitor(src[:5], dst[:5], None, 7, 0.5) == ref.monitor(src[:5], dst[:5], None, 7, 0.5)


def test_server_standing_subscription(servers):
    ref, port = servers
    subs = [s.subscribe(s.Query.in_flow(np.arange(8, dtype=np.uint32)), every=2, name="svc") for s in servers]
    rng = np.random.default_rng(2)
    for _ in range(4):
        src = rng.integers(0, 100, 50).astype(np.uint32)
        dst = rng.integers(0, 100, 50).astype(np.uint32)
        for server in servers:
            server.ingest(src, dst)
    got, want = subs[1].poll(), subs[0].poll()
    assert subs[1].ticks == 2 and len(got) == 2 and got[-1].epoch == port.stream.epoch
    for g, w in zip(got, want):
        assert (g.tick, g.epoch) == (w.tick, w.epoch)
        assert_same_value(g.results[0].value, w.results[0].value)
    assert len(list(port.events())) == 2  # the session-wide feed, drained apart
    assert len(list(port.events())) == 0
    subs[1].cancel()


def test_subgraph_weight(servers):
    ref, port = servers
    for server in servers:
        server.ingest(np.array([1, 2], np.uint32), np.array([2, 3], np.uint32))
    for keys in (([1, 2], [2, 3]), ([1, 5], [2, 6])):
        s, d = (np.array(k, np.uint32) for k in keys)
        assert port.subgraph_weight(s, d) == ref.subgraph_weight(s, d)
    assert port.subgraph_weight(np.array([1, 2], np.uint32), np.array([2, 3], np.uint32)) >= 2.0


def test_fleet_mode_matches_reference():
    """``tests/test_fleet.py``'s server case on both servers (the port's fleet
    on the reference's family): ``ingest_mixed``, a routed ``ingest``, every
    per-family endpoint with ``tenant=``, a tenant subscription, the fleet
    feed, and the refusals of each mode."""
    ref = RefServer(CFG, seed=8, tenants=4)
    port = SketchServer(port_config(CFG), seed=8, tenants=4, device="cpu")
    assert port.stream is None and port.fleet.device.type == "cpu" and port.fleet.capacity == 4
    port.fleet = port_fleet(CFG, 8, capacity=4)
    rng = np.random.default_rng(8)
    src, dst = rng.integers(0, 500, 128).astype(np.uint32), rng.integers(0, 500, 128).astype(np.uint32)
    w = rng.integers(1, 4, 128).astype(np.float32)
    ids = rng.integers(0, 4, 128)
    subs = [s.subscribe(s.Query.in_flow(src[:8]), tenant=1, every=1, name="t1") for s in (ref, port)]
    for server in (ref, port):
        server.ingest_mixed(ids, src, dst, w)
        server.ingest(src[:8], dst[:8], w[:8], tenant=2)
    qs, qd = rng.integers(0, 500, 5).astype(np.uint32), rng.integers(0, 500, 5).astype(np.uint32)
    for t in range(4):
        for call in ("edge_frequency", "reachable"):
            np.testing.assert_array_equal(getattr(port, call)(qs, qd, tenant=t), getattr(ref, call)(qs, qd, tenant=t))
        for call in ("in_flow", "out_flow"):
            np.testing.assert_array_equal(getattr(port, call)(qs, tenant=t), getattr(ref, call)(qs, tenant=t))
        np.testing.assert_array_equal(port.heavy_hitters(qs, 0.1, tenant=t), ref.heavy_hitters(qs, 0.1, tenant=t))
        assert port.subgraph_weight(qs[:2], qd[:2], tenant=t) == ref.subgraph_weight(qs[:2], qd[:2], tenant=t)
    got, want = subs[1].poll(), subs[0].poll()
    assert [(e.tick, e.epoch) for e in got] == [(e.tick, e.epoch) for e in want] == [(1, 1)]
    assert_same_value(got[0].results[0].value, want[0].results[0].value)
    assert len(list(port.events())) == len(list(ref.events())) == 1
    assert port.summary()["edges_ingested"] == ref.summary()["edges_ingested"] == 136
    assert port.tenant(2).epoch == ref.tenant(2).epoch == 2
    with pytest.raises(ValueError, match="fleet mode"):
        port.in_flow(qs)
    with pytest.raises(ValueError, match="single-session"):
        port.monitor(src, dst, None, 7, 0.5)
    with pytest.raises(ValueError, match="single-session only"):
        SketchServer(port_config(CFG), tenants=2, slice_width=1.0, device="cpu")
    with pytest.raises(ValueError, match="fleet"):
        SketchServer(port_config(CFG), device="cpu").edge_frequency([1], [2], tenant=3)


# -- the serve entry point with the durable, windowed event-time flags ---------

SMALL = ["--depth", "3", "--width", "128", "--nodes", "2000", "--edges", "12000", "--batch", "2000",
         "--every", "2"]
EVENT_TIME = ["--window-slices", "4", "--slice-width", "1.0", "--max-lateness", "1.0"]


def _ref_run(monkeypatch, argv):
    """The reference entry point's session (opened by its ``main``)."""
    opened = []

    def capture(cfg, query_backend, **kwargs):
        opened.append(RefStream.open(cfg, query_backend="jnp", **kwargs))
        return opened[-1]

    with monkeypatch.context() as m:
        m.setattr(ref_serve, "GraphStream", SimpleNamespace(open=capture))
        m.setattr("sys.argv", ["serve", *argv])
        ref_serve.main()
    return opened[0]


def _port_run(monkeypatch, argv):
    """The port entry point's run, its session opened on the reference's
    window (the same hash family)."""
    def on_reference_family(cfg, device, **kwargs):
        assert cfg == port_config(CFG) and device == "cpu"
        return port_session(CFG, **kwargs)

    with monkeypatch.context() as m:
        m.setattr(serve, "GraphStream", SimpleNamespace(open=on_reference_family))
        return serve.main(argv + ["--device", "cpu"])


def test_serve_cli_event_time_flags_match_reference(monkeypatch, tmp_path, capsys):
    ref = _ref_run(monkeypatch, SMALL + EVENT_TIME + ["--wal-dir", str(tmp_path / "ref")])
    stream, sub, events = _port_run(monkeypatch, SMALL + EVENT_TIME + ["--wal-dir", str(tmp_path / "port")])
    out = capsys.readouterr().out
    assert "auto_advances=" in out and "watermark=" in out
    want = list(ref.events())
    assert [(e.tick, e.epoch) for e in events] == [(e.tick, e.epoch) for e in want] and len(events) > 0
    for g, w in zip(events, want):
        for rg, rw in zip(g.results, w.results):
            assert_same_value(rg.value, rw.value)
    for got, exp in zip(head_relative(stream), head_relative(ref)):
        np.testing.assert_array_equal(got, exp)
    for key in ("edges_ingested", "subscription_ticks", "auto_advances", "watermark", "late_dropped",
                "late_retracted", "closure_refreshes", "closure_incremental_refreshes"):
        assert stream.summary()[key] == ref.summary()[key], key
    assert stream.stats.auto_advances > 0 and stream.wal_seq == ref.wal_seq
    # Both logs hold the same records, and the port's replays into the same window.
    segs = sorted((tmp_path / "port").glob("wal-*.seg"))
    assert [p.read_bytes() for p in segs] == [p.read_bytes() for p in sorted((tmp_path / "ref").glob("wal-*.seg"))]
    again = port_session(CFG, window_slices=4, slice_width=1.0, max_lateness=1.0, wal_dir=str(tmp_path / "port"))
    report = again.recover()
    assert report.step is None and report.mutations_replayed == 6
    for got, exp in zip(head_relative(again), head_relative(stream)):
        np.testing.assert_array_equal(got, exp)
