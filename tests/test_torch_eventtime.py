"""Parity of the port's event-time and durability plane with the reference.

The cases of ``tests/test_eventtime.py`` (all but the fleet's) run on the
port: watermarks, the write-ahead log, event-time routing with its drop and
retract policies, per-source hold-back, exactly-once recovery at every crash
point, checkpoint GC of WAL segments, corrupt-latest fallback and
``read_metadata``.  Each session case drives a reference session and a port
session that share one hash family (``_torch_parity.port_session``) with the
same numpy batches and holds them equal: bit for bit with integer weights,
``rtol=1e-6, atol=1e-5`` with float weights.  The cross-package cases: one
mutation sequence writes byte-identical WAL segments in both packages, a
reference WAL (alone, or after a reference checkpoint) recovers in the port,
reference checkpoints (plain, windowed, and one without flow registers)
restore in the port with the reference's answers, and port checkpoints
restore in the reference."""
import json
import math
import warnings

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.api import GraphStream as RefStream, Query as RefQuery, SketchConfig as RefConfig
from repro.checkpoint.manager import CheckpointManager as RefManager
from repro.core.sketch import GLavaSketch as RefSketch
from repro.stream import wal as ref_wal, watermark as ref_watermark
from repro_torch.api import GraphStream, Query, RecoveryReport
from repro_torch.checkpoint.manager import CheckpointCorruptError, CheckpointManager
from repro_torch.stream.events import EventFeed, EventOverflowError
from repro_torch.stream.wal import AdvanceMutation, EdgeMutation, MergeMutation, WalCorruptError, WriteAheadLog
from repro_torch.stream.watermark import WatermarkTracker, slice_of, slices_of

from _torch_parity import assert_same_sketch, head_relative, port_config, port_session

CFG = RefConfig(depth=2, width_rows=64, width_cols=64)
PCFG = port_config(CFG)


def _ref(**kw):
    kw.setdefault("ingest_backend", "scatter")
    return RefStream.open(CFG, query_backend="jnp", **kw)


def _port(**kw):
    return port_session(CFG, **kw)


def _pair(**kw):
    return _ref(**kw), _port(**kw)


def _eventtime(kw):
    kw = dict(kw)
    kw.setdefault("window_slices", 8)
    kw.setdefault("slice_width", 1.0)
    kw.setdefault("max_lateness", 2.0)
    return kw


def _pair_eventtime(**kw):
    return _pair(**_eventtime(kw))


def _assert_same_window(port, ref, exact=True):
    for got, want in zip(head_relative(port)[:3], head_relative(ref)[:3]):
        if exact:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    assert head_relative(port)[3] == head_relative(ref)[3]


RECEIPT_FIELDS = ("epoch", "n_edges", "event_time_min", "event_time_max", "watermark", "late_dropped",
                  "late_retracted", "auto_advances", "wal_seq")


def _assert_same_receipt(got, want):
    assert [getattr(got, f) for f in RECEIPT_FIELDS] == [getattr(want, f) for f in RECEIPT_FIELDS]
    if want.touched_keys is None:
        assert got.touched_keys is None
    else:
        np.testing.assert_array_equal(got.touched_keys, want.touched_keys)


# ---------------------------------------------------------------------------
# watermark tracker
# ---------------------------------------------------------------------------


def test_slice_of():
    assert slice_of(0.0, 1.0) == 0
    assert slice_of(2.999, 1.0) == 2
    assert slice_of(-0.5, 1.0) == -1
    ts = np.array([0.0, 1.5, 7.99, -3.25, 1e9 + 0.5])
    for width in (2.0, 0.3, 1.0):
        np.testing.assert_array_equal(slices_of(ts, width), ref_watermark.slices_of(ts, width))
        assert [slice_of(t, width) for t in ts] == [ref_watermark.slice_of(t, width) for t in ts]


def test_watermark_min_over_sources_and_monotone():
    t, r = WatermarkTracker(max_lateness=2.0), ref_watermark.WatermarkTracker(max_lateness=2.0)
    assert t.watermark == -math.inf
    for src, tmax, want in ((0, 10.0, 8.0), (1, 5.0, 8.0), (1, 20.0, 8.0), (0, 30.0, 18.0)):
        assert t.observe(src, tmax) == r.observe(src, tmax) == want
    assert t.sources == r.sources == {0: 30.0, 1: 20.0}


def test_watermark_rejects_bad_input():
    with pytest.raises(ValueError):
        WatermarkTracker(max_lateness=-1.0)
    with pytest.raises(ValueError):
        WatermarkTracker(max_lateness=math.inf)
    with pytest.raises(ValueError):
        WatermarkTracker(1.0).observe(0, math.nan)


def test_watermark_state_roundtrip():
    t, r = WatermarkTracker(1.5), ref_watermark.WatermarkTracker(1.5)
    for tr in (t, r):
        tr.observe(3, 7.0)
        tr.observe(4, 9.0)
        tr.late_dropped, tr.late_retracted = 2, 5
    assert t.state() == r.state()
    # Each package's state restores in the other.
    t2 = WatermarkTracker.from_state(r.state())
    r2 = ref_watermark.WatermarkTracker.from_state(t.state())
    assert t2.watermark == r2.watermark == t.watermark and t2.sources == r2.sources == t.sources
    assert (t2.late_dropped, t2.late_retracted) == (2, 5)
    assert WatermarkTracker.from_state(WatermarkTracker(1.5).state()).watermark == -math.inf


# ---------------------------------------------------------------------------
# write-ahead log
# ---------------------------------------------------------------------------


def _edges(rng, n=8):
    return (
        rng.integers(0, 100, n).astype(np.uint32),
        rng.integers(0, 100, n).astype(np.uint32),
        rng.random(n).astype(np.float32),
    )


def _wal_bytes(directory):
    return {p.name: p.read_bytes() for p in sorted(directory.glob("wal-*.seg"))}


def test_wal_roundtrip_and_suffix_replay(tmp_path):
    """The same appends write byte-identical segments in both packages, and
    each package's log replays in the other."""
    logs = {}
    for name, cls in (("port", WriteAheadLog), ("ref", ref_wal.WriteAheadLog)):
        rng = np.random.default_rng(0)
        wal = cls(tmp_path / name)
        s1, d1, w1 = _edges(rng)
        seq1 = wal.append_edges(s1, d1, w1, timestamps=np.arange(8.0))
        wal.append_advance()
        s2, d2, w2 = _edges(rng, 5)
        wal.append_edges(s2, d2, w2, source_key=7)
        wal.append_merge_barrier()
        wal.close()
        logs[name] = _wal_bytes(tmp_path / name)
    assert logs["port"] == logs["ref"] and len(logs["port"]) == 1
    for name in ("port", "ref"):  # the port reads both logs
        muts = list(WriteAheadLog(tmp_path / name).replay())
        assert [type(m) for m in muts] == [EdgeMutation, AdvanceMutation, EdgeMutation, MergeMutation]
        np.testing.assert_array_equal(muts[0].src, s1)
        np.testing.assert_array_equal(muts[0].dst, d1)
        np.testing.assert_array_equal(muts[0].weights, w1)
        np.testing.assert_array_equal(muts[0].timestamps, np.arange(8.0))
        assert muts[2].timestamps is None and muts[2].source_key == 7
        np.testing.assert_array_equal(muts[2].weights, w2)
        suffix = list(WriteAheadLog(tmp_path / name).replay(after_seq=seq1))
        assert [type(m) for m in suffix] == [AdvanceMutation, EdgeMutation, MergeMutation]
    ref_muts = list(ref_wal.WriteAheadLog(tmp_path / "port").replay())
    assert [m.seq for m in ref_muts] == [m.seq for m in WriteAheadLog(tmp_path / "port").replay()]


def test_wal_replay_groups_records_as_the_reference(tmp_path):
    """The port groups a segment's records with numpy where the reference
    steps through them: the same mutations from the same bytes, a torn edge
    run before an advance dropped, and the same refusal of a commit whose
    count does not match."""
    rng = np.random.default_rng(4)
    wal = ref_wal.WriteAheadLog(tmp_path / "log")
    for i in range(6):
        n = int(rng.integers(0, 40))
        wal.append_edges(*_edges(rng, n), timestamps=rng.random(n) if i % 2 else None, source_key=i)
        if i % 3 == 1:
            wal.append_advance()
        if i == 4:
            wal.rotate()
    wal.append_merge_barrier()
    wal.close()
    seg = sorted((tmp_path / "log").glob("wal-*.seg"))[-1]
    raw = seg.read_bytes()
    torn = np.zeros(3, ref_wal.WAL_RECORD)  # an edge run cut off by an advance
    torn["op"], torn["seq"] = ref_wal.OP_EDGE, wal.last_seq + 1 + np.arange(3)
    adv = np.zeros(1, ref_wal.WAL_RECORD)
    adv["op"], adv["seq"], adv["event_time"] = ref_wal.OP_ADVANCE, wal.last_seq + 4, np.nan
    seg.write_bytes(raw + torn.tobytes() + adv.tobytes())

    def fields(m):
        return {k: (v.tolist() if isinstance(v, np.ndarray) else v) for k, v in vars(m).items()}

    got, want = list(WriteAheadLog(tmp_path / "log").replay()), list(ref_wal.WriteAheadLog(tmp_path / "log").replay())
    assert [type(m).__name__ for m in got] == [type(m).__name__ for m in want] and len(got) == 10
    assert [fields(m) for m in got] == [fields(m) for m in want]
    bad = np.frombuffer(seg.read_bytes()[16:], ref_wal.WAL_RECORD).copy()
    bad["src"][np.flatnonzero(bad["op"] == ref_wal.OP_COMMIT)[0]] += 1
    seg.write_bytes(seg.read_bytes()[:16] + bad.tobytes())
    for cls, error in ((WriteAheadLog, WalCorruptError), (ref_wal.WriteAheadLog, ref_wal.WalCorruptError)):
        with pytest.raises(error, match="claims"):
            list(cls(tmp_path / "log").replay())


def test_wal_reopen_continues_sequence(tmp_path):
    rng = np.random.default_rng(1)
    wal = WriteAheadLog(tmp_path)
    wal.append_edges(*_edges(rng))
    first = wal.last_seq
    wal.close()
    wal2 = WriteAheadLog(tmp_path)
    wal2.append_edges(*_edges(rng))
    assert wal2.last_seq > first
    seqs = [m.seq for m in wal2.replay()]
    assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs)
    assert ref_wal.WriteAheadLog(tmp_path).last_seq == wal2.last_seq


def test_wal_torn_tail_is_dropped(tmp_path):
    rng = np.random.default_rng(2)
    wal = WriteAheadLog(tmp_path)
    wal.append_edges(*_edges(rng))
    wal.append_edges(*_edges(rng, 4))
    wal.close()
    seg = sorted(tmp_path.glob("wal-*.seg"))[-1]
    data = seg.read_bytes()
    seg.write_bytes(data[: len(data) - 13])  # chop mid-record
    muts = list(WriteAheadLog(tmp_path).replay())
    assert len(muts) == 1  # only the first committed batch survives
    assert [m.seq for m in ref_wal.WriteAheadLog(tmp_path).replay()] == [m.seq for m in muts]
    wal3 = WriteAheadLog(tmp_path)
    wal3.append_edges(*_edges(rng, 3))
    assert len(list(wal3.replay())) == 2


def test_wal_rotation_and_gc(tmp_path):
    rng = np.random.default_rng(3)
    wal = WriteAheadLog(tmp_path)
    wal.append_edges(*_edges(rng))
    covered = wal.last_seq
    wal.rotate()
    wal.append_edges(*_edges(rng))
    assert len(wal.segments()) == 2
    assert wal.gc(covered) == 1
    assert len(wal.segments()) == 1
    assert len(list(wal.replay(after_seq=covered))) == 1
    wal.sync()
    assert wal.gc(wal.last_seq) == 0  # the newest segment always stays
    assert len(wal.segments()) == 1


# ---------------------------------------------------------------------------
# event feed overflow policies
# ---------------------------------------------------------------------------


def test_event_feed_policies():
    f = EventFeed(2, "drop_oldest")
    for i in range(4):
        f.push(i)
    assert list(f.drain()) == [2, 3] and f.dropped == 2
    f = EventFeed(2, "drop_newest")
    for i in range(4):
        f.push(i)
    assert list(f.drain()) == [0, 1] and f.dropped == 2
    f = EventFeed(2, "error")
    f.push(0), f.push(1)
    with pytest.raises(EventOverflowError):
        f.push(2)
    with pytest.raises(ValueError):
        EventFeed(2, "bogus")


def test_subscription_overflow_counter():
    ref, port = _pair()
    subs = [
        gs.subscribe(mod.in_flow(7), every=1, max_pending=2, overflow="drop_newest")
        for gs, mod in ((ref, RefQuery), (port, Query))
    ]
    for _ in range(5):
        for gs in (ref, port):
            gs.ingest([1, 7], [7, 2])
    rs, ps = subs
    assert (ps.pending, ps.events_dropped, port.events_dropped) == (rs.pending, rs.events_dropped, ref.events_dropped)
    assert ps.pending == 2 and ps.events_dropped == 3
    assert [e.tick for e in ps.poll()] == [e.tick for e in rs.poll()] == [1, 2]


# ---------------------------------------------------------------------------
# event-time ingest: watermark-driven advances, late policies
# ---------------------------------------------------------------------------


def test_eventtime_requires_timestamps():
    gs = _port(**_eventtime({}))
    with pytest.raises(ValueError, match="timestamps"):
        gs.ingest([1], [2])
    with pytest.raises(ValueError, match="finite"):
        gs.ingest([1], [2], timestamps=[math.nan])
    with pytest.raises(ValueError, match="shape"):
        gs.ingest([1, 2], [2, 3], timestamps=[1.0])


def test_eventtime_validation():
    with pytest.raises(ValueError):  # max_lateness needs slice_width
        GraphStream.open(PCFG, device="cpu", window_slices=4, max_lateness=1.0)
    with pytest.raises(ValueError):  # slice_width needs a window
        GraphStream.open(PCFG, device="cpu", slice_width=1.0)
    with pytest.raises(ValueError):  # lead must leave live slices
        GraphStream.open(PCFG, device="cpu", window_slices=2, slice_width=1.0, max_lateness=5.0)
    with pytest.raises(ValueError, match="late_policy"):
        GraphStream.open(PCFG, device="cpu", late_policy="ignore")
    with pytest.raises(ValueError, match="fused"):
        GraphStream.open(PCFG, device="cpu", window_slices=2, ingest_backend="fused")


def test_watermark_drives_window_advance():
    ref, port = _pair_eventtime()
    for s, d, ts in (([1], [2], [0.5]), ([3], [4], [4.5])):
        _assert_same_receipt(port.ingest(s, d, timestamps=ts), ref.ingest(s, d, timestamps=ts))
    assert port.stats.auto_advances > 0 and port.watermark == ref.watermark == 2.5
    ps, rs = port.summary(), ref.summary()
    assert ps.keys() == rs.keys()
    for key in ("edges_ingested", "subscription_ticks", "auto_advances", "watermark", "late_dropped",
                "late_retracted", "events_dropped"):
        assert ps[key] == rs[key], key
    _assert_same_window(port, ref)


def test_in_order_stream_never_late():
    """An in-order stream is never late, however its batch spans compare
    with max_lateness: lateness is judged against the watermark promised
    BEFORE each batch."""
    ref, port = _pair_eventtime(max_lateness=0.5)
    ts = np.arange(0.0, 12.0, 0.05)  # every batch spans 3 slices
    rng = np.random.default_rng(0)
    for lo in range(0, ts.size, 60):
        chunk = ts[lo : lo + 60]
        s, d = rng.integers(0, 50, chunk.size), rng.integers(0, 50, chunk.size)
        _assert_same_receipt(port.ingest(s, d, timestamps=chunk), ref.ingest(s, d, timestamps=chunk))
    assert port.late_dropped == 0 and port.late_retracted == 0
    _assert_same_window(port, ref)


def _run_permuted(order, src, dst, w, ts, make=_port):
    gs = make(**_eventtime(dict(double_buffer=False)))
    for lo in range(0, src.size, 30):
        idx = order[lo : lo + 30]
        gs.ingest(src[idx], dst[idx], w[idx], timestamps=ts[idx])
    return gs, head_relative(gs)


@settings(max_examples=5, deadline=None)
@given(seed=st.integers(0, 10_000))
def test_out_of_order_within_lateness_bit_identical(seed):
    """Property: the port's ingest shuffled within the lateness bound is
    bit-identical to its in-order ingest (integer weights), which is
    bit-identical to the reference's in-order ingest."""
    rng = np.random.default_rng(seed)
    n = 300
    src = rng.integers(0, 200, n).astype(np.uint32)
    dst = rng.integers(0, 200, n).astype(np.uint32)
    w = rng.integers(1, 6, n).astype(np.float32)
    ts = np.sort(rng.uniform(0, 10.0, n))
    gs_a, in_order = _run_permuted(np.arange(n), src, dst, w, ts)
    keys = ts + rng.uniform(0, 2.0, n)
    gs_b, shuffled = _run_permuted(np.argsort(keys, kind="stable"), src, dst, w, ts)
    assert gs_a.late_retracted == 0 and gs_b.late_retracted == 0
    for a, b in zip(in_order[:3], shuffled[:3]):
        np.testing.assert_array_equal(a, b, err_msg=f"seed {seed}")
    assert in_order[3] == shuffled[3]


def test_out_of_order_in_order_matches_reference():
    rng = np.random.default_rng(11)
    n = 300
    src = rng.integers(0, 200, n).astype(np.uint32)
    dst = rng.integers(0, 200, n).astype(np.uint32)
    w = rng.integers(1, 6, n).astype(np.float32)
    ts = np.sort(rng.uniform(0, 10.0, n))
    order = np.argsort(ts + rng.uniform(0, 2.0, n), kind="stable")
    port, _ = _run_permuted(order, src, dst, w, ts)
    ref, _ = _run_permuted(order, src, dst, w, ts, make=_ref)
    _assert_same_window(port, ref)


def test_out_of_order_float_weights_close():
    rng = np.random.default_rng(0)
    n = 300
    src = rng.integers(0, 200, n).astype(np.uint32)
    dst = rng.integers(0, 200, n).astype(np.uint32)
    w = rng.random(n).astype(np.float32)
    ts = np.sort(rng.uniform(0, 10.0, n))
    _, in_order = _run_permuted(np.arange(n), src, dst, w, ts)
    order = np.argsort(ts + rng.uniform(0, 2.0, n), kind="stable")
    port, shuffled = _run_permuted(order, src, dst, w, ts)
    for a, b in zip(in_order[:3], shuffled[:3]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    ref, _ = _run_permuted(order, src, dst, w, ts, make=_ref)
    _assert_same_window(port, ref, exact=False)


def test_late_drop_policy_counts_and_filters():
    ref, port = _pair_eventtime(late_policy="drop", max_lateness=1.0)
    for gs in (ref, port):
        gs.ingest([1], [2], timestamps=[10.0])  # watermark -> 9.0
    r = port.ingest([3, 4], [5, 6], timestamps=[0.5, 9.5])
    _assert_same_receipt(r, ref.ingest([3, 4], [5, 6], timestamps=[0.5, 9.5]))
    assert r.late_dropped == 1 and r.late_retracted == 0 and port.late_dropped == 1
    assert port.query(Query.edge(4, 6)).value > 0
    assert float(port.query(Query.edge(3, 5)).value) == 0.0
    _assert_same_window(port, ref)


def test_late_retract_policy_nets_to_zero():
    """Retract (default): the late edge lands and is backed out through the
    turnstile-delete path, so the state equals a run that never saw it."""
    ref, port = _pair_eventtime(max_lateness=1.0, double_buffer=False)
    for gs in (ref, port):
        gs.ingest([1], [2], [2.0], timestamps=[10.0])
    r = port.ingest([3, 4], [5, 6], [1.5, 2.5], timestamps=[0.5, 9.5])
    _assert_same_receipt(r, ref.ingest([3, 4], [5, 6], [1.5, 2.5], timestamps=[0.5, 9.5]))
    assert r.late_retracted == 1 and r.touched_keys is None
    clean = _port(**_eventtime(dict(max_lateness=1.0, double_buffer=False)))
    clean.ingest([1], [2], [2.0], timestamps=[10.0])
    clean.ingest([4], [6], [2.5], timestamps=[9.5])
    for a, b in zip(head_relative(port)[:3], head_relative(clean)[:3]):
        np.testing.assert_array_equal(a, b)
    _assert_same_window(port, ref)


def test_per_source_watermark_holds_back():
    ref, port = _pair_eventtime(max_lateness=1.0)
    steps = [([3], [4], [2.0], "slow", 1.0), ([1], [2], [5.0], "fast", 1.0),
             ([5], [6], [6.0], "slow", 4.0), ([7], [8], [0.5], "latecomer", 4.0)]
    for s, d, ts, source, want in steps:
        _assert_same_receipt(port.ingest(s, d, timestamps=ts, source=source),
                             ref.ingest(s, d, timestamps=ts, source=source))
        assert port.watermark == ref.watermark == want
    _assert_same_window(port, ref)


# ---------------------------------------------------------------------------
# exactly-once recovery: fault injection at every batch boundary
# ---------------------------------------------------------------------------

N_BATCHES = 8
CKPT_EVERY = 3


def _mk_batches(seed=7):
    rng = np.random.default_rng(seed)
    out = []
    t = 0.0
    for _ in range(N_BATCHES):
        n = 20
        ts = np.sort(t + rng.uniform(0, 1.5, n))
        t = float(ts.max())
        out.append((
            rng.integers(0, 100, n).astype(np.uint32),
            rng.integers(0, 100, n).astype(np.uint32),
            rng.random(n).astype(np.float32),
            ts,
        ))
    return out


def _event_key(ev):
    vals = tuple(float(x) for r in ev.results for x in np.asarray(r.value).ravel())
    return (ev.name, ev.tick, ev.epoch, vals, ev.alarm)


def _drive(gs, sub, batches, transcript):
    for i, (s, d, w, ts) in enumerate(batches):
        gs.ingest(s, d, w, timestamps=ts)
        transcript.extend(_event_key(e) for e in sub.poll())
        if (i + 1) % CKPT_EVERY == 0 and gs._ckpt is not None:
            gs.checkpoint()


def _subscribed(gs, mod=Query):
    return gs.subscribe(
        mod.in_flow(7),
        mod.reach(3, 9),
        every=1,
        name="m",
        alarm=lambda rs: bool(np.asarray(rs[0].value) > 5),
    )


def _assert_transcripts_close(got, want):
    assert [k[:3] + k[4:] for k in got] == [k[:3] + k[4:] for k in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[3], w[3], rtol=1e-6, atol=1e-5)


@pytest.fixture(scope="module")
def reference_oracle():
    """The reference's uninterrupted run: its transcript and window."""
    gs = _ref(**_eventtime(dict(double_buffer=False)))
    want = []
    _drive(gs, _subscribed(gs, RefQuery), _mk_batches(), want)
    return want, head_relative(gs)


@pytest.mark.parametrize("crash_at", list(range(N_BATCHES + 1)))
def test_exactly_once_replay_any_crash_point(tmp_path, crash_at, reference_oracle):
    """Crash after ``crash_at`` batches, recover in a fresh session, and the
    consumed event sequence and final window are bit-identical to the port's
    uninterrupted run, and equal to the reference's within float tolerance
    (the weights are floats)."""
    batches = _mk_batches()
    wal, ckpt = tmp_path / "wal", tmp_path / "ckpt"
    oracle = _port(**_eventtime(dict(double_buffer=False)))
    want = []
    _drive(oracle, _subscribed(oracle), batches, want)

    def open_durable():
        return _port(**_eventtime(dict(double_buffer=False, wal_dir=str(wal), checkpoint_dir=str(ckpt))))

    gs1 = open_durable()
    sub1 = _subscribed(gs1)
    got = []
    _drive(gs1, sub1, batches[:crash_at], got)
    consumed_tick = sub1.ticks
    del gs1  # crash: no close, no final checkpoint

    gs2 = open_durable()
    sub2 = _subscribed(gs2)
    sub2.seek(consumed_tick)  # the consumer's durable position, BEFORE recover
    report = gs2.recover()
    assert isinstance(report, RecoveryReport)
    got.extend(_event_key(e) for e in sub2.poll())
    _drive(gs2, sub2, batches[crash_at:], got)

    assert got == want, f"crash_at={crash_at}"
    if crash_at % CKPT_EVERY != 0:
        assert sub2.events_deduped + report.mutations_replayed > 0
    for a, b in zip(head_relative(gs2)[:3], head_relative(oracle)[:3]):
        np.testing.assert_array_equal(a, b, err_msg=f"crash_at={crash_at}")
    ref_want, ref_window = reference_oracle
    _assert_transcripts_close(got, ref_want)
    for a, b in zip(head_relative(gs2)[:3], ref_window[:3]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-5)


def test_recover_requires_wal(tmp_path):
    gs = _port(checkpoint_dir=str(tmp_path))
    with pytest.raises(ValueError, match="wal_dir"):
        gs.recover()
    with pytest.raises(ValueError, match="checkpoint_dir"):
        _port().checkpoint()


def test_checkpoint_gc_drops_covered_wal_segments(tmp_path):
    gs = _port(wal_dir=str(tmp_path / "wal"), checkpoint_dir=str(tmp_path / "ckpt"))
    rng = np.random.default_rng(0)
    for _ in range(4):
        gs.ingest(*_edges(rng))
        gs.checkpoint()
    assert len(gs._wal.segments()) <= 2
    ref = gs.sketch
    gs2 = _port(wal_dir=str(tmp_path / "wal"), checkpoint_dir=str(tmp_path / "ckpt"))
    gs2.recover()
    assert torch.equal(gs2.sketch.counters, ref.counters)


# ---------------------------------------------------------------------------
# corrupt-checkpoint fallback
# ---------------------------------------------------------------------------


def test_corrupt_latest_falls_back_to_previous(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    state = {"x": np.arange(4, dtype=np.float32)}
    mgr.save(1, state, metadata={"tag": "one"})
    mgr.save(2, {"x": np.arange(4, dtype=np.float32) * 2}, metadata={"tag": "two"})
    shard = tmp_path / "step_0000000002" / "arrays.npz"
    shard.write_bytes(shard.read_bytes()[:40])  # truncate mid-zip
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got, meta = mgr.restore(like={"x": np.zeros(4, np.float32)})
    assert meta["tag"] == "one" and meta["step"] == 1
    np.testing.assert_array_equal(np.asarray(got["x"]), state["x"])
    assert any(isinstance(w.message, RuntimeWarning) and "step 2" in str(w.message) for w in caught)
    with pytest.raises(CheckpointCorruptError) as ei:
        mgr.restore(step=2, like={"x": np.zeros(4, np.float32)})
    assert ei.value.step == 2 and ei.value.path.name == "arrays.npz"


def test_all_checkpoints_corrupt_raises_first_error(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    mgr.save(1, {"x": np.zeros(2, np.float32)})
    (tmp_path / "step_0000000001" / "arrays.npz").write_bytes(b"not a zip")
    with pytest.warns(RuntimeWarning, match="corrupt"):
        with pytest.raises(CheckpointCorruptError):
            mgr.restore(like={"x": np.zeros(2, np.float32)})


def test_read_metadata_manifest_only(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    mgr.save(5, {"x": np.zeros(2, np.float32)}, metadata={"wal_seq": 42})
    meta = mgr.read_metadata(5)
    assert meta["wal_seq"] == 42 and meta["step"] == 5
    assert RefManager(tmp_path).read_metadata(5) == meta


# ---------------------------------------------------------------------------
# across the two packages
# ---------------------------------------------------------------------------


def _mutate(gs, rng):
    """One mixed mutation sequence: event-time ingests, a late edge, an
    explicit advance, a delete."""
    for i in range(4):
        s, d, w = _edges(rng, 12)
        gs.ingest(s, d, np.round(w * 8), timestamps=np.sort(i + rng.uniform(0, 1.5, 12)), source=i % 2)
    gs.ingest([5], [6], [3.0], timestamps=[0.1])
    gs.advance_window()
    gs.delete([5], [6], [1.0], timestamps=[4.2])


def test_same_mutations_write_byte_identical_wals(tmp_path):
    ref = _ref(**_eventtime(dict(wal_dir=str(tmp_path / "ref"))))
    port = _port(**_eventtime(dict(wal_dir=str(tmp_path / "port"))))
    for gs in (ref, port):
        _mutate(gs, np.random.default_rng(5))
    _assert_same_window(port, ref)
    assert port.late_retracted == ref.late_retracted == 1
    got, want = _wal_bytes(tmp_path / "port"), _wal_bytes(tmp_path / "ref")
    assert got == want and sum(map(len, got.values())) > 0


def test_reference_wal_and_checkpoint_recover_in_the_port(tmp_path):
    """A reference session checkpoints, crashes mid-stream; the port
    recovers from the reference's checkpoint and WAL suffix (and, from the
    WAL alone, by genesis replay) and ends where the reference does."""
    batches = _mk_batches(9)
    ref = _ref(**_eventtime(dict(double_buffer=False, wal_dir=str(tmp_path / "wal"),
                                 checkpoint_dir=str(tmp_path / "ckpt"))))
    ref_sub = _subscribed(ref, RefQuery)
    want = []
    _drive(ref, ref_sub, batches[:5], want)
    assert RefManager(tmp_path / "ckpt").latest_step() is not None
    full = _ref(**_eventtime(dict(double_buffer=False)))
    full_sub, full_events = _subscribed(full, RefQuery), []
    _drive(full, full_sub, batches[:5], full_events)

    port = _port(**_eventtime(dict(double_buffer=False, wal_dir=str(tmp_path / "wal"),
                                   checkpoint_dir=str(tmp_path / "ckpt"))))
    sub = _subscribed(port)
    mgr = RefManager(tmp_path / "ckpt")
    consumed = mgr.read_metadata(mgr.latest_step())["subs"]["name:m"]["ticks"]
    sub.seek(consumed)  # the consumer read up to the checkpoint
    report = port.recover()
    assert report.step is not None and report.mutations_replayed == 2
    got = [_event_key(e) for e in sub.poll()]
    assert got and sub.events_deduped == 0
    _assert_transcripts_close(got, [k for k in want if k[1] > consumed])
    _assert_same_window(port, full, exact=False)
    assert port.watermark == full.watermark and port.epoch == full.epoch

    genesis = _port(**_eventtime(dict(double_buffer=False, wal_dir=str(tmp_path / "wal"))))
    gsub = _subscribed(genesis)
    report = genesis.recover()
    assert report.step is None and report.mutations_replayed == 5
    _assert_transcripts_close([_event_key(e) for e in gsub.poll()], full_events)
    _assert_same_window(genesis, full, exact=False)


def _integer_batches(rng, n_batches=3, n=40):
    return [
        (rng.integers(0, 300, n).astype(np.uint32), rng.integers(0, 300, n).astype(np.uint32),
         rng.integers(1, 5, n).astype(np.float32))
        for _ in range(n_batches)
    ]


def test_reference_checkpoints_restore_in_the_port(tmp_path):
    """Plain and windowed reference checkpoints, and one without flow
    registers (the fill-missing path), restore in the port with the
    reference's answers."""
    rng = np.random.default_rng(2)
    keys = rng.integers(0, 300, 64).astype(np.uint32), rng.integers(0, 300, 64).astype(np.uint32)
    for name, kw in (("plain", {}), ("window", dict(window_slices=3))):
        ref = _ref(checkpoint_dir=str(tmp_path / name), **kw)
        for s, d, w in _integer_batches(rng):
            ref.ingest(s, d, w)
            ref.advance_window()
        ref.checkpoint()
        port = GraphStream.open(PCFG, seed=99, device="cpu", checkpoint_dir=str(tmp_path / name), **kw)
        assert port.restore() == ref.epoch and port.epoch == ref.epoch
        assert_same_sketch(port.sketch, ref.sketch)
        if kw:
            _assert_same_window(port, ref)
        for q, rq in ((Query.edge(*keys), RefQuery.edge(*keys)), (Query.in_flow(keys[0]), RefQuery.in_flow(keys[0])),
                      (Query.reach(keys[0][:16], keys[1][:16]), RefQuery.reach(keys[0][:16], keys[1][:16]))):
            np.testing.assert_array_equal(port.query(q).value, ref.query(rq).value)
    # A checkpoint from before the registers existed: the reference's file
    # with the two register leaves taken out of its index.
    sk = RefSketch.empty(CFG, jax.random.key(4))
    for s, d, w in _integer_batches(rng):
        sk = sk.update(s, d, w)
    RefManager(tmp_path / "old").save(7, sk, {"epoch": 7})
    mpath = tmp_path / "old" / "step_0000000007" / "manifest.json"
    manifest = json.loads(mpath.read_text())
    manifest["index"] = [e for e in manifest["index"] if not e["path"].endswith("_flows")]
    mpath.write_text(json.dumps(manifest))
    port = GraphStream.open(PCFG, device="cpu", checkpoint_dir=str(tmp_path / "old"))
    assert port.restore() == 7 and port.epoch == 7
    assert sorted(port._last_restore_meta["filled_leaves"]) == [".col_flows", ".row_flows"]
    assert_same_sketch(port.sketch, sk)


def test_port_checkpoints_restore_in_the_reference(tmp_path):
    rng = np.random.default_rng(3)
    for name, kw in (("plain", {}), ("window", dict(window_slices=3))):
        ref, port = _pair(checkpoint_dir=str(tmp_path / name / "port"), **kw)
        for s, d, w in _integer_batches(rng):
            for gs in (ref, port):
                gs.ingest(s, d, w)
                gs.advance_window()
        port.checkpoint()
        back = _ref(seed=42, checkpoint_dir=str(tmp_path / name / "port"), **kw)
        assert back.restore() == port.epoch and back.epoch == port.epoch
        assert_same_sketch(port.sketch, back.sketch)
        if kw:
            _assert_same_window(port, back)
        keys = rng.integers(0, 300, 32).astype(np.uint32), rng.integers(0, 300, 32).astype(np.uint32)
        np.testing.assert_array_equal(port.edge_frequency(*keys), back.edge_frequency(*keys))


def test_ddos_crash_replay_matches_reference(tmp_path, capsys):
    """``examples/ddos_monitor.py``'s crash-replay mode on the port: killed
    after 13 batches (one checkpoint taken at batch 10), recovered from the
    checkpoint and the WAL suffix, driven to the end; the stitched transcript
    equals the reference's uninterrupted run (alarm ticks exactly, in-flows
    within float tolerance)."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / "ddos_monitor.py"
    spec = importlib.util.spec_from_file_location("ddos_monitor", path)
    ddos = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ddos)
    want = ddos.run_monitor()
    cfg = RefConfig(depth=4, width_rows=1024, width_cols=1024)

    def open_port():
        gs = port_session(cfg, wal_dir=str(tmp_path / "wal"), checkpoint_dir=str(tmp_path / "ckpt"))
        sub = gs.subscribe(
            Query.heavy(ddos.TARGET, ddos.THETA), Query.in_flow(ddos.TARGET), every=1,
            alarm=lambda results: bool(np.asarray(results[0].value[0])), name="ddos-watch",
        )
        return gs, sub

    crash_after = 13
    batches = ddos._make_batches(ddos.N_BATCHES)
    gs, sub = open_port()
    got = []
    ddos._drive(gs, sub, batches[:crash_after], got, verbose=False)
    consumed = sub.ticks
    del gs  # crash: no close, no final checkpoint
    gs, sub = open_port()
    sub.seek(consumed)
    report = gs.recover()
    assert report.step == 10 and report.mutations_replayed == crash_after - 10
    assert sub.events_deduped == crash_after - 10
    got.extend(ddos._event_key(e) for e in sub.poll())
    ddos._drive(gs, sub, batches[crash_after:], got, start_t=crash_after, verbose=False)
    assert [k[:2] for k in got] == [k[:2] for k in want] and len(got) == ddos.N_BATCHES
    assert any(alarm for _, alarm, _ in got)
    np.testing.assert_allclose([k[2] for k in got], [k[2] for k in want], rtol=1e-6, atol=1e-5)
