"""The readers of the program's spans on hand-made timelines: records written
through ``repro_torch.telemetry`` at hand-set times (a fake clock), device
ops laid beside them, and each reader's value computed by hand.  Each reads
``None`` where its span is missing, where the ring dropped part of the
window, and for a program without ``repro_torch.telemetry``."""
import collections
import sys
from types import SimpleNamespace

import pytest

import repro_torch
from bench.harness import spec
from bench.harness.trace import DeviceOp
from repro_torch import telemetry

# (name, start, end, children); one session batch, then the same 400 ns on.
SESSION_BATCH = ("ingest", 100, 400, [
    ("ingest.codec", 110, 130, []), ("ingest.preaggregate", 130, 180, []), ("ingest.touched", 180, 190, []),
    ("ingest.copy", 190, 210, []),
    ("tick", 220, 390, [("tick.wait", 225, 235, []), ("tick.results", 300, 380, [])]),
])
FLEET_BATCH = ("ingest", 100, 400, [
    ("ingest.codec", 100, 110, []), ("ingest.route", 110, 150, []), ("ingest.route", 150, 170, []),
    ("ingest.touched", 170, 190, []), ("ingest.copy", 190, 210, []),
    ("tick", 220, 390, [("tick.wait", 225, 245, []), ("tick.results", 300, 340, []), ("tick.results", 340, 380, [])]),
])
# Device busy [200, 300] and [600, 700] of the window [0, 1000].
OPS = [DeviceOp("Memcpy HtoD", 200, 250), DeviceOp("closure_step", 240, 300), DeviceOp("closure_step", 600, 700)]
# Idle in the ingest call's own work: [100, 200] and [500, 600] whole (the
# call, codec, pre-aggregation or routing, touched scan, copy) plus the
# calls' last 10 ns; idle with no span open: [0, 100], [400, 500], [800, 1000].
SESSION = {"ingest_codec_ms.mean": 20e-6, "ingest_preagg_ms.mean": 50e-6, "ingest_touched_ms.mean": 10e-6,
           "ingest_route_ms.mean": None, "ingest_copy_ms.mean": 20e-6, "host_wait_ms.mean": 10e-6,
           "tick_results_ms.mean": 80e-6, "idle_in_ingest_host_pct": 22.0, "idle_unnamed_pct": 40.0}
FLEET = {"ingest_codec_ms.mean": 10e-6, "ingest_preagg_ms.mean": None, "ingest_touched_ms.mean": 20e-6,
         "ingest_route_ms.mean": 60e-6, "ingest_copy_ms.mean": 20e-6, "host_wait_ms.mean": 20e-6,
         "tick_results_ms.mean": 80e-6, "idle_in_ingest_host_pct": 22.0, "idle_unnamed_pct": 40.0}
READERS = sorted(SESSION)


def _shift(node, dt):
    name, s, e, kids = node
    return name, s + dt, e + dt, [_shift(k, dt) for k in kids]


def _times(node):
    name, s, e, kids = node
    return [s] + [t for k in kids for t in _times(k)] + [e]


def _play(node):
    with telemetry.span(node[0]):
        for kid in node[3]:
            _play(kid)


@pytest.fixture
def record(monkeypatch):
    """Writes timelines through the program's spans, as under a profiler,
    into a ring of its own."""
    monkeypatch.setattr(telemetry, "_profiler", SimpleNamespace(_is_profiler_enabled=True))
    monkeypatch.setattr(telemetry, "_ring", collections.deque(maxlen=telemetry.RING_SIZE))
    monkeypatch.setattr(telemetry, "_dropped", 0)

    def write(*roots):
        times = iter([t for r in roots for t in _times(r)])
        monkeypatch.setattr(telemetry, "_clock", lambda: next(times))
        for r in roots:
            _play(r)

    return write


def _ctx(ops=OPS, lo=0):
    return SimpleNamespace(ops=ops, lo_ns=lo, hi_ns=lo + 1000, spans=[])


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("batch,want", [(SESSION_BATCH, SESSION), (FLEET_BATCH, FLEET)], ids=["session", "fleet"])
def test_reader_reads_the_hand_computed_value(record, name, batch, want):
    record(batch, _shift(batch, 400))
    got = spec.reader(name)(_ctx())
    assert got == (None if want[name] is None else pytest.approx(want[name]))


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_nothing_without_its_records(record, monkeypatch, name):
    """None untraced (the idle shares), with no span in the window, after
    the ring dropped part of the window, and where the program has no
    ``repro_torch.telemetry`` (an older checkout)."""
    reader = spec.reader(name)
    assert reader(_ctx()) is None
    record(SESSION_BATCH, _shift(SESSION_BATCH, 400))
    if name.startswith("idle_"):
        assert reader(_ctx(ops=None)) is None
    with monkeypatch.context() as m:
        m.delattr(repro_torch, "telemetry")
        m.setitem(sys.modules, "repro_torch.telemetry", None)
        assert reader(_ctx()) is None
    monkeypatch.setattr(telemetry, "_ring", collections.deque(maxlen=4))
    record(SESSION_BATCH, _shift(SESSION_BATCH, 400))
    assert telemetry.dropped() > 0 and reader(_ctx()) is None


def test_a_drop_before_the_window_keeps_it_whole(record, monkeypatch):
    """Records dropped before a kept record that closed before the window
    opened leave the window whole: its readers read."""
    monkeypatch.setattr(telemetry, "_ring", collections.deque(maxlen=24))
    record(SESSION_BATCH, _shift(SESSION_BATCH, 400), _shift(SESSION_BATCH, 5000), _shift(SESSION_BATCH, 5400))
    assert telemetry.dropped() == 8
    assert spec.reader("ingest_codec_ms.mean")(_ctx(lo=5000)) == pytest.approx(20e-6)
