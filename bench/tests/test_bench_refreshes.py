"""The ``closure_refreshes_per_tick`` reader on hand-made timelines written
through ``repro_torch.telemetry`` (``test_bench_telemetry.py``'s fake
clock): 0 for a session whose ticks rebuild, 1 for a fleet that refreshes
once a tick, None untraced, on a program that records no ``tick.refresh``
and after the ring dropped part of the window."""
import collections

import pytest

from bench.harness import spec
from bench.tests.test_bench_telemetry import _ctx, _shift, record  # noqa: F401 (a fixture)
from repro_torch import telemetry

SESSION_BATCH = ("ingest", 100, 400, [
    ("ingest.copy", 190, 210, []),
    ("tick", 220, 390, [("tick.wait", 225, 235, []), ("tick.results", 300, 380, [])]),
])
FLEET_BATCH = ("ingest", 100, 400, [
    ("ingest.route", 110, 150, []),
    ("tick", 220, 390, [("tick.wait", 225, 245, []), ("tick.refresh", 250, 290, []),
                        ("tick.results", 300, 340, []), ("tick.results", 340, 380, [])]),
])
READER = "closure_refreshes_per_tick"


@pytest.mark.parametrize("batch,want", [(SESSION_BATCH, 0.0), (FLEET_BATCH, 1.0)], ids=["session", "fleet"])
def test_refreshes_per_tick_reads_the_hand_counted_value(record, batch, want):
    record(batch, _shift(batch, 400))
    assert spec.reader(READER)(_ctx()) == want


def test_refreshes_per_tick_reads_nothing_without_its_records(record, monkeypatch):
    """None untraced (no records), on a program without the span's name,
    and after the ring dropped part of the window."""
    reader = spec.reader(READER)
    assert reader(_ctx()) is None
    record(FLEET_BATCH, _shift(FLEET_BATCH, 400))
    with monkeypatch.context() as m:
        m.setattr(telemetry, "NAMES", frozenset(), raising=False)
        assert reader(_ctx()) is None
    monkeypatch.setattr(telemetry, "_ring", collections.deque(maxlen=4))
    record(FLEET_BATCH, _shift(FLEET_BATCH, 400))
    assert telemetry.dropped() > 0 and reader(_ctx()) is None
