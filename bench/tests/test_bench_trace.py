"""The trace reductions on a hand-made timeline: busy time is the union of
the device ops' intervals, idle gaps are named by the harness span the host
was in, kernel names are shortened, and the readers of device metrics read
nothing from an untraced run."""
import dataclasses

from bench.harness import spec
from bench.harness.trace import DeviceOp, Span, breakdown, busy_intervals, busy_s, kernel_s, short

OPS = [DeviceOp("void (anonymous namespace)::closure_step_wgmma_kernel<256>(CUtensorMap, int)", 10, 40),
       DeviceOp("void (anonymous namespace)::closure_step_wgmma_kernel<256>(CUtensorMap, int)", 30, 50),
       DeviceOp("Memcpy HtoD ", 70, 80)]
SPANS = [Span("ingest call (batch 0)", 0, 60), Span("ingest call (batch 1)", 60, 100)]


def test_busy_is_the_union_and_gaps_are_named():
    assert busy_intervals(OPS, 0, 100) == [(10, 50), (70, 80)]
    assert busy_s(OPS, 0, 100) == 50e-9 and busy_s(OPS, 20, 75) == 35e-9
    b = breakdown(OPS, SPANS, 0, 100)
    assert b["device_ops"] == [["closure_step_wgmma_kernel<256>", 50e-9], ["Memcpy HtoD ", 10e-9]]
    assert b["idle_gaps"][0] == ["ingest call (batch 0), 0.000 ms into it", 20e-9]
    assert [g[1] for g in b["idle_gaps"]] == [20e-9, 20e-9, 10e-9]
    assert kernel_s(OPS, r"closure_step") == 50e-9 and kernel_s(OPS, r"\bingest_kernel\b") is None
    assert short("void ingest_kernel<long, false>(Record)") == "ingest_kernel<long, false>"


def test_device_readers_read_nothing_untraced():
    @dataclasses.dataclass
    class Ctx:
        ops: object = None
        spans: tuple = ()

    for name in ("closure_roofline", "ingest_kernel_roofline", "stacked_ingest_roofline", "device_idle_pct",
                 "dashboard_ms.mean"):
        assert spec.reader(name)(Ctx()) is None
