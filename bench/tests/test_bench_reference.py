"""The plain reference against the port's plain backends on a SMOKE-sized
sketch (d = 3, 256 x 256) on the CPU: counters, both registers, the four
families of the standing workload and the dashboard; and each
configuration's sizes are the paper's sizing at its stated error."""
import numpy as np
import pytest
import torch

from bench.harness import spec
from bench.harness.generators import edge_stream as traffic
from bench.reference import glava

SEED = 2**31 + 99
D, W = 3, 256


@pytest.fixture(scope="module")
def both():
    from repro_torch.api import GraphStream, SketchConfig

    tr = {"stream": {"nodes": 2000, "zipf_a": 1.2, "max_weight": 8, "batch": 3000}}
    s = traffic.make_stream(tr, SEED, 6, "cpu")
    gs = GraphStream.open(SketchConfig(D, W, W), seed=SEED, device="cpu")
    ref = glava.Summary(SEED, D, W, "cpu")
    for i in range(s.n_batches):
        span = s.span(i)
        gs.ingest(s.src[span], s.dst[span], s.weight[span])
        ref.ingest(torch.from_numpy(s.src[span].astype(np.int64)), torch.from_numpy(s.dst[span].astype(np.int64)),
                   torch.from_numpy(s.weight[span]))
    rng = np.random.default_rng(3)
    qs, qd = rng.integers(0, 2000, 128).astype(np.uint32), rng.integers(0, 2000, 128).astype(np.uint32)
    return gs, ref, qs, qd


def test_hash_family_is_the_port_derivation():
    from repro_torch.core.sketch import GLavaSketch, SketchConfig

    row, col = GLavaSketch.hash_families(SketchConfig(5, 8192, 8192), SEED)
    a, b = glava.hash_family(SEED, 5)
    assert row is col and np.array_equal(row.a_host, a.numpy()) and np.array_equal(row.b_host, b.numpy())
    keys = torch.tensor([0, 1, 2**31 - 2, 2**31 - 1, 2**31, 2**32 - 1])
    assert torch.equal(row(keys), glava.buckets(keys, a, b, 8192))


def test_state(both):
    gs, ref, _, _ = both
    sk = gs.sketch
    for prog, want in ((sk.counters, ref.counters), (sk.row_flows, ref.rows), (sk.col_flows, ref.cols)):
        assert torch.equal(prog.double(), want)


def test_families(both):
    from repro_torch.api import Query

    gs, ref, qs, qd = both
    t = lambda x: torch.from_numpy(x.astype(np.int64))  # noqa: E731
    edge, inflow, heavy, reach = gs.query(Query.edge(qs, qd), Query.in_flow(qs), Query.heavy(qs, theta=0.01),
                                          Query.reach(qs, qd))
    assert np.array_equal(edge.value, ref.edge(t(qs), t(qd)).numpy())
    assert np.array_equal(inflow.value, ref.in_flow(t(qs)).numpy())
    hin, hout, *_ = ref.heavy(t(qs), 0.01)
    assert np.array_equal(heavy.value[0], hin.numpy()) and np.array_equal(heavy.value[1], hout.numpy())
    closure, k = ref.closure()
    assert k >= 1 and np.array_equal(reach.value, ref.reach(closure, t(qs), t(qd)).numpy())
    assert torch.equal(gs.engine.closure_for(gs.sketch, gs.epoch), closure)
    short, _ = ref.closure(short=True)
    assert not torch.equal(short, closure)


def test_dashboard(both):
    from repro_torch.core.queries import global_triangle_estimate

    gs, ref, _, _ = both
    ranks = torch.from_numpy(gs.pagerank(0.85, 32)).double()
    want = ref.pagerank(0.85, 32)
    assert float(((ranks - want).abs() / want).max()) < 1e-5
    tri = float(global_triangle_estimate(gs.sketch))
    assert abs(tri - ref.triangles()) / ref.triangles() < 1e-5
    # The TF32 analytics reads farther off than float32 does.
    low = ref.pagerank(0.85, 32, analytics="tf32")
    assert float(((low - want).abs() / want).max()) > float(((ranks - want).abs() / want).max())


@pytest.mark.parametrize("config", [c["file"] for c in spec.load_json(spec.REPO / "BENCHMARK.json")["configs"]])
def test_config_sizes_are_the_stated_sizing(config):
    from repro_torch.core.sketch import SketchConfig

    cfg = spec.load_json(spec.REPO / config)
    sized = SketchConfig.for_error(cfg["sizing"]["epsilon"], cfg["sizing"]["delta"])
    assert (sized.depth, sized.width_rows, sized.width_cols) == (cfg["depth"], cfg["width_rows"], cfg["width_cols"])
    assert cfg["state_bytes"] == cfg.get("capacity", 1) * (sized.space_bytes() + 2 * 4 * sized.depth * sized.width_rows)
