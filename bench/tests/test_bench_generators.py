"""The traffic generator repeats by seed, differs across seeds, draws the
distributions it names, and makes a run's inputs by time or by count."""
import numpy as np
import pytest

from bench.harness import spec
from bench.harness.generators import edge_stream as traffic

BENCHMARK = spec.load_json(spec.REPO / "BENCHMARK.json")
MIXES = sorted({w["traffic"] for w in BENCHMARK["workloads"]})


def _small(mix):
    tr = spec.load_json(spec.BENCH / "traffic" / f"{mix}.json")
    tr["stream"]["batch"] = 5000
    return tr


@pytest.mark.parametrize("mix", MIXES)
def test_repeats_by_seed_and_differs_across_seeds(mix):
    tr = _small(mix)
    a, b, c = (traffic.make_stream(tr, s, 4, "cpu") for s in (2**31 + 5, 2**31 + 5, 2**31 + 6))
    for f in ("src", "dst", "weight"):
        assert np.array_equal(getattr(a, f), getattr(b, f))
        assert not np.array_equal(getattr(a, f), getattr(c, f))
    assert (a.tenant is None) == ("tenant_ids" not in tr)
    if a.tenant is not None:
        assert np.array_equal(a.tenant, b.tenant)
    qa, qb = traffic.standing(tr, 7), traffic.standing(tr, 7)
    assert np.array_equal(qa.qs, qb.qs) and not np.array_equal(qa.qs, traffic.standing(tr, 8).qs)
    assert a.src.dtype == np.uint32 and a.weight.dtype == np.float32 and a.n_batches == 4


def test_distributions():
    tr = _small("fleet-reach-50k")
    s = traffic.make_stream(tr, 11, 40, "cpu")
    nodes = tr["stream"]["nodes"]
    p = np.arange(1, nodes + 1, dtype=np.float64) ** -tr["stream"]["zipf_a"]
    p /= p.sum()
    # Node 0 takes about a fifth of the draws on both ends.
    assert abs(np.mean(s.src == 0) - p[0]) < 0.01 and abs(np.mean(s.dst == 0) - p[0]) < 0.01
    assert s.src.max() < nodes and set(np.unique(s.weight)) == set(range(1, 9))
    # Tenant ids against numpy's own zipf draw folded the same way.
    probs = traffic.tenant_probs(16, 1.3)
    assert abs(probs.sum() - 1) < 1e-12
    ids = (np.random.default_rng(0).zipf(1.3, 2_000_000) - 1) % 16
    assert np.allclose(np.bincount(ids, minlength=16) / ids.size, probs, atol=3e-3)
    assert np.allclose(np.bincount(s.tenant, minlength=16) / s.tenant.size, probs, atol=3e-3)


def test_a_stream_that_runs_short_fails():
    s = traffic.make_stream(_small("reach-50k"), 3, 2, "cpu")
    with pytest.raises(RuntimeError, match="ran short"):
        s.span(2)


def test_make_by_seconds_or_batches():
    tr = _small("fleet-reach-50k")
    assert tr["generator"] == "edge_stream" and spec.plugin("generator", tr["generator"]) is traffic
    timed = traffic.make(tr, 5, "cpu", seconds=0.01)
    assert timed.stream.n_batches == traffic.n_batches(tr, 0.01) == tr["warmup_batches"] + 3
    counted = traffic.make(tr, 5, "cpu", batches=2)
    assert counted.stream.n_batches == 2 and np.array_equal(counted.stream.src, timed.stream.src[:10000])
    assert np.array_equal(counted.standing.qs, timed.standing.qs)
