"""Parity of the port's GLavaSketch with the JAX reference: counters and both
flow registers bit-identical after update/delete/merge/scale sequences, on
square and non-square, directed and undirected configs (integer weights);
float weights to ``rtol=1e-6, atol=1e-5``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.ingest import preaggregate_host
from repro.core.sketch import GLavaSketch as RefSketch, SketchConfig as RefConfig
from repro_torch.core.hashing import keys_to_tensor
from repro_torch.core.sketch import GLavaSketch, SketchConfig

from _torch_parity import assert_same_sketch, to_port

CONFIGS = [
    RefConfig(depth=3, width_rows=64, width_cols=64),
    RefConfig(depth=2, width_rows=96, width_cols=40),
    RefConfig(depth=3, width_rows=64, width_cols=64, directed=False),
    RefConfig(depth=2, width_rows=40, width_cols=96, directed=False),
]


def _edges(rng, n, n_nodes=300, float_w=False):
    src = rng.integers(0, n_nodes, n).astype(np.uint32)
    dst = rng.integers(0, n_nodes, n).astype(np.uint32)
    w = rng.normal(2, 1, n) if float_w else rng.integers(1, 6, n)
    return src, dst, w.astype(np.float32)


def _both(src, dst, w):
    return (
        (jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w)),
        (keys_to_tensor(src), keys_to_tensor(dst), torch.from_numpy(w)),
    )


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: f"{c.width_rows}x{c.width_cols}-{'dir' if c.directed else 'undir'}")
@pytest.mark.parametrize("ops", [
    ("update", "update", "delete", "merge", "update"),
    ("update", "scale", "update", "delete"),
])
def test_update_delete_merge_scale_bit_identical(cfg, ops):
    rng = np.random.default_rng(cfg.width_rows + len(ops))
    ref = RefSketch.empty(cfg, jax.random.key(cfg.width_cols))
    port = to_port(ref)
    for i, op in enumerate(ops):
        (js, jd, jw), (ts, td, tw) = _both(*_edges(rng, 400))
        if op == "update":
            ref = ref.update(js, jd, jw, backend="scatter", preagg="off")
            port = port.update(ts, td, tw, backend="scatter")
        elif op == "delete":
            ref = ref.delete(js, jd, jw)
            port = port.delete(ts, td, tw)
        elif op == "merge":
            other = RefSketch.empty(cfg, jax.random.key(cfg.width_cols)).update(js, jd, jw)
            ref = ref.merge(other)
            port = port.merge(to_port(other))
        else:  # scale by a power of two keeps integer weights exact
            ref, port = ref.scale(0.5), port.scale(0.5)
        assert_same_sketch(port, ref, err=f"after op {i} ({op})")


@pytest.mark.parametrize("cfg", CONFIGS[:3], ids=["square", "nonsquare", "undirected"])
def test_in_place_forms_and_preaggregated_match_reference(cfg):
    rng = np.random.default_rng(11)
    ref = RefSketch.empty(cfg, jax.random.key(3))
    port = to_port(ref)
    src, dst, w = _edges(rng, 2000, n_nodes=60)
    pre = preaggregate_host(src, dst, w)
    ref = ref.update_preaggregated(*(jnp.asarray(getattr(pre, f)) for f in (
        "src", "dst", "weights", "src_unique", "src_totals", "dst_unique", "dst_totals")))
    counters = port.counters
    port.update_preaggregated_(
        keys_to_tensor(pre.src), keys_to_tensor(pre.dst), torch.from_numpy(pre.weights),
        keys_to_tensor(pre.src_unique), torch.from_numpy(pre.src_totals),
        keys_to_tensor(pre.dst_unique), torch.from_numpy(pre.dst_totals),
    )
    assert port.counters is counters  # in place
    assert_same_sketch(port, ref)
    (js, jd, jw), (ts, td, tw) = _both(*_edges(rng, 500))
    ref = ref.delete(js, jd, jw)
    port.delete_(ts, td, tw, backend="cuda")  # the kernel backend's CPU form
    assert_same_sketch(port, ref)
    # Registers still equal the counters' own marginals.
    np.testing.assert_array_equal(port.row_flows.numpy(), port.counters.sum(2).numpy())
    np.testing.assert_array_equal(port.col_flows.numpy(), port.counters.sum(1).numpy())


def test_float_weights_close_to_reference():
    cfg = CONFIGS[1]
    rng = np.random.default_rng(4)
    ref = RefSketch.empty(cfg, jax.random.key(5))
    port = to_port(ref)
    for _ in range(3):
        (js, jd, jw), (ts, td, tw) = _both(*_edges(rng, 700, float_w=True))
        ref = ref.update(js, jd, jw, preagg="off")
        port.update_(ts, td, tw)
    assert_same_sketch(port, ref, exact=False)


def test_functional_forms_and_results_do_not_alias():
    port = GLavaSketch.empty(SketchConfig(depth=2, width_rows=32, width_cols=32), 0)
    src = keys_to_tensor(np.arange(10, dtype=np.uint32))
    new = port.update(src, src)
    assert float(port.counters.sum()) == 0.0 and float(new.counters.sum()) == 2 * 10
    merged = new.merge(new)
    scaled = new.scale(2.0)
    new.update_(src, src)
    assert float(merged.counters.sum()) == 40.0 and float(scaled.counters.sum()) == 40.0
    with_c = port.with_counters(new.counters.clone())
    np.testing.assert_array_equal(with_c.row_flows.numpy(), new.row_flows.numpy())


def test_empty_square_shares_family_and_configs_match_reference():
    sq = GLavaSketch.empty(SketchConfig(depth=3, width_rows=64, width_cols=64), 1)
    ns = GLavaSketch.empty(SketchConfig(depth=3, width_rows=64, width_cols=32), 1)
    assert sq.col_hash is sq.row_hash and ns.col_hash is not ns.row_hash
    assert ns.col_hash.w == 32 and sq.same_family(GLavaSketch.empty(sq.config, 1))
    assert not sq.same_family(GLavaSketch.empty(sq.config, 2))
    for eps, delta in ((0.01, 0.05), (1e-4, 0.01), (0.3, 0.5)):
        got, want = SketchConfig.for_error(eps, delta), RefConfig.for_error(eps, delta)
        assert (got.depth, got.width_rows, got.width_cols) == (want.depth, want.width_rows, want.width_cols)
        assert got.error_bound() == want.error_bound()
        assert SketchConfig.for_error(*got.error_bound()) == got
