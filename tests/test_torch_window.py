"""Parity of the port's sliding window with the reference.

``SlidingWindowSketch`` is carried across from the reference's empty window
(``_torch_parity.window_to_port``) so both hash identically; the same numpy
batches then go through ``update``, ``update_at`` on every slot,
``update_preaggregated``, ``advance`` (through a wrap) and
``window_sketch`` on both sides, which must agree bit for bit (integer
weights).  ``tests/test_window.py``'s three cases run on the port, and a
windowed session (explicit advances, a reach subscription) must give the
reference's transcript tick for tick.  The checkpoint's leaf paths of the
port's state types must be the reference's ``keystr`` paths."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import GraphStream as RefStream, Query as RefQuery, QueryBatch as RefBatch
from repro.core.ingest import preaggregate_host as ref_preaggregate
from repro.core.sketch import SketchConfig as RefConfig
from repro.core.window import SlidingWindowSketch as RefWindow
from repro_torch.api import Query, QueryBatch
from repro_torch.checkpoint.manager import tree_paths
from repro_torch.core import queries
from repro_torch.core.hashing import keys_to_tensor
from repro_torch.core.ingest import pad_bucket, preaggregate_host
from repro_torch.core.sketch import GLavaSketch, SketchConfig
from repro_torch.core.window import SlidingWindowSketch

from _torch_parity import assert_same_value, port_session, window_to_port

CONFIGS = {
    "square": RefConfig(depth=3, width_rows=64, width_cols=64),
    "nonsquare": RefConfig(depth=2, width_rows=64, width_cols=32),
    "undirected": RefConfig(depth=2, width_rows=32, width_cols=32, directed=False),
}


def _pair(cfg, k=4, seed=0):
    ref = RefWindow.empty(cfg, k, jax.random.key(seed))
    return ref, window_to_port(ref)


def _batch(rng, n=50):
    return (rng.integers(0, 500, n).astype(np.uint32), rng.integers(0, 500, n).astype(np.uint32),
            rng.integers(1, 6, n).astype(np.float32))


def _both(s, d, w):
    return (jnp.asarray(s), jnp.asarray(d), jnp.asarray(w)), (keys_to_tensor(s), keys_to_tensor(d), torch.from_numpy(w))


def _assert_same_window(port, ref):
    assert port.current == int(ref.current)
    for name in ("slices", "row_flows", "col_flows"):
        np.testing.assert_array_equal(getattr(port, name).numpy(), np.asarray(getattr(ref, name)), err_msg=name)
    got, want = port.window_sketch(), ref.window_sketch()
    for name in ("counters", "row_flows", "col_flows"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_update_and_advance_through_a_wrap_match_reference(name):
    ref, port = _pair(CONFIGS[name])
    rng = np.random.default_rng(1)
    for step in range(7):  # 7 advances on a ring of 4: two wraps
        (rs, rd, rw), (ps, pd, pw) = _both(*_batch(rng))
        ref = ref.update(rs, rd, rw, backend="scatter")
        port.update_(ps, pd, pw)
        _assert_same_window(port, ref)
        ref, port = ref.advance(), port.advance_()
        _assert_same_window(port, ref)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_update_at_every_slot_matches_reference(name):
    ref, port = _pair(CONFIGS[name], k=5)
    rng = np.random.default_rng(2)
    ref, port = ref.advance().advance(), port.advance_().advance_()  # current = 2
    for slot in range(5):
        (rs, rd, rw), (ps, pd, pw) = _both(*_batch(rng))
        ref = ref.update_at(jnp.asarray(slot, jnp.int32), rs, rd, rw, backend="scatter")
        port.update_at_(slot, ps, pd, pw)
        _assert_same_window(port, ref)
    with pytest.raises(ValueError, match="slot"):
        port.update_at_(5, ps, pd, pw)


def test_preaggregated_update_matches_reference():
    cfg = CONFIGS["square"]
    ref, port = _pair(cfg)
    rng = np.random.default_rng(3)
    for _ in range(3):
        s, d, w = _batch(rng, 400)
        s[::3] = s[0]  # duplicate pairs for the collapse to merge
        d[::3] = d[0]
        rpre, ppre = ref_preaggregate(s, d, w), preaggregate_host(s, d, w)
        fields = ("src", "dst", "weights", "src_unique", "src_totals", "dst_unique", "dst_totals")
        ref = ref.update_preaggregated(*(jnp.asarray(pad_bucket(getattr(rpre, f))) for f in fields), backend="scatter")
        port.update_preaggregated_(*(
            keys_to_tensor(x) if x.dtype == np.uint32 else torch.from_numpy(x)
            for x in (pad_bucket(getattr(ppre, f)) for f in fields)
        ))
        _assert_same_window(port, ref)
        ref, port = ref.advance(), port.advance_()


def test_slices_are_views_and_functional_forms_copy():
    cfg = SketchConfig(depth=2, width_rows=16, width_cols=16)
    win = SlidingWindowSketch.empty(cfg, 3, 0)
    assert win.template.counters.stride() == (0, 0, 0)  # no buffer of its own
    for slot in (0, 2):
        sk = win.slice_at(slot)
        assert sk.counters.is_contiguous()
        assert sk.counters.data_ptr() == win.slices.data_ptr() + slot * 2 * 16 * 16 * 4
    # Same hash family as a plain sketch of the same seed.
    assert win.template.same_family(GLavaSketch.empty(cfg, 0))
    src, dst = keys_to_tensor(np.array([1, 2], np.uint32)), keys_to_tensor(np.array([3, 4], np.uint32))
    new = win.update(src, dst).advance()
    assert float(win.slices.sum()) == 0.0 and win.current == 0
    assert float(new.slices.sum()) == 2 * 2 and new.current == 1
    assert float(new.update_at(2, src, dst).slices[2].sum()) == 2 * 2 and float(new.slices[2].sum()) == 0.0


# -- tests/test_window.py's cases on the port ----------------------------------


def _edge(s, d):
    return keys_to_tensor(np.array([s], np.uint32)), keys_to_tensor(np.array([d], np.uint32))


def test_window_expiry_drops_old_slices():
    cfg = SketchConfig(depth=3, width_rows=64, width_cols=64)
    win = SlidingWindowSketch.empty(cfg, 3, 0)
    win = win.update(*_edge(1, 2))
    win = win.advance().update(*_edge(3, 4))
    win = win.advance().update(*_edge(5, 6))
    assert float(win.window_sketch().counters[0].sum()) == 3.0
    win = win.advance().update(*_edge(7, 8))  # wraps onto slice 0: (1,2) expires
    sk = win.window_sketch()
    assert float(sk.counters[0].sum()) == 3.0
    assert float(queries.edge_query(sk, *_edge(1, 2))[0]) == 0.0


def test_window_sum_equals_manual_merge():
    cfg = SketchConfig(depth=2, width_rows=32, width_cols=32)
    win = SlidingWindowSketch.empty(cfg, 4, 1)
    rng = np.random.default_rng(0)
    kept = []
    for i in range(4):
        src, dst = rng.integers(0, 100, 20).astype(np.uint32), rng.integers(0, 100, 20).astype(np.uint32)
        win.update_(keys_to_tensor(src), keys_to_tensor(dst)).advance_()
        if i:
            kept.append((src, dst))
    # Four advances on four slices: the last wrapped onto slice 0 and zeroed it.
    sk_win = win.window_sketch()
    assert float(sk_win.counters[0].sum()) == 60.0
    ref = GLavaSketch.empty(cfg, 1).update(*(keys_to_tensor(np.concatenate(x)) for x in zip(*kept)))
    assert torch.equal(sk_win.counters, ref.counters) and torch.equal(sk_win.row_flows, ref.row_flows)


def test_decay_variant():
    cfg = SketchConfig(depth=2, width_rows=32, width_cols=32)
    sk = GLavaSketch.empty(cfg, 2)
    sk = sk.update(*(keys_to_tensor(np.array(x, np.uint32)) for x in ([1, 2], [3, 4]))).scale(0.5)
    assert float(sk.counters[0].sum()) == 1.0


# -- the windowed session ------------------------------------------------------


def _workload(query, batch, rng):
    u = rng.integers(0, 300, 64).astype(np.uint32)
    v = rng.integers(0, 300, 64).astype(np.uint32)
    return batch([query.edge(u, v), query.in_flow(u[:16]), query.heavy(u[:8], theta=0.05), query.reach(u[:24], v[:24])])


@pytest.mark.parametrize("preagg", ["off", "on"])
def test_windowed_session_transcript_matches_reference(preagg):
    cfg = RefConfig(depth=3, width_rows=128, width_cols=128)
    ref = RefStream.open(cfg, seed=4, window_slices=3, ingest_backend="scatter", query_backend="jnp", preagg=preagg)
    port = port_session(cfg, seed=4, window_slices=3, preagg=preagg)
    ref_sub = ref.subscribe(_workload(RefQuery, RefBatch, np.random.default_rng(7)), every=1, name="w")
    port_sub = port.subscribe(_workload(Query, QueryBatch, np.random.default_rng(7)), every=1, name="w")
    rng = np.random.default_rng(8)
    for step in range(8):
        s, d, w = _batch(rng, 120)
        for gs in (ref, port):
            gs.ingest(s, d, w)
            if step % 3 == 2:
                gs.advance_window()
    got, want = port_sub.poll(), ref_sub.poll()
    assert [(e.tick, e.epoch) for e in got] == [(e.tick, e.epoch) for e in want] and len(got) == 10
    for g, w in zip(got, want):
        for rg, rw in zip(g.results, w.results):
            assert_same_value(rg.value, rw.value)
    np.testing.assert_array_equal(port.sketch.counters.numpy(), np.asarray(ref.sketch.counters))
    assert port.engine.closure_refreshes == ref.engine.closure_refreshes
    assert port.engine.closure_incremental_refreshes == ref.engine.closure_incremental_refreshes
    # The window is materialized once per mutation, however many readers.
    assert port.window_sums == 10
    with pytest.raises(ValueError, match="non-windowed"):
        port.merge(port)


def test_checkpoint_paths_are_the_reference_keystr_paths():
    from repro.core.sketch import GLavaSketch as RefSketch
    from repro.train import compression as ref_comp, optimizer as ref_opt
    from repro_torch.train import compression as comp, optimizer as opt

    def ref_paths(tree):
        return [jax.tree_util.keystr(kp) for kp, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]

    for cfg in CONFIGS.values():
        ref_win, port_win = _pair(cfg, k=2)
        assert [p for p, _ in tree_paths(port_win)] == ref_paths(ref_win)
        assert [p for p, _ in tree_paths(port_win.window_sketch())] == ref_paths(RefSketch.empty(cfg, jax.random.key(0)))
    params = {"w": torch.zeros(3), "a": {"b": torch.zeros(2)}}
    ref_params = {"w": jnp.zeros(3), "a": {"b": jnp.zeros(2)}}
    state = {"params": params, "opt": opt.init_adamw(opt.AdamWConfig(), params),
             "comp": comp.init_compressor(comp.CompressorConfig(depth=2, width=8), 5, torch.Generator())}
    ref_state = {"params": ref_params, "opt": ref_opt.init_adamw(ref_opt.AdamWConfig(), ref_params),
                 "comp": ref_comp.init_compressor(ref_comp.CompressorConfig(depth=2, width=8), 5, jax.random.key(0))}
    assert [p for p, _ in tree_paths(state)] == ref_paths(ref_state)
