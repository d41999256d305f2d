"""The batch collapse of a card session (``kernels/preagg``) on the CPU: its
plain version against the host collapse ``preaggregate_host`` (the same
pairs and marginals), a sketch updated through ``update_collapsed_`` against
one updated with the host collapse's seven arrays (counters, both registers
and the touched rows bit for bit), and a session driven through the card's
branch against a session on the host's.  The kernel itself runs in
``tests/test_torch_gpu.py``."""
import numpy as np
import pytest
import torch

from repro_torch.api import GraphStream, Query
from repro_torch.core import ingest as ingest_mod
from repro_torch.core.hashing import keys_to_tensor
from repro_torch.core.ingest import bucket_size, pad_bucket, preaggregate_host
from repro_torch.core.sketch import GLavaSketch, SketchConfig
from repro_torch.kernels.preagg.ops import preagg_collapse
from repro_torch.kernels.preagg.ref import collapse_ref, unpack_batch

TOP = np.uint32(0xFFFFFFFF)


def _zipf(rng, n, nodes, a=1.2):
    return ((rng.zipf(a, n) - 1) % nodes).astype(np.uint32)


def _case(name):
    """``(src, dst, weights, directed)`` of one batch."""
    rng = np.random.default_rng(CASES.index(name))
    if name == "zipf":
        n = 20_000
        return _zipf(rng, n, 5_000), _zipf(rng, n, 5_000), rng.integers(1, 9, n).astype(np.float32), True
    if name == "one_pair":
        n = 5_000
        return np.full(n, 7, np.uint32), np.full(n, 9, np.uint32), rng.integers(1, 9, n).astype(np.float32), True
    if name == "all_distinct":
        n = 4_096
        src = rng.permutation(n).astype(np.uint32)
        return src, src + np.uint32(n), rng.integers(1, 9, n).astype(np.float32), True
    if name == "cancelling":
        # Every pair of the first half comes back with the opposite weight;
        # a third of the sources' totals cancel too.
        n = 3_000
        src, dst = _zipf(rng, n, 400), _zipf(rng, n, 400)
        w = rng.integers(1, 9, n).astype(np.float32)
        order = rng.permutation(2 * n)
        return (np.concatenate([src, src])[order], np.concatenate([dst, dst])[order],
                np.concatenate([w, -w])[order], True)
    if name == "extreme_keys":
        n = 6_000
        pool = np.array([0, TOP, 1, TOP - 1, 2**31 - 1, 2**31], np.uint32)
        src, dst = pool[rng.integers(0, 6, n)], pool[rng.integers(0, 6, n)]
        src[::7] = rng.integers(0, 2**32, src[::7].size, dtype=np.uint64).astype(np.uint32)
        return src, dst, rng.integers(1, 9, n).astype(np.float32), True
    if name == "undirected":
        n = 10_000
        return _zipf(rng, n, 2_000), _zipf(rng, n, 2_000), rng.integers(1, 9, n).astype(np.float32), False
    raise ValueError(name)


CASES = ("zipf", "one_pair", "all_distinct", "cancelling", "extreme_keys", "undirected")


def _packed(src, dst, w) -> torch.Tensor:
    return torch.from_numpy(np.stack([src, dst, w.view(np.uint32)]).view(np.int32))


def _by_key(*columns):
    """The rows of numpy columns, sorted by the first columns' keys."""
    cols = [np.asarray(c) for c in columns]
    keys = [c.astype(np.int64) for c in cols if c.dtype.kind in "ui"]
    order = np.lexsort(keys[::-1])
    return [c[order] for c in cols]


def _host_bitmap(sketch: GLavaSketch, pre, directed: bool) -> torch.Tensor:
    keys = pre.src_unique if directed else np.unique(np.concatenate([pre.src_unique, pre.dst_unique]))
    rows = sketch.row_hash(keys_to_tensor(keys))
    bitmap = torch.zeros((sketch.depth, sketch.config.width_rows), dtype=torch.bool)
    bitmap[torch.arange(sketch.depth)[:, None], rows] = True
    return bitmap


@pytest.mark.parametrize("case", CASES)
def test_collapse_equals_the_host_collapse(case):
    """The plain version's pairs and marginals are ``preaggregate_host``'s
    (as multisets), and a sketch updated through ``update_collapsed_`` is
    bit-identical to one given the host collapse's padded arrays: counters,
    both registers, and the touched rows (the distinct sources', mirrored
    the destinations' too)."""
    src, dst, w, directed = _case(case)
    pre = preaggregate_host(src, dst, w)
    s, d, ww = unpack_batch(_packed(src, dst, w))
    ps, pd, pw, su, st, du, dt = (x.numpy() for x in collapse_ref(s, d, ww))
    for got, want in (((ps, pd, pw), (pre.src, pre.dst, pre.weights)), ((su, st), (pre.src_unique, pre.src_totals)),
                      ((du, dt), (pre.dst_unique, pre.dst_totals))):
        for g, e in zip(_by_key(*got), _by_key(*want), strict=True):
            np.testing.assert_array_equal(g.astype(e.dtype), e)

    cfg = SketchConfig(depth=3, width_rows=512, width_cols=256 if directed else 512, directed=directed)
    card = GLavaSketch.empty(cfg, 5)
    host = card.clone()
    _, touched = card.update_collapsed_(_packed(src, dst, w), track_rows=True)
    fields = ("src", "dst", "weights", "src_unique", "src_totals", "dst_unique", "dst_totals")
    host.update_preaggregated_(*(keys_to_tensor(x) if x.dtype == np.uint32 else torch.from_numpy(x)
                                 for x in (pad_bucket(getattr(pre, f)) for f in fields)))
    for name in ("counters", "row_flows", "col_flows"):
        assert torch.equal(getattr(card, name), getattr(host, name)), name
    assert torch.equal(touched, _host_bitmap(host, pre, directed))


def test_collapse_pads_to_the_bucket_and_leaves_no_bitmap_untracked():
    src, dst, w, _ = _case("zipf")
    cfg = SketchConfig(depth=2, width_rows=256, width_cols=256)
    sk = GLavaSketch.empty(cfg, 0)
    s, d, ww = preagg_collapse(_packed(src, dst, w), sk.row_flows, sk.col_flows, None, sk.row_hash, sk.col_hash)
    n_pairs = preaggregate_host(src, dst, w).n_pairs
    assert s.shape == d.shape == ww.shape == (bucket_size(src.size),)
    assert s.dtype == d.dtype == torch.int64 and ww.dtype == torch.float32
    assert bool((ww[n_pairs:] == 0).all()) and int(s[n_pairs:].abs().sum()) == 0
    assert sk.update_collapsed_(_packed(src, dst, w))[1] is None


@pytest.mark.parametrize("bad", ["dtype", "rows", "shape", "bitmap"])
def test_collapse_checks_its_operands(bad):
    src, dst, w, _ = _case("one_pair")
    sk = GLavaSketch.empty(SketchConfig(depth=2, width_rows=128, width_cols=64), 0)
    batch, touched = _packed(src, dst, w), None
    if bad == "dtype":
        batch = batch.long()
    elif bad == "rows":
        batch = batch[:2].contiguous()
    elif bad == "shape":
        touched = torch.zeros((2, 64), dtype=torch.bool)
    else:
        touched = torch.zeros((2, 128), dtype=torch.uint8)
    with pytest.raises(ValueError):
        preagg_collapse(batch, sk.row_flows, sk.col_flows, touched, sk.row_hash, sk.col_hash)


@pytest.mark.parametrize("directed", [True, False], ids=["directed", "undirected"])
def test_session_through_the_card_branch_equals_the_host_branch(directed):
    """A session taking the card's branch (its plain version on the CPU)
    against one collapsing on the host: the same summary, answers and
    closures over zipf batches with standing edge, in-flow, heavy and reach
    queries, its receipts carrying ``touched_rows``; the bitmap drives the
    same incremental closure refreshes as the keys."""
    cfg = SketchConfig(depth=3, width_rows=1024, width_cols=1024, directed=directed)
    host, card = (GraphStream.open(cfg, seed=3, device="cpu") for _ in range(2))
    card._device_collapse = True
    rng = np.random.default_rng(4)
    qs, qd = _zipf(rng, 64, 150), _zipf(rng, 64, 150)
    for gs in (host, card):
        gs.subscribe(Query.edge(qs, qd), Query.in_flow(qs), Query.heavy(qs, theta=0.01), Query.reach(qs, qd), every=1)
    for i in range(8):
        n = 2_000
        src, dst = _zipf(rng, n, 150), _zipf(rng, n, 150)
        w = rng.integers(1, 9, n).astype(np.float32)
        a, b = host.ingest(src, dst, w), card.ingest(src, dst, w)
        assert a.touched_rows is None and b.touched_keys is None
        assert b.touched_rows.shape == (3, 1024) and b.touched_rows.dtype == torch.bool
    for name in ("counters", "row_flows", "col_flows"):
        assert torch.equal(getattr(host._live(), name), getattr(card._live(), name)), name
    assert card.stats.device_collapses == 8 and host.stats.device_collapses == 0
    assert card.engine.closure_incremental_refreshes == host.engine.closure_incremental_refreshes > 0
    for ea, eb in zip(host.events(), card.events(), strict=True):
        assert (ea.tick, ea.epoch) == (eb.tick, eb.epoch)
        for ra, rb in zip(ea.results, eb.results, strict=True):
            va = ra.value if isinstance(ra.value, tuple) else (ra.value,)
            vb = rb.value if isinstance(rb.value, tuple) else (rb.value,)
            assert all(np.array_equal(x, y) for x, y in zip(va, vb, strict=True))
    assert torch.equal(host.engine.closure_for(host._live(), host.epoch),
                       card.engine.closure_for(card._live(), card.epoch))


@pytest.mark.parametrize("directed", [True, False], ids=["directed", "undirected"])
def test_card_branch_mixing_batch_sizes_keeps_one_delta_form(directed):
    """A session taking the card's branch, its batches of 2,000 collapsed and
    those of 500 (below ``PREAGG_MIN_BATCH``) not, hands a row bitmap for
    every batch; a reach query every two batches sees each order of the two
    (collapsed then raw, raw then collapsed) between closure syncs, with the
    answers, incremental refreshes and closures of a host session."""
    cfg = SketchConfig(depth=3, width_rows=2048, width_cols=2048, directed=directed)
    host, card = (GraphStream.open(cfg, seed=5, device="cpu") for _ in range(2))
    card._device_collapse = True
    rng = np.random.default_rng(6)
    qs, qd = _zipf(rng, 64, 300), _zipf(rng, 64, 300)
    for gs in (host, card):
        gs.subscribe(Query.edge(qs, qd), Query.reach(qs, qd), every=2)
    for n in (2_000, 500, 500, 2_000, 2_000, 500, 500, 500):
        src, dst = _zipf(rng, n, 300), _zipf(rng, n, 300)
        w = rng.integers(1, 9, n).astype(np.float32)
        host.ingest(src, dst, w)
        receipt = card.ingest(src, dst, w)
        assert receipt.touched_keys is None and receipt.touched_rows.shape == (3, 2048)
    assert card.stats.device_collapses == 3
    assert card.engine.closure_incremental_refreshes == host.engine.closure_incremental_refreshes > 0
    events = [list(gs.events()) for gs in (host, card)]
    assert len(events[0]) == 4
    for ea, eb in zip(*events, strict=True):
        for ra, rb in zip(ea.results, eb.results, strict=True):
            assert np.array_equal(ra.value, rb.value)
    assert torch.equal(host.engine.closure_for(host._live(), host.epoch),
                       card.engine.closure_for(card._live(), card.epoch))


def test_card_branch_hands_no_delta_for_a_delete_and_counts_windows():
    """A batch with a negative weight hands ``None`` on the card's branch
    (the next closure sync rebuilds); a windowed session collapses into its
    active slice."""
    cfg = SketchConfig(depth=2, width_rows=256, width_cols=256)
    rng = np.random.default_rng(8)
    src, dst = _zipf(rng, 2_000, 100), _zipf(rng, 2_000, 100)
    w = rng.integers(1, 9, 2_000).astype(np.float32)
    gs = GraphStream.open(cfg, seed=1, device="cpu")
    gs._device_collapse = True
    assert gs.ingest(src, dst, w).touched_rows is not None
    w[3] = -1.0
    receipt = gs.ingest(src, dst, w)
    assert receipt.touched_rows is None and receipt.touched_keys is None and gs._touched is None
    host, card = (GraphStream.open(cfg, seed=1, device="cpu", window_slices=3) for _ in range(2))
    card._device_collapse = True
    for gs in (host, card):
        gs.ingest(src, dst, np.abs(w))
        gs.advance_window()
        gs.ingest(dst, src, np.abs(w))
    assert card.stats.device_collapses == 2
    for name in ("counters", "row_flows", "col_flows"):
        assert torch.equal(getattr(host._live(), name), getattr(card._live(), name)), name


def test_cpu_sessions_keep_the_host_collapse(monkeypatch):
    """On the CPU a session collapses on the host, and below
    ``PREAGG_MIN_BATCH`` not at all."""
    calls = []
    real = ingest_mod.preaggregate_host
    import repro_torch.api.stream as stream_mod

    monkeypatch.setattr(stream_mod, "preaggregate_host", lambda *a: calls.append(1) or real(*a))
    gs = GraphStream.open(SketchConfig(depth=2, width_rows=128, width_cols=128), device="cpu")
    assert not gs._device_collapse and gs._host_collapse
    rng = np.random.default_rng(0)
    for n in (ingest_mod.PREAGG_MIN_BATCH, ingest_mod.PREAGG_MIN_BATCH - 1):
        gs.ingest(_zipf(rng, n, 50), _zipf(rng, n, 50))
    assert calls == [1] and gs.stats.device_collapses == 0
