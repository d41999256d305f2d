"""Shared helpers of the port's parity tests: carry a reference sketch across
to the port through numpy, open a reference session and a port session on
the same sketch, draw hashed batches from a numpy seed, and compare the two
sides' state."""
import numpy as np
import torch

from repro_torch.convert import sketch_from_arrays
from repro_torch.core.sketch import SketchConfig


def port_config(cfg) -> SketchConfig:
    return SketchConfig(
        depth=cfg.depth, width_rows=cfg.width_rows, width_cols=cfg.width_cols,
        directed=cfg.directed,
    )


def to_port(sk, device="cpu"):
    """The port's GLavaSketch holding the reference sketch ``sk``'s leaves."""
    square = sk.config.is_square
    return sketch_from_arrays(
        port_config(sk.config),
        np.asarray(sk.counters),
        np.asarray(sk.row_flows),
        np.asarray(sk.col_flows),
        np.asarray(sk.row_hash.a),
        np.asarray(sk.row_hash.b),
        None if square else np.asarray(sk.col_hash.a),
        None if square else np.asarray(sk.col_hash.b),
        device=device,
    )


def window_to_port(win, device="cpu"):
    """The port's SlidingWindowSketch holding the reference window ``win``'s
    leaves."""
    from repro_torch.convert import window_from_arrays

    t = win.template
    square = t.config.is_square
    return window_from_arrays(
        port_config(t.config),
        np.asarray(win.slices),
        np.asarray(win.current),
        np.asarray(win.row_flows),
        np.asarray(win.col_flows),
        np.asarray(t.row_hash.a),
        np.asarray(t.row_hash.b),
        None if square else np.asarray(t.col_hash.a),
        None if square else np.asarray(t.col_hash.b),
        device=device,
    )


def port_session(cfg, seed=0, window_slices=None, **kwargs):
    """A port session (on the CPU) whose hash family is the one a reference
    session opened with ``cfg`` and ``seed`` draws: an empty reference
    sketch (or window of ``window_slices``) carried across; ``kwargs`` go to
    the port's ``GraphStream.open``."""
    import jax
    from repro.core.sketch import GLavaSketch as RefSketch
    from repro.core.window import SlidingWindowSketch as RefWindow
    from repro_torch.api import GraphStream

    key = jax.random.key(seed)
    if window_slices:
        sk = window_to_port(RefWindow.empty(cfg, window_slices, key))
    else:
        sk = to_port(RefSketch.empty(cfg, key))
    return GraphStream.open(sketch=sk, device="cpu", **kwargs)


def fleet_to_port(state, device="cpu"):
    """The port's FleetSketch holding the reference stack ``state``'s leaves."""
    from repro_torch.convert import fleet_from_arrays

    square = state.config.is_square
    return fleet_from_arrays(
        port_config(state.config),
        np.asarray(state.counters),
        np.asarray(state.row_flows),
        np.asarray(state.col_flows),
        np.asarray(state.cursor),
        np.asarray(state.row_hash.a),
        np.asarray(state.row_hash.b),
        None if square else np.asarray(state.col_hash.a),
        None if square else np.asarray(state.col_hash.b),
        device=device,
    )


def port_fleet(cfg, seed=0, capacity=8, window_slices=None, **kwargs):
    """A port fleet (on the CPU) whose hash family is the one a reference
    fleet opened with ``cfg`` and ``seed`` draws: an empty reference stack
    carried across; ``kwargs`` go to the port's ``SketchFleet``."""
    import jax
    from repro.fleet import FleetSketch as RefFleetSketch
    from repro_torch.fleet import SketchFleet

    fleet = SketchFleet(port_config(cfg), capacity=capacity, seed=seed, window_slices=window_slices,
                        device="cpu", **kwargs)
    fleet._state = fleet_to_port(RefFleetSketch.empty(cfg, capacity, jax.random.key(seed), window_slices or 1))
    return fleet


def head_relative(gs):
    """A windowed session's (slices, row_flows, col_flows) as numpy in
    HEAD-RELATIVE slot order, plus the head slice (or the current slot for
    an arrival-ordered window), for either package: two runs of one logical
    stream may rotate the ring differently while holding the same slices."""
    gs.flush()
    w = gs._window
    slices, rows, cols = (np.asarray(x) for x in (w.slices, w.row_flows, w.col_flows))
    head = gs._head_slice
    if head is not None:
        k = w.n_slices
        slot_off = (gs._ring_pos - head) % k
        order = [(head - k + 1 + rel + slot_off) % k for rel in range(k)]
        slices, rows, cols = slices[order], rows[order], cols[order]
    return slices, rows, cols, head if head is not None else int(w.current)


def countmin_to_port(cm, device="cpu"):
    from repro_torch.convert import countmin_from_arrays

    return countmin_from_arrays(np.asarray(cm.counters), np.asarray(cm.hash.a), np.asarray(cm.hash.b), device)


def node_countmin_to_port(ncm, device="cpu"):
    from repro_torch.convert import node_countmin_from_arrays

    return node_countmin_from_arrays(
        np.asarray(ncm.counters_out), np.asarray(ncm.counters_in),
        np.asarray(ncm.hash.a), np.asarray(ncm.hash.b), device,
    )


def countsketch_to_port(cs, device="cpu"):
    from repro_torch.convert import countsketch_from_arrays

    return countsketch_from_arrays(np.asarray(cs.counters), np.asarray(cs.hash.a), np.asarray(cs.hash.b), device)


def gsketch_to_port(gs, device="cpu"):
    from repro_torch.convert import gsketch_from_arrays

    return gsketch_from_arrays(
        np.asarray(gs.partitions.counters), np.asarray(gs.partitions.hash.a),
        np.asarray(gs.partitions.hash.b), np.asarray(gs.widths),
        np.asarray(gs.part_hash.a), np.asarray(gs.part_hash.b), device,
    )


def keys_pair(*arrays):
    """Each numpy uint32 key array as a (jnp array, port int64 tensor) pair."""
    import jax.numpy as jnp

    from repro_torch.core.hashing import keys_to_tensor

    return [(jnp.asarray(a, jnp.uint32), keys_to_tensor(a)) for a in arrays]


def open_pair(cfg, seed=0, **kwargs):
    """A reference session and a port session (on the CPU) holding the same
    sketch; ``kwargs`` (e.g. ``ingest_backend``) go to both."""
    from repro.api import GraphStream as RefStream
    from repro_torch.api import GraphStream

    ref = RefStream.open(cfg, seed=seed, query_backend="jnp", **kwargs)
    port = GraphStream.open(sketch=to_port(ref.sketch), device="cpu", **kwargs)
    assert port.config == port_config(cfg) and port.device.type == "cpu"
    return ref, port


def hashed_batch(rng, d, wr, wc, b, inert_frac=0.1, zero_frac=0.0):
    """Numpy counters (d, wr, wc), registers (d, wr) and (d, wc) holding
    integers, and a hashed batch: rows (d, b) with ``inert_frac`` of them
    -1, cols (d, b), integer weights (b,) with ``zero_frac`` of them 0."""
    counters = rng.integers(0, 1000, (d, wr, wc)).astype(np.float32)
    rf = rng.integers(0, 1000, (d, wr)).astype(np.float32)
    cf = rng.integers(0, 1000, (d, wc)).astype(np.float32)
    rows = rng.integers(0, wr, (d, b)).astype(np.int32)
    rows[rng.random((d, b)) < inert_frac] = -1
    cols = rng.integers(0, wc, (d, b)).astype(np.int32)
    w = rng.integers(1, 9, b).astype(np.float32)
    w[rng.random(b) < zero_frac] = 0.0
    return counters, rf, cf, rows, cols, w


def torch_copies(*arrays):
    """Fresh CPU tensors of numpy arrays (the port updates in place)."""
    return tuple(torch.from_numpy(np.array(a, copy=True)) for a in arrays)


def assert_same_sketch(port, ref, exact=True, err=""):
    for name in ("counters", "row_flows", "col_flows"):
        got = getattr(port, name).cpu().numpy()
        want = np.asarray(getattr(ref, name))
        if exact:
            np.testing.assert_array_equal(got, want, err_msg=f"{name} {err}")
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5, err_msg=f"{name} {err}")


def assert_same_value(got, want, exact=True):
    """Compare one QueryResult value (scalar, array, or heavy's pair)."""
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            assert_same_value(g, w, exact)
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, g.dtype, w.shape, w.dtype)
    if exact or g.dtype == bool:
        np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-5)


# -- training side -------------------------------------------------------------


def ref_transformer_config(cfg):
    """The reference's TransformerConfig with the port config ``cfg``'s
    fields (dtypes mapped to jnp; a port ``MoEArgs`` to the reference's,
    without a mesh)."""
    import jax.numpy as jnp
    from repro.models.layers import MoEArgs as RefMoEArgs
    from repro.models.transformer import TransformerConfig as RefConfig

    dtypes = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
    moe = None
    if cfg.moe is not None:
        m = cfg.moe
        moe = RefMoEArgs(n_experts=m.n_experts, top_k=m.top_k, capacity_factor=m.capacity_factor,
                         dense_residual=m.dense_residual, aux_loss_coef=m.aux_loss_coef, partition=m.partition)
    return RefConfig(
        name=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, d_ff=cfg.d_ff, vocab=cfg.vocab, d_head=cfg.d_head,
        norm=cfg.norm, qk_norm=cfg.qk_norm, sliding_window=cfg.sliding_window,
        rope_theta=cfg.rope_theta, tie_embeddings=cfg.tie_embeddings, moe=moe,
        param_dtype=dtypes[cfg.param_dtype], compute_dtype=dtypes[cfg.compute_dtype],
        attn_q_chunk=cfg.attn_q_chunk, remat=cfg.remat, attn_window_slicing=cfg.attn_window_slicing,
    )


def port_transformer_config(ref_cfg, **changes):
    """The port's TransformerConfig with the reference config ``ref_cfg``'s
    fields (its SMOKE configs, say), then ``changes``."""
    import dataclasses

    import jax.numpy as jnp
    from repro_torch.models.layers import MoEArgs
    from repro_torch.models.transformer import TransformerConfig

    dtypes = {jnp.dtype(jnp.float32): torch.float32, jnp.dtype(jnp.bfloat16): torch.bfloat16}
    moe = None
    if ref_cfg.moe is not None:
        m = ref_cfg.moe
        moe = MoEArgs(n_experts=m.n_experts, top_k=m.top_k, capacity_factor=m.capacity_factor,
                      dense_residual=m.dense_residual, aux_loss_coef=m.aux_loss_coef, partition=m.partition)
    cfg = TransformerConfig(
        name=ref_cfg.name, n_layers=ref_cfg.n_layers, d_model=ref_cfg.d_model, n_heads=ref_cfg.n_heads,
        n_kv_heads=ref_cfg.n_kv_heads, d_ff=ref_cfg.d_ff, vocab=ref_cfg.vocab, d_head=ref_cfg.d_head,
        norm=ref_cfg.norm, qk_norm=ref_cfg.qk_norm, sliding_window=ref_cfg.sliding_window,
        rope_theta=ref_cfg.rope_theta, tie_embeddings=ref_cfg.tie_embeddings, moe=moe,
        param_dtype=dtypes[jnp.dtype(ref_cfg.param_dtype)], compute_dtype=dtypes[jnp.dtype(ref_cfg.compute_dtype)],
        attn_q_chunk=ref_cfg.attn_q_chunk, remat=ref_cfg.remat, attn_window_slicing=ref_cfg.attn_window_slicing,
    )
    return dataclasses.replace(cfg, **changes)


def transformer_numpy_params(cfg, seed):
    """A parameter tree of the port config ``cfg``'s shapes drawn with
    numpy (matrices ~ N(0, 1/fan_in), norm weights 1), for both packages:
    faster than the reference's ``init_params`` run eagerly."""
    from repro_torch.models.transformer import param_shapes

    rng = np.random.default_rng(seed)

    def leaf(name, shape):
        if "norm" in name:
            return np.ones(shape, np.float32)
        fan_in = cfg.d_model if name == "embed" else shape[-2]
        return (rng.normal(0, 1, shape) / np.sqrt(fan_in)).astype(np.float32)

    shapes = param_shapes(cfg)
    return {k: ({n: leaf(n, s) for n, s in v.items()} if k == "layers" else leaf(k, v)) for k, v in shapes.items()}


def numpy_tree(tree):
    """A reference pytree of arrays (dicts and lists) as the same nesting of
    float32 numpy arrays, for the port's ``convert.*_from_arrays``."""
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [numpy_tree(v) for v in tree]
    return np.asarray(tree, np.float32)


def compressor_to_port(state, device="cpu"):
    """The port's CompressorState holding the reference state's leaves."""
    from repro_torch.convert import compressor_state_from_arrays
    from repro_torch.train.compression import CompressorConfig

    c = state.config
    return compressor_state_from_arrays(
        CompressorConfig(depth=c.depth, width=c.width, top_k=c.top_k, momentum=c.momentum),
        np.asarray(state.error), np.asarray(state.momentum),
        np.asarray(state.hash.a), np.asarray(state.hash.b), device=device,
    )


# -- the other models (GAT, SchNet, DimeNet, BERT4Rec) -------------------------


def assert_tree_close(port, ref, **tol):
    """Every leaf of the port's tree (dicts and lists of tensors) against
    the reference pytree's, leaf for leaf in ``jax.tree`` order."""
    import jax

    from repro_torch.tree import tree_leaves

    ref_leaves = jax.tree_util.tree_leaves(ref)
    port_leaves = tree_leaves(port)
    assert len(port_leaves) == len(ref_leaves)
    for p, r in zip(port_leaves, ref_leaves):
        assert tuple(p.shape) == np.shape(r)
        np.testing.assert_allclose(p.detach().cpu().numpy(), np.asarray(r), **tol)


GRAPH_KEYS = ("node_feat", "edge_src", "edge_dst", "node_mask", "edge_mask", "positions", "graph_ids")


def graph_pair(data):
    """The port's and the reference's GraphBatch on the same numpy arrays
    (``data`` holds the GraphBatch fields, ``triplets`` a dict of three)."""
    import jax.numpy as jnp
    from repro.models.gnn.common import GraphBatch as RefBatch
    from repro_torch.models.gnn.common import GraphBatch

    fields = {k: data[k] for k in GRAPH_KEYS if data.get(k) is not None}
    trip = data.get("triplets")
    port = GraphBatch(**{k: torch.from_numpy(np.array(v)) for k, v in fields.items()},
                      triplets=None if trip is None else {k: torch.from_numpy(np.array(trip[k]))
                                                          for k in ("in", "out", "mask")})
    ref = RefBatch(**{k: jnp.asarray(v) for k, v in fields.items()},
                   triplets=None if trip is None else {k: jnp.asarray(trip[k]) for k in ("in", "out", "mask")})
    return port, ref
