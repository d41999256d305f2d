"""Parity of the port's sketch-sampled GraphSAGE path with the reference:
``data/graphs.py`` (``citation_graph``, ``build_triplets``,
``triplet_budget``), ``models/gnn/{common,sampler,graphsage}.py``,
``convert.py::graphsage_params_from_arrays`` and
``launch/gnn_sketch_sampling.py`` against ``examples/gnn_sketch_sampling.py``.

The numpy parts (the graph, the triplets, the CSR sampler) are bit-equal
for the same ``np.random.default_rng`` seed.  The segment ops match
``jax.ops.segment_*`` with masks within ``rtol=1e-6, atol=1e-6`` (float32
sums in another order), GraphSAGE's forward on converted parameters within
``rtol=1e-5, atol=1e-5``, and one training step (loss, gradients, and the
parameters after AdamW) within ``rtol=1e-5, atol=1e-6`` (a float32 forward
and backward through two segment means and two L2 norms).  The port's
script reproduces the example's loop, rebuilt here from the reference
modules on the same seed, parameters and hash family: the degree estimates
are equal and the first 5 losses agree within ``rtol=1e-5``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import triplet_budget as ref_triplet_budget
from repro.data import graphs as ref_graphs
from repro.integration.sketch_sampler import StreamingDegreeSketch as RefDegree
from repro.integration.sketch_sampler import sketch_weighted_seeds as ref_seeds
from repro.core.sketch import SketchConfig as RefConfig
from repro.models.gnn import common as ref_common, graphsage as ref_sage, sampler as ref_sampler
from repro.train import optimizer as ref_opt
from repro_torch.convert import graphsage_params_from_arrays
from repro_torch.data import graphs
from repro_torch.launch import gnn_sketch_sampling as script
from repro_torch.models.gnn import common, graphsage, sampler
from repro_torch.models.gnn.common import GraphBatch
from repro_torch.train import optimizer as opt_mod
from repro_torch.tree import tree_leaves

from _torch_parity import assert_tree_close, numpy_tree, to_port

TOL = dict(rtol=1e-6, atol=1e-6)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


# -- data ----------------------------------------------------------------------------


@pytest.mark.parametrize("n_nodes,n_edges,d_feat,n_classes", [(50, 300, 8, 3), (2000, 12000, 32, 5)])
def test_citation_graph_is_bit_equal(n_nodes, n_edges, d_feat, n_classes):
    """The same arrays and dtypes, and the generator left in the same state."""
    rng_p, rng_r = np.random.default_rng(4), np.random.default_rng(4)
    got = graphs.citation_graph(n_nodes, n_edges, d_feat, n_classes, rng_p)
    want = ref_graphs.citation_graph(n_nodes, n_edges, d_feat, n_classes, rng_r)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert rng_p.integers(0, 2**62) == rng_r.integers(0, 2**62)


@pytest.mark.parametrize("budget,masked", [(None, False), (None, True), (25, False)])
def test_build_triplets_is_bit_equal(budget, masked):
    """Full lists, a masked edge set, and a budget that truncates."""
    rng = np.random.default_rng(6)
    src, dst = rng.integers(0, 12, 60).astype(np.int32), rng.integers(0, 12, 60).astype(np.int32)
    mask = rng.random(60) < 0.7 if masked else None
    got = graphs.build_triplets(src, dst, budget, mask)
    want = ref_graphs.build_triplets(src, dst, budget, mask)
    assert got["truncated"] == want["truncated"] == (budget is not None)
    for k in ("in", "out", "mask"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert graphs.triplet_budget(60) == ref_triplet_budget(60)
    assert graphs.triplet_budget(1 << 25) == ref_triplet_budget(1 << 25) == graphs.TRIPLET_CAP


def test_sampler_is_bit_equal():
    """The CSR, neighbour draws, padded subgraphs (with features) and
    degree-weighted seeds from the same generator."""
    rng = np.random.default_rng(8)
    g = ref_graphs.citation_graph(300, 1500, 6, 3, rng)
    iso = 299  # an isolated node samples itself
    keep = (g["edge_dst"] != iso) & (g["edge_src"] != iso)
    src, dst = g["edge_src"][keep], g["edge_dst"][keep]
    csr, ref_csr = sampler.CSRGraph.from_edges(src, dst, 300), ref_sampler.CSRGraph.from_edges(src, dst, 300)
    np.testing.assert_array_equal(csr.indptr, ref_csr.indptr)
    np.testing.assert_array_equal(csr.indices, ref_csr.indices)
    assert sampler.sampled_block_sizes(16, (5, 3)) == ref_sampler.sampled_block_sizes(16, (5, 3))
    rng_p, rng_r = np.random.default_rng(2), np.random.default_rng(2)
    seeds = np.array([0, 5, iso, 17], np.int32)
    got = sampler.sample_subgraph(csr, seeds, (4, 3), rng_p, features=g["node_feat"])
    want = ref_sampler.sample_subgraph(ref_csr, seeds, (4, 3), rng_r, features=g["node_feat"])
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert np.all(got["nodes"][12:16] == iso)  # seed 2's first-hop draws
    deg = csr.degree(np.arange(300))
    np.testing.assert_array_equal(sampler.degree_weighted_seeds(deg, 32, rng_p),
                                  ref_sampler.degree_weighted_seeds(deg, 32, rng_r))


# -- the segment ops --------------------------------------------------------------------


def _edges(seed=0, n=40, e=300, h=6):
    """Edges into n nodes, the last 5 nodes receiving none; a mask with
    some edges off (every edge into node 3 among them)."""
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, n - 5, e).astype(np.int32)
    src = rng.integers(0, n, e).astype(np.int32)
    mask = (rng.random(e) < 0.8) & (dst != 3)
    msgs = rng.normal(0, 2, (e, h)).astype(np.float32)
    return src, dst, mask, msgs, n


@pytest.mark.parametrize("op", ["scatter_sum", "scatter_mean", "scatter_max", "segment_softmax"])
@pytest.mark.parametrize("masked", [False, True])
def test_segment_ops_match_reference(op, masked):
    _, dst, mask, msgs, n = _edges()
    m = mask if masked else None
    got = getattr(common, op)(_t(msgs), _t(dst), n, None if m is None else _t(m))
    want = getattr(ref_common, op)(jnp.asarray(msgs), jnp.asarray(dst), n, None if m is None else jnp.asarray(m))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_readout_distances_and_mlp_match_reference():
    src, dst, mask, msgs, n = _edges(1)
    rng = np.random.default_rng(3)
    graph_ids = np.sort(rng.integers(0, 4, n)).astype(np.int32)
    node_mask = rng.random(n) < 0.9
    vals = rng.normal(0, 1, (n, 5)).astype(np.float32)
    np.testing.assert_allclose(
        common.graph_readout_sum(_t(vals), _t(graph_ids), 4, _t(node_mask)).numpy(),
        np.asarray(ref_common.graph_readout_sum(jnp.asarray(vals), jnp.asarray(graph_ids), 4, jnp.asarray(node_mask))),
        **TOL)
    pos = rng.normal(0, 3, (n, 3)).astype(np.float32)
    pos[src[0]] = pos[dst[0]]  # a zero-length edge: the 1e-12 floor
    d, diff = common.edge_distances(_t(pos), _t(src), _t(dst), _t(mask))
    rd, rdiff = ref_common.edge_distances(jnp.asarray(pos), jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask))
    np.testing.assert_allclose(d.numpy(), np.asarray(rd), **TOL)
    np.testing.assert_allclose(diff.numpy(), np.asarray(rdiff), **TOL)
    ref_ps = ref_common.mlp_params(jax.random.key(2), (6, 16, 3), prefix="m_")
    ps = {k: _t(v) for k, v in ref_ps.items()}
    for final_act in (False, True):
        np.testing.assert_allclose(
            common.mlp_apply(ps, _t(msgs), 2, prefix="m_", final_act=final_act).numpy(),
            np.asarray(ref_common.mlp_apply(ref_ps, jnp.asarray(msgs), 2, prefix="m_", final_act=final_act)),
            rtol=1e-5, atol=1e-5)
    port_ps = common.mlp_params(torch.Generator().manual_seed(0), (6, 16, 3), prefix="m_")
    assert {k: tuple(v.shape) for k, v in port_ps.items()} == {k: v.shape for k, v in ref_ps.items()}


# -- GraphSAGE ------------------------------------------------------------------------


CFG_KW = dict(name="sage-test", n_layers=2, d_in=12, d_hidden=16, out_dim=4)


def _subgraph(seed=5, n_seeds=8):
    rng = np.random.default_rng(seed)
    g = ref_graphs.citation_graph(200, 1200, CFG_KW["d_in"], CFG_KW["out_dim"], rng)
    csr = ref_sampler.CSRGraph.from_edges(g["edge_src"], g["edge_dst"], 200)
    seeds = rng.choice(200, n_seeds, replace=False).astype(np.int32)
    sub = ref_sampler.sample_subgraph(csr, seeds, (4, 3), rng, features=g["node_feat"])
    sub["edge_mask"][::7] = False  # some padding-like edges
    return sub, g["labels"][seeds]


def _batches(sub):
    keys = ("node_feat", "edge_src", "edge_dst", "node_mask", "edge_mask")
    ref = ref_common.GraphBatch(**{k: jnp.asarray(sub[k]) for k in keys})
    port = GraphBatch(**{k: _t(sub[k]) for k in keys})
    return port, ref


def _params():
    ref_cfg = ref_sage.SAGEConfig(**CFG_KW)
    ref_params = ref_sage.init_params(ref_cfg, jax.random.key(1))
    cfg = graphsage.SAGEConfig(**CFG_KW)
    return cfg, graphsage_params_from_arrays(cfg, numpy_tree(ref_params)), ref_cfg, ref_params


def test_graphsage_forward_matches_reference():
    cfg, params, ref_cfg, ref_params = _params()
    sub, _ = _subgraph()
    port_b, ref_b = _batches(sub)
    got = graphsage.forward(cfg, params, port_b)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_sage.forward(ref_cfg, ref_params, ref_b)),
                               rtol=1e-5, atol=1e-5)
    fresh = graphsage.init_params(cfg, torch.Generator().manual_seed(0))
    assert [tuple(x.shape) for x in tree_leaves(fresh)] == [x.shape for x in jax.tree_util.tree_leaves(ref_params)]
    with pytest.raises(ValueError, match="head"):
        graphsage_params_from_arrays(cfg, {**numpy_tree(ref_params), "head": np.zeros((3, 3), np.float32)})


def test_one_training_step_matches_reference():
    """Loss, gradients and the parameters after ``apply_adamw``: the port's
    ``torch.autograd`` step against ``jax.value_and_grad`` and the
    reference's ``apply_adamw``, at the example's optimizer settings."""
    cfg, params, ref_cfg, ref_params = _params()
    sub, labels = _subgraph()
    port_b, ref_b = _batches(sub)
    n = labels.shape[0]
    ref_ocfg = ref_opt.AdamWConfig(lr=5e-3, warmup_steps=10, total_steps=120, weight_decay=0.0)
    ocfg = opt_mod.AdamWConfig(lr=5e-3, warmup_steps=10, total_steps=120, weight_decay=0.0)

    def lfn(p):
        logits = ref_sage.forward(ref_cfg, p, ref_b)[:n].astype(jnp.float32)
        logz = jax.nn.logsumexp(logits, -1)
        gold = jnp.take_along_axis(logits, jnp.asarray(labels)[:, None], 1)[:, 0]
        return jnp.mean(logz - gold)

    ref_loss, ref_grads = jax.value_and_grad(lfn)(ref_params)
    ref_new, _, _ = ref_opt.apply_adamw(ref_ocfg, ref_opt.init_adamw(ref_ocfg, ref_params), ref_params, ref_grads)

    (loss, _), grads = script.value_and_grad(script.loss_fn(cfg, n), params, {"graph": port_b, "labels": _t(labels)})
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    assert_tree_close(grads, ref_grads, rtol=1e-5, atol=1e-6)
    new, _, loss2, acc = script.train_step(cfg, ocfg, params, opt_mod.init_adamw(ocfg, params), port_b, _t(labels))
    assert float(loss2) == float(loss) and 0.0 <= float(acc) <= 1.0
    assert_tree_close(new, ref_new, rtol=1e-5, atol=1e-6)


# -- the script against the example ------------------------------------------------------


def _example_losses(steps):
    """``examples/gnn_sketch_sampling.py``'s loop, rebuilt from the reference
    modules for ``steps`` steps; its degree sketch's empty state and initial
    parameters are returned for the port."""
    N, E, F, C = script.N, script.E, script.F, script.C
    rng = np.random.default_rng(0)
    g = ref_graphs.citation_graph(N, E, F, C, rng)
    csr = ref_sampler.CSRGraph.from_edges(g["edge_src"], g["edge_dst"], N)
    deg = RefDegree(RefConfig(depth=4, width_rows=512, width_cols=512))
    empty = to_port(deg.sketch)
    for lo in range(0, E, 4096):
        deg.observe(g["edge_src"][lo:lo + 4096], g["edge_dst"][lo:lo + 4096])
    est = deg.degree_estimates(np.arange(N, dtype=np.uint32), direction="in")
    cfg = ref_sage.SAGEConfig(name="sage-stream", n_layers=2, d_in=F, d_hidden=32, out_dim=C)
    params = ref_sage.init_params(cfg, jax.random.key(0))
    init = numpy_tree(params)
    opt_cfg = ref_opt.AdamWConfig(lr=5e-3, warmup_steps=10, total_steps=120, weight_decay=0.0)
    opt = ref_opt.init_adamw(opt_cfg, params)

    @jax.jit
    def train_step(params, opt, batch, labels):
        def lfn(p):
            gb = ref_common.GraphBatch(node_feat=batch["node_feat"], edge_src=batch["edge_src"],
                                       edge_dst=batch["edge_dst"], node_mask=batch["node_mask"],
                                       edge_mask=batch["edge_mask"])
            logits = ref_sage.forward(cfg, p, gb)[:script.BATCH].astype(jnp.float32)
            logz = jax.nn.logsumexp(logits, -1)
            gold = jnp.take_along_axis(logits, labels[:, None], 1)[:, 0]
            return jnp.mean(logz - gold), logits

        (loss, logits), grads = jax.value_and_grad(lfn, has_aux=True)(params)
        params, opt, _ = ref_opt.apply_adamw(opt_cfg, opt, params, grads)
        return params, opt, loss

    losses = []
    for _ in range(steps):
        seeds = ref_seeds(deg, N, script.BATCH, rng, alpha=0.5)
        sub = ref_sampler.sample_subgraph(csr, seeds, script.FANOUTS, rng, features=g["node_feat"])
        batch = {k: jnp.asarray(v) for k, v in sub.items() if k != "seed_slots"}
        params, opt, loss = train_step(params, opt, batch, jnp.asarray(g["labels"][seeds]))
        losses.append(float(loss))
    return losses, est, empty, init, cfg


def test_script_reproduces_the_example_loop():
    losses, est, empty, init, ref_cfg = _example_losses(5)
    cfg = graphsage.SAGEConfig(name="sage-stream", n_layers=2, d_in=script.F, d_hidden=32, out_dim=script.C)
    lines = []
    run = script.main(device="cpu", steps=5, params=graphsage_params_from_arrays(cfg, init), sketch=empty,
                      log=lines.append)
    np.testing.assert_array_equal(run.estimates, est)
    np.testing.assert_allclose(run.losses, losses, rtol=1e-5)
    assert lines[0].startswith("[gnn] sketch degree estimates: corr(est, exact) = ")
    assert lines[0].endswith("(over-estimates: True)")
    assert lines[1].startswith("[gnn] step   0 loss=") and lines[-1].startswith("[gnn] final seed accuracy")
    assert len(run.step_s) == 5 and run.corr == pytest.approx(np.corrcoef(est, run.exact)[0, 1])


def test_script_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        script.main(steps=1)
