"""Parity of the port's GAT, SchNet and DimeNet (``models/gnn/{gat,schnet,
dimenet}.py``), ``data/graphs.py::molecule_batch`` and
``convert.py::{gat,schnet,dimenet}_params_from_arrays`` with the reference,
at the SMOKE configs' widths.

``molecule_batch`` is bit-equal for the same ``np.random.default_rng`` seed
and leaves the generator in the same state.  Forward passes on converted
parameters agree within ``rtol=1e-5, atol=1e-5`` (float32 sums in another
order): both SchNet feature modes and both tasks, ``forward`` against
``forward_ngraphs``, masked edges, padded triplets, and molecule batches
with self-loops (``src`` and ``dst`` are drawn independently, so a
zero-length edge meets the distance floor).  One training step (the loss of
``launch/steps.py``'s GNN step, its gradients and the parameters after
AdamW) agrees with ``jax.value_and_grad`` and the reference's
``apply_adamw`` within ``rtol=1e-4, atol=1e-6``.  SchNet's RBF centres are
bit-equal to ``jnp.linspace``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dimenet as ref_dimenet_cfg, gat_cora as ref_gat_cfg, schnet as ref_schnet_cfg
from repro.data import graphs as ref_graphs
from repro.models.gnn import dimenet as ref_dimenet, gat as ref_gat, schnet as ref_schnet
from repro.train import optimizer as ref_opt
from repro_torch import convert
from repro_torch.data import graphs
from repro_torch.models.gnn import dimenet, gat, schnet
from repro_torch.train import optimizer as opt_mod
from repro_torch.tree import tree_leaves, tree_unflatten

from _torch_parity import assert_tree_close, graph_pair, numpy_tree

FWD = dict(rtol=1e-5, atol=1e-5)
STEP = dict(rtol=1e-4, atol=1e-6)

PORT = {"gat": gat, "schnet": schnet, "dimenet": dimenet}
REF = {"gat": ref_gat, "schnet": ref_schnet, "dimenet": ref_dimenet}
CONVERT = {"gat": convert.gat_params_from_arrays, "schnet": convert.schnet_params_from_arrays,
           "dimenet": convert.dimenet_params_from_arrays}
SMOKE = {"gat": ref_gat_cfg.SMOKE, "schnet": ref_schnet_cfg.SMOKE, "dimenet": ref_dimenet_cfg.SMOKE}


def _port_config(model, ref_cfg):
    cls = {"gat": gat.GATConfig, "schnet": schnet.SchNetConfig, "dimenet": dimenet.DimeNetConfig}[model]
    return cls(**dataclasses.asdict(ref_cfg))


def _ref_init(model, ref_cfg, seed):
    return jax.jit(REF[model].init_params, static_argnums=0)(ref_cfg, jax.random.key(seed))


def _ref_forward(model, ref_cfg, params, g, *args):
    """The reference's forward under ``jax.jit`` (one compile, not one an
    operation)."""
    return jax.jit(REF[model].forward, static_argnums=(0, *range(3, 3 + len(args))))(ref_cfg, params, g, *args)


def _params(model, ref_cfg, seed=1):
    """(port config, port params, reference params): the reference's
    ``init_params`` carried across by ``convert``."""
    ref_params = _ref_init(model, ref_cfg, seed)
    cfg = _port_config(model, ref_cfg)
    return cfg, CONVERT[model](cfg, numpy_tree(ref_params)), ref_params


# -- data ------------------------------------------------------------------------------


@pytest.mark.parametrize("n_graphs,nodes,edges,types", [(4, 10, 16, 10), (128, 30, 64, 100)])
def test_molecule_batch_is_bit_equal(n_graphs, nodes, edges, types):
    rng_p, rng_r = np.random.default_rng(3), np.random.default_rng(3)
    got = graphs.molecule_batch(n_graphs, nodes, edges, types, rng_p)
    want = ref_graphs.molecule_batch(n_graphs, nodes, edges, types, rng_r)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])
    assert rng_p.integers(0, 2**62) == rng_r.integers(0, 2**62)
    assert np.any(got["edge_src"] == got["edge_dst"])  # self-loops: the batches the models see


def _molecule(seed=0, n_graphs=4, nodes=10, edges=16, types=10, pad=6, budget=None):
    """A molecule batch with ``pad`` padded edges (at node 0, masked) and
    triplets padded to ``budget`` (masked, at edge 0)."""
    rng = np.random.default_rng(seed)
    d = ref_graphs.molecule_batch(n_graphs, nodes, edges, types, rng)
    assert np.any(d["edge_src"] == d["edge_dst"])
    e = len(d["edge_src"])
    d["edge_src"] = np.concatenate([d["edge_src"], np.zeros(pad, np.int32)])
    d["edge_dst"] = np.concatenate([d["edge_dst"], np.zeros(pad, np.int32)])
    d["edge_mask"] = np.arange(e + pad) < e
    d["edge_mask"][1] = False  # one real edge masked too
    d["node_mask"] = np.ones(n_graphs * nodes, bool)
    d["node_mask"][-1] = False
    trip = ref_graphs.build_triplets(d["edge_src"], d["edge_dst"], budget or 8 * (e + pad), d["edge_mask"])
    assert not trip["truncated"] and trip["mask"].min() == 0.0  # padding present
    d["triplets"] = trip
    return d


def _citation(seed=0, n=60, e=300, d_feat=12, classes=3, pad_nodes=4, pad_edges=20):
    """A citation graph padded with masked nodes and edges (at node 0), its
    labels and a loss mask over real nodes, with triplets."""
    rng = np.random.default_rng(seed)
    d = ref_graphs.citation_graph(n, e, d_feat, classes, rng)
    n2, e2 = n + pad_nodes, e + pad_edges
    d["node_feat"] = np.concatenate([d["node_feat"], np.zeros((pad_nodes, d_feat), np.float32)])
    d["positions"] = np.concatenate([d["positions"], np.zeros((pad_nodes, 3), np.float32)])
    d["labels"] = np.concatenate([d["labels"], np.zeros(pad_nodes, np.int32)])
    d["node_mask"] = np.arange(n2) < n
    d["edge_src"] = np.concatenate([d["edge_src"], np.zeros(pad_edges, np.int32)])
    d["edge_dst"] = np.concatenate([d["edge_dst"], np.zeros(pad_edges, np.int32)])
    d["edge_mask"] = np.arange(e2) < e
    d["loss_mask"] = ((rng.random(n2) < 0.5) & d["node_mask"]).astype(np.float32)
    d["triplets"] = ref_graphs.build_triplets(d["edge_src"], d["edge_dst"], 8 * e2, d["edge_mask"])
    return d


# -- basis functions ------------------------------------------------------------------------


@pytest.mark.parametrize("n_rbf,cutoff", [(300, 10.0), (24, 5.0), (7, 3.0), (1, 2.0)])
def test_rbf_centers_equal_jnp_linspace(n_rbf, cutoff):
    want = np.asarray(jnp.linspace(0.0, cutoff, n_rbf))
    np.testing.assert_array_equal(schnet.rbf_centers(n_rbf, cutoff).numpy(), want)


def test_basis_functions_match_reference():
    rng = np.random.default_rng(5)
    d = np.abs(rng.normal(0, 3, 200)).astype(np.float32)
    d[:3] = [0.0, 1e-7, 10.0]
    cos_a = rng.uniform(-1, 1, 200).astype(np.float32)
    cos_a[:2] = [-1.0, 1.0]
    t = torch.from_numpy
    np.testing.assert_allclose(schnet.rbf_expand(t(d), 300, 10.0).numpy(),
                               np.asarray(ref_schnet.rbf_expand(jnp.asarray(d), 300, 10.0)), **FWD)
    np.testing.assert_allclose(schnet.shifted_softplus(t(d * 10 - 30)).numpy(),
                               np.asarray(ref_schnet.shifted_softplus(jnp.asarray(d * 10 - 30))), **FWD)
    np.testing.assert_allclose(dimenet.bessel_rbf(t(d), 6, 5.0).numpy(),
                               np.asarray(ref_dimenet.bessel_rbf(jnp.asarray(d), 6, 5.0)), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(dimenet.legendre_cos(t(cos_a), 7).numpy(),
                               np.asarray(ref_dimenet.legendre_cos(jnp.asarray(cos_a), 7)), **FWD)
    cfg = ref_dimenet_cfg.FULL
    np.testing.assert_allclose(  # L-major: index l * n_radial + r
        dimenet.spherical_basis(t(d), t(cos_a), _port_config("dimenet", cfg)).numpy(),
        np.asarray(ref_dimenet.spherical_basis(jnp.asarray(d), jnp.asarray(cos_a), cfg)), rtol=1e-5, atol=1e-4)


def test_bilinear_is_the_reference_einsum():
    rng = np.random.default_rng(6)
    sbf, a = rng.normal(0, 1, (50, 42)).astype(np.float32), rng.normal(0, 1, (50, 8)).astype(np.float32)
    w = rng.normal(0, 1, (42, 8, 16)).astype(np.float32)
    want = np.einsum("ts,tb,sbf->tf", sbf.astype(np.float64), a.astype(np.float64), w.astype(np.float64))
    got = dimenet.bilinear(torch.from_numpy(sbf), torch.from_numpy(a), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


# -- forward passes -------------------------------------------------------------------------


def test_gat_forward_matches_reference():
    d = _citation()
    ref_cfg = dataclasses.replace(SMOKE["gat"], d_in=12, out_dim=3)
    cfg, params, ref_params = _params("gat", ref_cfg)
    port_b, ref_b = graph_pair(d)
    got = gat.forward(cfg, params, port_b)
    np.testing.assert_allclose(got.numpy(), np.asarray(_ref_forward("gat", ref_cfg, ref_params, ref_b)), **FWD)


@pytest.mark.parametrize("mode,task", [("embed_types", "graph_reg"), ("embed_types", "node_class"),
                                       ("project", "graph_reg"), ("project", "node_class")])
def test_schnet_forward_matches_reference(mode, task):
    d = _molecule()
    if mode == "project":
        d["node_feat"] = np.random.default_rng(1).normal(0, 1, (len(d["node_mask"]), 5)).astype(np.float32)
    ref_cfg = dataclasses.replace(SMOKE["schnet"], feature_mode=mode, d_in=5 if mode == "project" else 0,
                                  task=task, out_dim=2)
    cfg, params, ref_params = _params("schnet", ref_cfg)
    port_b, ref_b = graph_pair(d)
    got = schnet.forward(cfg, params, port_b).detach().numpy()
    if task == "node_class":
        np.testing.assert_allclose(got, np.asarray(_ref_forward("schnet", ref_cfg, ref_params, ref_b)), **FWD)
        return
    # The reference's graph_reg forward reads max(graph_ids) + 1 = 4 on the
    # host and cannot be jitted; its forward_ngraphs at 4 is the same readout.
    want = np.asarray(jax.jit(ref_schnet.forward_ngraphs, static_argnums=(0, 3))(ref_cfg, ref_params, ref_b, 4))
    np.testing.assert_allclose(got, want, **FWD)
    np.testing.assert_allclose(schnet.forward_ngraphs(cfg, params, port_b, 4).detach().numpy(), want, **FWD)
    assert schnet.forward_ngraphs(cfg, params, port_b, 6).shape == (6, 2)  # empty graphs read 0


@pytest.mark.parametrize("mode,task", [("embed_types", "graph_reg"), ("project", "node_class")])
def test_dimenet_forward_matches_reference(mode, task):
    d = _molecule() if mode == "embed_types" else _citation(n=40, e=160)
    ref_cfg = dataclasses.replace(SMOKE["dimenet"], feature_mode=mode, d_in=12 if mode == "project" else 0,
                                  task=task, out_dim=1 if task == "graph_reg" else 3)
    cfg, params, ref_params = _params("dimenet", ref_cfg)
    port_b, ref_b = graph_pair(d)
    n_graphs = 4 if task == "graph_reg" else 1
    got = dimenet.forward(cfg, params, port_b, n_graphs=n_graphs)
    want = _ref_forward("dimenet", ref_cfg, ref_params, ref_b, n_graphs)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD)


def test_dimenet_at_a_full_triplet_budget():
    """A budget the triplets fill exactly and one that truncates them:
    every padded triplet index is in range, and the outputs agree."""
    d = _molecule(seed=2)
    full = ref_graphs.build_triplets(d["edge_src"], d["edge_dst"], None, d["edge_mask"])
    count = int(full["mask"].sum())
    for budget in (count, count // 2):
        d["triplets"] = ref_graphs.build_triplets(d["edge_src"], d["edge_dst"], budget, d["edge_mask"])
        assert d["triplets"]["mask"].sum() == budget
        assert d["triplets"]["in"].max() < len(d["edge_src"]) and d["triplets"]["out"].max() < len(d["edge_src"])
        ref_cfg = SMOKE["dimenet"]
        cfg, params, ref_params = _params("dimenet", ref_cfg)
        port_b, ref_b = graph_pair(d)
        np.testing.assert_allclose(dimenet.forward(cfg, params, port_b, 4).detach().numpy(),
                                   np.asarray(_ref_forward("dimenet", ref_cfg, ref_params, ref_b, 4)), **FWD)


# -- one training step ----------------------------------------------------------------------


def _ref_loss(model, cfg, params, g, labels, loss_mask, n_graphs):
    """``launch/steps.py``'s GNN loss: MSE for graph_reg, masked
    cross-entropy otherwise."""
    if model == "gat":
        out = ref_gat.forward(cfg, params, g)
    elif model == "schnet":
        out = (ref_schnet.forward_ngraphs(cfg, params, g, n_graphs) if cfg.task == "graph_reg"
               else ref_schnet.forward(cfg, params, g))
    else:
        out = ref_dimenet.forward(cfg, params, g, n_graphs=n_graphs)
    if getattr(cfg, "task", "node_class") == "graph_reg":
        err = (out - labels) ** 2
        return jnp.sum(err[:, 0] * loss_mask) / jnp.maximum(jnp.sum(loss_mask), 1.0)
    logits = out.astype(jnp.float32)
    logz = jax.nn.logsumexp(logits, -1)
    gold = jnp.take_along_axis(logits, labels[:, None].astype(jnp.int32), axis=1)[:, 0]
    return jnp.sum((logz - gold) * loss_mask) / jnp.maximum(jnp.sum(loss_mask), 1.0)


def _port_loss(model, cfg, params, g, labels, loss_mask, n_graphs):
    if model == "gat":
        out = gat.forward(cfg, params, g)
    elif model == "schnet":
        out = (schnet.forward_ngraphs(cfg, params, g, n_graphs) if cfg.task == "graph_reg"
               else schnet.forward(cfg, params, g))
    else:
        out = dimenet.forward(cfg, params, g, n_graphs=n_graphs)
    if getattr(cfg, "task", "node_class") == "graph_reg":
        err = (out - labels) ** 2
        return torch.sum(err[:, 0] * loss_mask) / torch.clamp(torch.sum(loss_mask), min=1.0)
    logz = torch.logsumexp(out, -1)
    gold = torch.gather(out, 1, labels.long()[:, None])[:, 0]
    return torch.sum((logz - gold) * loss_mask) / torch.clamp(torch.sum(loss_mask), min=1.0)


STEP_CASES = [
    ("gat", "node_class", None),
    ("schnet", "graph_reg", "embed_types"),
    ("dimenet", "graph_reg", "embed_types"),
    ("dimenet", "node_class", "project"),
]


@pytest.mark.parametrize("model,task,mode", STEP_CASES)
def test_one_training_step_matches_reference(model, task, mode):
    """Loss, gradients and the parameters after ``apply_adamw``: the port's
    autograd against ``jax.value_and_grad`` and the reference's AdamW."""
    if task == "graph_reg":
        d = _molecule(seed=4)
        labels, loss_mask, n_graphs = d["labels"], np.ones(4, np.float32), 4
        changes = dict(feature_mode=mode, task=task, out_dim=1)
    else:
        d = _citation(seed=4, n=40, e=160)
        labels, loss_mask, n_graphs = d["labels"], d["loss_mask"], 1
        changes = dict(d_in=12, out_dim=3)
        if model != "gat":
            changes.update(feature_mode=mode, task=task)
    ref_cfg = dataclasses.replace(SMOKE[model], **changes)
    cfg, params, ref_params = _params(model, ref_cfg, seed=7)
    port_b, ref_b = graph_pair(d)
    ocfg_kw = dict(lr=5e-3, warmup_steps=2, total_steps=20)
    ref_ocfg, ocfg = ref_opt.AdamWConfig(**ocfg_kw), opt_mod.AdamWConfig(**ocfg_kw)

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(
        lambda p: _ref_loss(model, ref_cfg, p, ref_b, jnp.asarray(labels), jnp.asarray(loss_mask), n_graphs)))(
        ref_params)
    ref_new, _, _ = jax.jit(ref_opt.apply_adamw, static_argnums=0)(
        ref_ocfg, ref_opt.init_adamw(ref_ocfg, ref_params), ref_params, ref_grads)

    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = _port_loss(model, cfg, params, port_b, torch.from_numpy(labels), torch.from_numpy(loss_mask), n_graphs)
    grads = tree_unflatten(params, torch.autograd.grad(loss, leaves))
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=STEP["rtol"])
    assert_tree_close(grads, ref_grads, **STEP)
    new, _, _ = opt_mod.apply_adamw(ocfg, opt_mod.init_adamw(ocfg, params), params, grads)
    assert_tree_close(new, ref_new, **STEP)


# -- parameters and conversion ----------------------------------------------------------------


@pytest.mark.parametrize("model", ["gat", "schnet", "dimenet"])
@pytest.mark.parametrize("which", ["SMOKE", "FULL"])
def test_init_params_have_the_reference_tree(model, which):
    ref_cfg = getattr({"gat": ref_gat_cfg, "schnet": ref_schnet_cfg, "dimenet": ref_dimenet_cfg}[model], which)
    if model != "gat":
        ref_cfg = dataclasses.replace(ref_cfg, feature_mode="project", d_in=9) if which == "SMOKE" else ref_cfg
    cfg = _port_config(model, ref_cfg)
    ref_params = jax.eval_shape(lambda k: REF[model].init_params(ref_cfg, k), jax.random.key(0))
    port = PORT[model].init_params(cfg, torch.Generator().manual_seed(0))
    assert [tuple(x.shape) for x in tree_leaves(port)] == [x.shape for x in jax.tree_util.tree_leaves(ref_params)]
    assert all(x.dtype == torch.float32 for x in tree_leaves(port))
    # A reference tree converts; a wrong shape or a missing leaf is refused.
    shapes = jax.tree_util.tree_map(lambda x: np.zeros(x.shape, np.float32), ref_params)
    CONVERT[model](cfg, shapes)
    leaf = next(iter(shapes["layers"][0])) if model == "gat" else next(iter(shapes["blocks"][0]))
    bad = numpy_tree(shapes)
    (bad["layers"] if model == "gat" else bad["blocks"])[0][leaf] = np.zeros((2, 2), np.float32)
    with pytest.raises(ValueError, match=leaf):
        CONVERT[model](cfg, bad)
    missing = numpy_tree(shapes)
    (missing["layers"] if model == "gat" else missing["blocks"]).pop()
    with pytest.raises(ValueError, match="list"):
        CONVERT[model](cfg, missing)
