"""Step factory: one (arch × shape) cell -> a train or serve step with its
state initialiser, logical sharding specs, dry-run input specs and concrete
smoke batches.  Port of ``src/repro/launch/steps.py``.

This is the seam between the model zoo, the distribution layer and the dry
run: ``build_step(arch, shape)`` returns a :class:`StepBundle` whose
``input_specs()`` and ``state_specs()`` are ``meta``-device tensors (the
counterpart of ``jax.ShapeDtypeStruct`` and ``jax.eval_shape``: shapes and
dtypes at the full production size, nothing allocated, and the state built
from the models' ``param_shapes``, never by drawing the weights), and whose
``make_batch(rng)`` gives the reference's numpy batch for the same
``np.random.Generator``.

``init_state(generator)`` draws the parameters from a ``torch.Generator``
on its own device (the reference's key) and moves them to the bundle's
device (CUDA unless the caller names another); ``step(state, batch)`` is
eager and takes a batch of tensors (:meth:`StepBundle.to_tensors`): a train
step returns ``(state, metrics)`` with the reference's metric keys, a serve
step its outputs.  A ``meta`` bundle runs its step on ``meta`` tensors: the
dry run counts it that way.

The LM production knobs (:func:`_lm_prod_config`) set the reference's GSPMD
constraints as :class:`~repro_torch.distributed.sharding.Placement`s (the
layer carry's and the MoE buffers' layouts, which change no value), and
``optimized=True`` on a rank :class:`~repro_torch.distributed.mesh.Mesh`
switches on the sharded MoE dispatch and the halo attention.  Those sharded
forms take each rank's local shard and are forward only
(``models/layers.py``), so a train step of such a config raises; on an
:class:`~repro_torch.distributed.mesh.AbstractMesh` (the production
layouts) ``optimized`` sets only the window slicing, which runs on one
device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchSpec, ShapeSpec, get_arch, triplet_budget
from repro_torch.data import graphs as graph_data
from repro_torch.data import lm as lm_data
from repro_torch.data import recsys as recsys_data
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.mesh import Mesh
from repro_torch.distributed.sharding import Placement
from repro_torch.models import transformer as tfm
from repro_torch.models.gnn import dimenet, gat, graphsage, schnet
from repro_torch.models.gnn.common import GraphBatch, scatter_sum
from repro_torch.models.gnn.sampler import sampled_block_sizes
from repro_torch.models.recsys import bert4rec
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.trainer import value_and_grad
from repro_torch.tree import tree_map

F32, I32, BF16 = torch.float32, torch.int32, torch.bfloat16

# The perf runner's experiment channel: launch/perf.py drops config-field
# overrides here (e.g. {"attn_q_chunk": None}) so its variants need no
# signature churn.
PERF_OVERRIDES: dict = {}


@dataclasses.dataclass
class StepBundle:
    arch_id: str
    shape_name: str
    kind: str
    config: Any
    init_state: Callable[[torch.Generator], Any]
    step: Callable
    state_logical: Any
    batch_logical: Any
    batch_specs: Dict[str, Any]          # meta tensors, the full batch
    make_batch: Callable[[np.random.Generator], Dict[str, Any]]
    is_train: bool
    state_meta: Any                      # meta tensors, the full state
    device: torch.device
    out_logical: Any = None  # serve kinds: logical specs for outputs
    notes: str = ""
    loss_fn: Optional[Callable] = None  # train kinds: (params, batch) -> (loss, metrics), what step differentiates

    def input_specs(self):
        """``meta`` stand-ins for every model input (dry run)."""
        return self.batch_specs

    def state_specs(self):
        """``meta`` stand-ins for the state ``init_state`` returns."""
        return self.state_meta

    def to_tensors(self, batch, device: DeviceLike = None):
        """A numpy batch (``make_batch``'s) as tensors of the specs' dtypes on
        ``device`` (the bundle's by default)."""
        device = self.device if device is None else torch.device(device)
        return tree_map(lambda x, spec: torch.as_tensor(np.asarray(x)).to(device=device, dtype=spec.dtype),
                        batch, self.batch_specs)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _meta_tree(shapes, dtype):
    """A ``param_shapes`` tree (dicts and lists of shape tuples) as ``meta``
    tensors of ``dtype``."""
    if isinstance(shapes, dict):
        return {k: _meta_tree(v, dtype) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_meta_tree(v, dtype) for v in shapes]
    return _meta(shapes, dtype)


def _opt_config(n_params: int) -> opt_mod.AdamWConfig:
    """Memory-fit heuristic: >100B params -> bf16 moments (Arctic's fp32 m
    and v would not fit one pod)."""
    if n_params > 100e9:
        return opt_mod.AdamWConfig(m_dtype=BF16, v_dtype=BF16)
    return opt_mod.AdamWConfig()


def _train_state_meta(params_meta, opt_cfg: opt_mod.AdamWConfig):
    m = tree_map(lambda p: _meta(p.shape, opt_cfg.m_dtype), params_meta)
    v = tree_map(lambda p: _meta(p.shape, opt_cfg.v_dtype), params_meta)
    return {"params": params_meta, "opt": opt_mod.AdamWState(step=_meta((), I32), m=m, v=v)}


def _train_step(loss_fn: Callable, opt_cfg: opt_mod.AdamWConfig) -> Callable:
    """``step(state, batch)``: ``loss_fn(params, batch) -> (loss, metrics)``
    forward and backward, then AdamW; metrics ``loss``, the loss's own,
    ``lr`` and ``grad_norm``."""

    def step(state, batch_in):
        (loss, metrics), grads = value_and_grad(loss_fn, state["params"], batch_in)
        params, opt, om = opt_mod.apply_adamw(opt_cfg, state["opt"], state["params"], grads)
        return {"params": params, "opt": opt}, {"loss": loss, **metrics, **om}

    return step


def _init_train(init_params: Callable, opt_cfg: opt_mod.AdamWConfig) -> Callable:
    def init_state(generator: torch.Generator):
        params = init_params(generator)
        return {"params": params, "opt": opt_mod.init_adamw(opt_cfg, params)}

    return init_state


# ===========================================================================
# LM family
# ===========================================================================


def _lm_prod_config(cfg: tfm.TransformerConfig, mesh, kind: str, optimized: bool = False):
    """Production knobs: chunked attention + remat + the layer carry's and
    the MoE buffers' layouts.  ``optimized=True`` switches on the sharded
    forms (on a rank mesh) and window slicing; the default is the
    paper-faithful baseline, so both stay measurable."""
    act = None
    moe = cfg.moe
    ranks = isinstance(mesh, Mesh)
    if mesh is not None:
        dp = tuple(a for a in ("pod", "data") if a in mesh.shape)
        if kind in ("train", "prefill"):
            act = Placement(mesh, (dp, "model", None))  # (batch, SP, ·)
        if moe is not None:
            # (E, C, D) dispatch/combine buffers: EP splits E, otherwise C
            # over the dp axes
            espec = "model" if moe.partition == "expert" else None
            moe = dataclasses.replace(moe, dispatch_pspec=Placement(mesh, (espec, dp, None)))
            if optimized and ranks and kind in ("train", "prefill"):
                moe = dataclasses.replace(moe, shard_dispatch=True, mesh=mesh)
    out = dataclasses.replace(
        cfg,
        attn_q_chunk=512 if kind in ("train", "prefill") else None,
        remat=kind == "train",
        act_pspec=act,
        moe=moe,
        attn_window_slicing=optimized and cfg.sliding_window is not None,
        attn_halo_mesh=(
            mesh if optimized and ranks and cfg.sliding_window is not None and kind in ("train", "prefill")
            else None
        ),
    )
    if PERF_OVERRIDES:
        out = dataclasses.replace(out, **PERF_OVERRIDES)
    return out


def _sharded_forms(cfg: tfm.TransformerConfig) -> bool:
    return cfg.attn_halo_mesh is not None or (cfg.moe is not None and cfg.moe.shard_dispatch)


def _build_lm(spec: ArchSpec, shape: ShapeSpec, smoke: bool, mesh, optimized: bool, device) -> StepBundle:
    cfg = spec.smoke_config if smoke else _lm_prod_config(spec.config, mesh, shape.kind, optimized=optimized)
    p = shape.params
    if smoke:
        batch = 2
        seq = 16 if shape.kind != "train" else 12
    else:
        batch, seq = p["global_batch"], p["seq_len"]

    pspec = tfm.param_specs(cfg)
    params_meta = _meta_tree(tfm.param_shapes(cfg), cfg.param_dtype)

    def init_params(generator):
        return tfm.init_params(cfg, generator, device)

    if shape.kind == "train":
        opt_cfg = _opt_config(cfg.param_count())

        def loss_fn(params, batch_in):
            if _sharded_forms(cfg):
                raise ValueError("the sharded MoE dispatch and halo attention are forward only: a train step of "
                                 "this config would differentiate no collective")
            return tfm.loss_fn(cfg, params, batch_in["tokens"])

        def make_batch(rng):
            gen = lm_data.MarkovTokens(cfg.vocab, seed=0)
            return {"tokens": gen.batch(batch, seq + 1, rng)}

        return StepBundle(
            spec.arch_id, shape.name, shape.kind, cfg, _init_train(init_params, opt_cfg),
            _train_step(loss_fn, opt_cfg),
            {"params": pspec, "opt": opt_mod.AdamWState(step=None, m=pspec, v=pspec)},
            {"tokens": ("batch", None)}, {"tokens": _meta((batch, seq + 1), I32)}, make_batch, True,
            _train_state_meta(params_meta, opt_cfg), device, loss_fn=loss_fn,
        )

    if shape.kind == "prefill":

        @torch.no_grad()
        def step(params, batch_in):
            return tfm.prefill(cfg, params, batch_in["tokens"], max_seq=seq)

        def make_batch(rng):
            gen = lm_data.MarkovTokens(cfg.vocab, seed=0)
            return {"tokens": gen.batch(batch, seq, rng)}

        out_logical = (
            ("batch", "vocab"),  # logits
            {
                "k": (None, "batch", None, None, "head_dim"),
                "v": (None, "batch", None, None, "head_dim"),
                "len": None,
            },
        )
        return StepBundle(
            spec.arch_id, shape.name, shape.kind, cfg, init_params, step, pspec,
            {"tokens": ("batch", None)}, {"tokens": _meta((batch, seq), I32)}, make_batch, False,
            params_meta, device, out_logical=out_logical,
        )

    # decode: one new token against a KV cache of seq_len
    cap = tfm.cache_capacity(cfg, seq)

    @torch.no_grad()
    def step(params, batch_in):
        return tfm.decode_step(cfg, params, batch_in["token"], batch_in["cache"])

    cache_logical = {
        "k": (None, "batch", "seq", None, "head_dim"),
        "v": (None, "batch", "seq", None, "head_dim"),
        "len": None,
    }
    cshape = (cfg.n_layers, batch, cap, cfg.n_kv_heads, cfg.head_dim)
    batch_specs = {
        "token": _meta((batch,), I32),
        "cache": {"k": _meta(cshape, cfg.compute_dtype), "v": _meta(cshape, cfg.compute_dtype), "len": _meta((), I32)},
    }

    def make_batch(rng):
        # float32 K/V: to_tensors rounds them to compute_dtype, as the
        # reference's astype does (nearest even)
        return {
            "token": rng.integers(0, cfg.vocab, batch).astype(np.int32),
            "cache": {
                "k": rng.normal(0, 1, cshape).astype(np.float32),
                "v": rng.normal(0, 1, cshape).astype(np.float32),
                "len": np.asarray(seq - 1, np.int32),
            },
        }

    return StepBundle(
        spec.arch_id, shape.name, shape.kind, cfg, init_params, step, pspec,
        {"token": ("batch",), "cache": cache_logical}, batch_specs, make_batch, False, params_meta, device,
        out_logical=(("batch", "vocab"), cache_logical),
        notes=f"cache capacity {cap} ({'ring/SWA' if cap < seq else 'full'})",
    )


# ===========================================================================
# GNN family
# ===========================================================================

_MOL_ATOM_TYPES = 100
_MOL_FEAT = 16  # continuous features for sage/gat on the molecule shape
_GNN_MODULES = {"graphsage-reddit": graphsage, "gat-cora": gat, "schnet": schnet, "dimenet": dimenet}


def _pad512(x: int) -> int:
    """Pad graph dims to a 512 multiple so the dp axes always divide them."""
    return ((x + 511) // 512) * 512


def _gnn_shape_dims(spec: ArchSpec, shape: ShapeSpec, smoke: bool):
    p = dict(shape.params)
    if shape.kind == "gnn_full":
        if smoke:
            p.update(n_nodes=64, n_edges=256, d_feat=16, n_classes=4)
        else:
            p["n_real_nodes"], p["n_real_edges"] = p["n_nodes"], p["n_edges"]
            p.update(n_nodes=_pad512(p["n_nodes"]), n_edges=_pad512(p["n_edges"]))
        return p
    if shape.kind == "gnn_minibatch":
        if smoke:
            p.update(batch_nodes=8, fanouts=(3, 2), d_feat=16, n_classes=4)
        n_nodes, n_edges = sampled_block_sizes(p["batch_nodes"], p["fanouts"])
        p.update(n_nodes=n_nodes, n_edges=n_edges)
        return p
    # molecule
    if smoke:
        p.update(batch=4, n_nodes=10, n_edges=16)
    return p


def _gnn_config(spec: ArchSpec, shape: ShapeSpec, smoke: bool, dims):
    cfg = spec.smoke_config if smoke else spec.config
    molecular = spec.arch_id in ("schnet", "dimenet")
    if shape.kind == "gnn_molecule":
        if molecular:
            return dataclasses.replace(cfg, feature_mode="embed_types", task="graph_reg", out_dim=1)
        return dataclasses.replace(cfg, d_in=_MOL_FEAT, out_dim=1)
    if molecular:
        return dataclasses.replace(cfg, feature_mode="project", d_in=dims["d_feat"], task="node_class",
                                   out_dim=dims["n_classes"])
    return dataclasses.replace(cfg, d_in=dims["d_feat"], out_dim=dims["n_classes"])


def _gnn_forward(arch_id: str, cfg, params, g: GraphBatch, n_graphs: int):
    if arch_id == "graphsage-reddit":
        return graphsage.forward(cfg, params, g)
    if arch_id == "gat-cora":
        return gat.forward(cfg, params, g)
    if arch_id == "schnet":
        if cfg.task == "graph_reg":
            return schnet.forward_ngraphs(cfg, params, g, n_graphs)
        return schnet.forward(cfg, params, g)
    if arch_id == "dimenet":
        return dimenet.forward(cfg, params, g, n_graphs=n_graphs)
    raise ValueError(arch_id)


def _gnn_init(arch_id: str, cfg, generator: torch.Generator, device=None):
    return _GNN_MODULES[arch_id].init_params(cfg, generator, device)


def _build_gnn(spec: ArchSpec, shape: ShapeSpec, smoke: bool, device) -> StepBundle:
    dims = _gnn_shape_dims(spec, shape, smoke)
    cfg = _gnn_config(spec, shape, smoke, dims)
    arch_id = spec.arch_id
    molecular = arch_id in ("schnet", "dimenet")
    needs_triplets = arch_id == "dimenet"
    is_mol = shape.kind == "gnn_molecule"
    n = dims["n_nodes"] if not is_mol else dims["batch"] * dims["n_nodes"]
    e = dims["n_edges"] if not is_mol else dims["batch"] * dims["n_edges"]
    n_graphs = dims.get("batch", 1) if is_mol else 1
    t = triplet_budget(e) if needs_triplets else 0
    opt_cfg = _opt_config(0)

    feat_spec = _meta((n,), I32) if (molecular and is_mol) else _meta((n, dims.get("d_feat", _MOL_FEAT)), F32)
    gb_specs = dict(node_feat=feat_spec, edge_src=_meta((e,), I32), edge_dst=_meta((e,), I32),
                    node_mask=_meta((n,), torch.bool), edge_mask=_meta((e,), torch.bool))
    gb_logical = dict(
        node_feat=("nodes", None) if feat_spec.dim() == 2 else ("nodes",),
        edge_src=("edges",),
        edge_dst=("edges",),
        node_mask=("nodes",),
        edge_mask=("edges",),
    )
    if molecular:
        gb_specs["positions"] = _meta((n, 3), F32)
        gb_logical["positions"] = ("nodes", None)
    if is_mol:
        gb_specs["graph_ids"] = _meta((n,), I32)
        gb_logical["graph_ids"] = ("nodes",)
    if needs_triplets:
        gb_specs["triplets"] = {"in": _meta((t,), I32), "out": _meta((t,), I32), "mask": _meta((t,), F32)}
        gb_logical["triplets"] = {"in": ("triplets",), "out": ("triplets",), "mask": ("triplets",)}

    batch_specs = {
        "graph": gb_specs,
        "labels": _meta((n_graphs, 1), F32) if is_mol else _meta((n,), I32),
        "loss_mask": _meta((n_graphs,) if is_mol else (n,), F32),
    }
    batch_logical = {
        "graph": gb_logical,
        "labels": (None, None) if is_mol else ("nodes",),
        "loss_mask": (None,) if is_mol else ("nodes",),
    }

    def to_graphbatch(d):
        return GraphBatch(
            node_feat=d["node_feat"], edge_src=d["edge_src"], edge_dst=d["edge_dst"], node_mask=d["node_mask"],
            edge_mask=d["edge_mask"], positions=d.get("positions"), graph_ids=d.get("graph_ids"),
            triplets=d.get("triplets"),
        )

    def loss_fn(params, batch_in):
        g = to_graphbatch(batch_in["graph"])
        out = _gnn_forward(arch_id, cfg, params, g, n_graphs)
        loss_mask = batch_in["loss_mask"]
        if is_mol and not molecular:
            # sage/gat emit per-node values -> mean-readout per graph
            num = scatter_sum(out * g.node_mask[:, None], g.graph_ids, n_graphs)
            cnt = scatter_sum(g.node_mask.to(torch.float32)[:, None], g.graph_ids, n_graphs)[:, 0]
            out = num / torch.clamp(cnt, min=1.0)[:, None]
        if is_mol:  # graph regression (MSE)
            err = (out - batch_in["labels"]) ** 2
            loss = torch.sum(err[:, 0] * loss_mask) / torch.clamp(torch.sum(loss_mask), min=1.0)
        else:  # masked node classification
            logits = out.to(torch.float32)
            logz = torch.logsumexp(logits, -1)
            gold = torch.gather(logits, 1, batch_in["labels"][:, None].long())[:, 0]
            loss = torch.sum((logz - gold) * loss_mask) / torch.clamp(torch.sum(loss_mask), min=1.0)
        return loss, {"xent": loss}

    params_meta = _meta_tree(_GNN_MODULES[arch_id].param_shapes(cfg), F32)
    param_logical = tree_map(lambda _: None, params_meta)  # GNN params are tiny -> replicated
    state_logical = {
        "params": param_logical,
        "opt": opt_mod.AdamWState(step=None, m=param_logical, v=param_logical),
    }

    def make_batch(rng):
        if is_mol:
            d = graph_data.molecule_batch(
                n_graphs, dims["n_nodes"], dims["n_edges"], _MOL_ATOM_TYPES
                if not smoke else cfg.n_atom_types if molecular else _MOL_ATOM_TYPES,
                rng,
            )
            if not molecular:
                # continuous features for sage/gat: one-hot-ish projections
                d["node_feat"] = rng.normal(0, 1, (n, _MOL_FEAT)).astype(np.float32)
                d.pop("positions")
            labels = d.pop("labels")
            loss_mask = np.ones(n_graphs, np.float32)
        else:
            d = graph_data.citation_graph(n, e, dims["d_feat"], dims["n_classes"], rng)
            labels = d.pop("labels")
            if not molecular:
                d.pop("positions")
            loss_mask = (rng.random(n) < 0.5).astype(np.float32)
            if shape.kind == "gnn_minibatch":
                # only seed slots contribute to the loss
                loss_mask = np.zeros(n, np.float32)
                loss_mask[: dims["batch_nodes"]] = 1.0
        d["node_mask"] = np.ones(n, bool)
        d["edge_mask"] = np.ones(e, bool)
        if needs_triplets:
            trip = graph_data.build_triplets(d["edge_src"], d["edge_dst"], t)
            trip.pop("truncated")
            d["triplets"] = trip
        return {"graph": d, "labels": labels, "loss_mask": loss_mask}

    return StepBundle(
        arch_id, shape.name, shape.kind, cfg,
        _init_train(lambda generator: _gnn_init(arch_id, cfg, generator, device), opt_cfg),
        _train_step(loss_fn, opt_cfg), state_logical, batch_logical, batch_specs, make_batch, True,
        _train_state_meta(params_meta, opt_cfg), device,
        notes=f"n={n} e={e}" + (f" triplets={t}" if needs_triplets else ""), loss_fn=loss_fn,
    )


# ===========================================================================
# RecSys family (bert4rec)
# ===========================================================================


def _build_recsys(spec: ArchSpec, shape: ShapeSpec, smoke: bool, device) -> StepBundle:
    cfg = spec.smoke_config if smoke else spec.config
    p = shape.params
    batch = 2 if smoke else p["batch"]
    seq = cfg.seq_len
    pspec = bert4rec.param_specs(cfg)
    params_meta = _meta_tree(bert4rec.param_shapes(cfg), F32)

    def init_params(generator):
        return bert4rec.init_params(cfg, generator, device)

    if shape.kind == "recsys_train":
        m, k = cfg.max_masked, cfg.n_negatives
        opt_cfg = _opt_config(cfg.param_count())

        def loss_fn(params, b):
            return bert4rec.cloze_loss_sampled(cfg, params, b["items"], b["mask_positions"], b["mask_targets"],
                                               b["negatives"])

        def make_batch(rng):
            items = recsys_data.interaction_sequences(cfg.n_items, batch, seq, rng)
            masked, positions, targets = recsys_data.cloze_mask_positions(items, cfg.mask_id, m, rng)
            return {
                "items": masked,
                "mask_positions": positions,
                "mask_targets": targets,
                "negatives": rng.integers(1, cfg.n_items + 1, k).astype(np.int32),
            }

        batch_logical = {
            "items": ("batch", None),
            "mask_positions": ("batch", None),
            "mask_targets": ("batch", None),
            "negatives": (None,),
        }
        batch_specs = {
            "items": _meta((batch, seq), I32),
            "mask_positions": _meta((batch, m), I32),
            "mask_targets": _meta((batch, m), I32),
            "negatives": _meta((k,), I32),
        }
        return StepBundle(
            spec.arch_id, shape.name, shape.kind, cfg, _init_train(init_params, opt_cfg),
            _train_step(loss_fn, opt_cfg), {"params": pspec, "opt": opt_mod.AdamWState(step=None, m=pspec, v=pspec)},
            batch_logical, batch_specs, make_batch, True, _train_state_meta(params_meta, opt_cfg), device,
            loss_fn=loss_fn,
        )

    if shape.kind == "recsys_serve":

        @torch.no_grad()
        def step(params, batch_in):
            return bert4rec.score_all_items(cfg, params, batch_in["items"])

        batch_logical = {"items": ("batch", None)}
        batch_specs = {"items": _meta((batch, seq), I32)}
        out_logical = ("batch", "vocab")

        def make_batch(rng):
            return {"items": recsys_data.interaction_sequences(cfg.n_items, batch, seq, rng)}

    else:  # retrieval_cand
        n_cand = 16 if smoke else p["n_candidates"]

        @torch.no_grad()
        def step(params, batch_in):
            return bert4rec.score_candidates(cfg, params, batch_in["items"], batch_in["candidates"])

        batch_logical = {"items": ("batch", None), "candidates": ("batch", "candidates")}
        batch_specs = {"items": _meta((batch, seq), I32), "candidates": _meta((batch, n_cand), I32)}
        out_logical = ("batch", "candidates")

        def make_batch(rng):
            return {
                "items": recsys_data.interaction_sequences(cfg.n_items, batch, seq, rng),
                "candidates": rng.integers(1, cfg.n_items + 1, (batch, n_cand)).astype(np.int32),
            }

    return StepBundle(
        spec.arch_id, shape.name, shape.kind, cfg, init_params, step, pspec, batch_logical, batch_specs,
        make_batch, False, params_meta, device, out_logical=out_logical,
    )


# ===========================================================================
# entry point
# ===========================================================================


def build_step(
    arch_id: str,
    shape_name: str,
    smoke: bool = False,
    mesh: Optional[Any] = None,
    config_override: Optional[Any] = None,
    optimized: bool = False,
    device: DeviceLike = None,
) -> StepBundle:
    """The step bundle of one cell on ``device`` (CUDA unless named; ``meta``
    for counting).  ``config_override`` replaces the arch's full config (the
    dry run's depth extrapolation: the same arch at n_layers ∈ {1, 2});
    ``optimized`` enables the perf levers (against the baseline)."""
    device = resolve_device(device)
    spec = get_arch(arch_id)
    if config_override is not None:
        spec = dataclasses.replace(spec, config=config_override)
    shape = spec.shapes[shape_name]
    if shape.skip and not smoke:
        raise ValueError(f"{arch_id}/{shape_name} skipped: {shape.skip}")
    if spec.family == "lm":
        return _build_lm(spec, shape, smoke, mesh, optimized, device)
    if spec.family == "gnn":
        return _build_gnn(spec, shape, smoke, device)
    if spec.family == "recsys":
        return _build_recsys(spec, shape, smoke, device)
    raise ValueError(spec.family)
