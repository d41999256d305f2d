"""SchNet (Schütt et al., arXiv:1706.08566) — continuous-filter convolutions.

Port of ``src/repro/models/gnn/schnet.py``: ``shifted_softplus``,
``rbf_expand``, ``init_params``, ``forward`` and ``forward_ngraphs`` on the
reference's parameter tree (``repro_torch.convert.schnet_params_from_arrays``
carries one across).  No Pallas kernel in the reference: an edge gather, the
RBF filter MLP and a masked ``index_add``.

Assigned config: 3 interactions, d_hidden=64, 300 RBF centers, cutoff 10 Å.

Two task heads: ``graph_reg`` (energy; the molecule shape) and
``node_class`` (per-node logits; the citation/product graph shapes — SchNet
still consumes 3-D positions, synthesized by the data pipeline there).

``forward`` with ``graph_reg`` counts the graphs as ``max(graph_ids) + 1``,
a read of a device value on the host, as the reference's ``int(jnp.max)``;
a step on the card calls ``forward_ngraphs`` with the count instead.  The
cutoff envelope's ``clamp`` takes the gradient 1 at a bound where ``jnp.clip``
takes 0.5; it depends on ``positions`` alone, which are inputs, so the
parameters' gradients are the reference's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.gnn.common import (
    GraphBatch,
    edge_distances,
    graph_readout_sum,
    init_tree,
    mlp_apply,
    mlp_shapes,
    scatter_sum,
)

_LOG2 = math.log(2.0)


def shifted_softplus(x: torch.Tensor) -> torch.Tensor:
    return F.softplus(x) - _LOG2


@dataclasses.dataclass(frozen=True)
class SchNetConfig:
    name: str = "schnet"
    n_interactions: int = 3
    d_hidden: int = 64
    n_rbf: int = 300
    cutoff: float = 10.0
    n_atom_types: int = 100
    feature_mode: str = "embed_types"  # or "project" (continuous node feats)
    d_in: int = 0                       # used when feature_mode == "project"
    out_dim: int = 1
    task: str = "graph_reg"             # "graph_reg" | "node_class"


def rbf_centers(n_rbf: int, cutoff: float, device=None) -> torch.Tensor:
    """``jnp.linspace(0, cutoff, n_rbf)`` as XLA computes it in float32:
    ``i * (cutoff * (1 / (n - 1)))``, the last centre ``cutoff`` itself
    (``torch.linspace`` differs by up to one float32 ulp)."""
    if n_rbf == 1:
        return torch.zeros(1, dtype=torch.float32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    step = torch.tensor(cutoff, **f32) * (1.0 / torch.tensor(n_rbf - 1, **f32))
    return torch.cat([torch.arange(n_rbf - 1, **f32) * step, torch.tensor([cutoff], **f32)])


def rbf_expand(d: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """Gaussian radial basis on [0, cutoff] (gamma as in SchNet)."""
    centers = rbf_centers(n_rbf, cutoff, d.device)
    gamma = 10.0 / cutoff
    return torch.exp(-gamma * torch.square(d[:, None] - centers[None, :]))


def param_shapes(cfg: SchNetConfig) -> Dict:
    """The shape of every parameter, as the reference's tree."""
    f = cfg.d_hidden
    shapes: Dict = {}
    if cfg.feature_mode == "embed_types":
        shapes["embed"] = (cfg.n_atom_types, f)
    else:
        shapes["proj"] = (cfg.d_in, f)
    shapes["blocks"] = [
        {**mlp_shapes([cfg.n_rbf, f, f], "filt_"), "w_in": (f, f), **mlp_shapes([f, f, f], "out_")}
        for _ in range(cfg.n_interactions)
    ]
    shapes.update(mlp_shapes([f, f // 2, cfg.out_dim], "head_"))
    return shapes


def init_params(cfg: SchNetConfig, generator: torch.Generator, device: Optional[torch.device] = None) -> Dict:
    """The reference's tree: every matrix ~ N(0, 1/fan_in) (its first
    dimension; ``d_hidden`` for the embedding), biases 0."""
    return init_tree(generator, param_shapes(cfg), lambda name, shape: shape[1] if name == "embed" else shape[0],
                     device)


def _node_values(cfg: SchNetConfig, params: Dict, g: GraphBatch) -> torch.Tensor:
    """The head's per-node output (N, out_dim)."""
    if cfg.feature_mode == "embed_types":
        h = params["embed"][g.node_feat.long()]
    else:
        h = g.node_feat.to(torch.float32) @ params["proj"]
    n = g.n_nodes
    d, _ = edge_distances(g.positions, g.edge_src, g.edge_dst, g.edge_mask)
    rbf = rbf_expand(d, cfg.n_rbf, cfg.cutoff)
    # smooth cutoff envelope (cosine)
    env = 0.5 * (torch.cos(math.pi * torch.clamp(d / cfg.cutoff, 0, 1)) + 1.0)
    src = g.edge_src.long()
    for bp in params["blocks"]:
        w_filter = mlp_apply(bp, rbf, 2, "filt_", act=shifted_softplus, final_act=True)
        w_filter = w_filter * env[:, None]
        msg = (h @ bp["w_in"])[src] * w_filter       # (E, d_hidden)
        agg = scatter_sum(msg, g.edge_dst, n, g.edge_mask)
        h = h + mlp_apply(bp, agg, 2, "out_", act=shifted_softplus)
    return mlp_apply(params, h, 2, "head_", act=shifted_softplus)  # (N, out_dim)


def _graph_ids(g: GraphBatch) -> torch.Tensor:
    if g.graph_ids is not None:
        return g.graph_ids
    return torch.zeros((g.n_nodes,), dtype=torch.int32, device=g.node_mask.device)


def forward(cfg: SchNetConfig, params: Dict, g: GraphBatch) -> torch.Tensor:
    """Returns (n_graphs, out_dim) for graph_reg or (N, out_dim) for node_class."""
    out = _node_values(cfg, params, g)
    if cfg.task == "graph_reg":
        n_graphs = 1 if g.graph_ids is None else int(torch.max(g.graph_ids)) + 1
        return graph_readout_sum(out, _graph_ids(g), n_graphs, g.node_mask)
    return out


def forward_ngraphs(cfg: SchNetConfig, params: Dict, g: GraphBatch, n_graphs: int) -> torch.Tensor:
    """The graph_reg readout over a given ``n_graphs``: no host read."""
    return graph_readout_sum(_node_values(cfg, params, g), _graph_ids(g), n_graphs, g.node_mask)
