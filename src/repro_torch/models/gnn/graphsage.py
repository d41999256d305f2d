"""GraphSAGE (Hamilton et al., arXiv:1706.02216) with mean aggregation.

Port of ``src/repro/models/gnn/graphsage.py``: ``SAGEConfig``,
``init_params`` and ``forward`` as plain functions on the reference's
parameter tree (``{"layers": [{"w_self", "w_neigh", "b"}, ...], "head"}``,
matrices in the ``(in, out)`` layout), so ``train/optimizer.py::apply_adamw``
takes it as it stands and a reference tree converts by plain copies
(``repro_torch.convert.graphsage_params_from_arrays``).  Works full-batch or
on sampled padded subgraphs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.models.gnn.common import GraphBatch, dense_init, scatter_mean


@dataclasses.dataclass(frozen=True)
class SAGEConfig:
    name: str = "graphsage"
    n_layers: int = 2
    d_in: int = 602
    d_hidden: int = 128
    out_dim: int = 41
    aggregator: str = "mean"


def param_shapes(cfg: SAGEConfig) -> Dict:
    """The shape of every parameter, as the reference's tree."""
    layers, d_prev = [], cfg.d_in
    for _ in range(cfg.n_layers):
        layers.append({"w_self": (d_prev, cfg.d_hidden), "w_neigh": (d_prev, cfg.d_hidden), "b": (cfg.d_hidden,)})
        d_prev = cfg.d_hidden
    return {"layers": layers, "head": (cfg.d_hidden, cfg.out_dim)}


def init_params(cfg: SAGEConfig, generator: torch.Generator, device: Optional[torch.device] = None) -> Dict:
    """The reference's tree: ``w_self``, ``w_neigh`` and ``head`` ~ N(0,
    1/fan_in) drawn from ``generator`` in that order, layer by layer, then
    the head; biases 0."""
    layers = []
    for shapes in param_shapes(cfg)["layers"]:
        fan_in = shapes["w_self"][0]
        layers.append({
            "w_self": dense_init(generator, shapes["w_self"], fan_in, device=device),
            "w_neigh": dense_init(generator, shapes["w_neigh"], fan_in, device=device),
            "b": torch.zeros(shapes["b"], dtype=torch.float32, device=device),
        })
    head = dense_init(generator, (cfg.d_hidden, cfg.out_dim), cfg.d_hidden, device=device)
    return {"layers": layers, "head": head}


def forward(cfg: SAGEConfig, params: Dict, g: GraphBatch) -> torch.Tensor:
    """Returns per-node logits (N, out_dim)."""
    h = g.node_feat.to(torch.float32)
    n = g.n_nodes
    for lp in params["layers"]:
        neigh = scatter_mean(h[g.edge_src.long()], g.edge_dst, n, g.edge_mask)
        h = torch.relu(h @ lp["w_self"] + neigh @ lp["w_neigh"] + lp["b"])
        # L2 normalize as in the paper (Section 3.1, line 7)
        h = h / torch.clamp(torch.linalg.vector_norm(h, dim=-1, keepdim=True), min=1e-6)
    return h @ params["head"]
