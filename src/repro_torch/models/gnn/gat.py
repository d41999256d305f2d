"""GAT (Velickovic et al., arXiv:1710.10903) — attention aggregator via
SDDMM-style edge scores + segment softmax.

Port of ``src/repro/models/gnn/gat.py``: ``GATConfig``, ``init_params`` and
``forward`` as plain functions on the reference's parameter tree
(``{"layers": [{"w", "a_src", "a_dst"}, ...]}``, ``w`` in the ``(in, out)``
layout), so a reference tree converts by plain copies
(``repro_torch.convert.gat_params_from_arrays``).  The per-edge scores are
two gathers and an add (no Pallas kernel in the reference); the softmax and
the masked sum are ``common.segment_softmax`` and ``common._segment_sum``.

Assigned config gat-cora: 2 layers, d_hidden=8, 8 heads (layer-1 concat ->
64; final layer heads averaged into out_dim logits, as in the paper).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.gnn.common import GraphBatch, _segment_sum, init_tree, segment_softmax


@dataclasses.dataclass(frozen=True)
class GATConfig:
    name: str = "gat"
    n_layers: int = 2
    d_in: int = 1433
    d_hidden: int = 8   # per head
    n_heads: int = 8
    out_dim: int = 7
    negative_slope: float = 0.2


def _d_out(cfg: GATConfig, i: int) -> int:
    return cfg.out_dim if i == cfg.n_layers - 1 else cfg.d_hidden


def param_shapes(cfg: GATConfig) -> Dict:
    """The shape of every parameter, as the reference's tree."""
    layers, d_prev = [], cfg.d_in
    for i in range(cfg.n_layers):
        d_out = _d_out(cfg, i)
        layers.append({"w": (d_prev, cfg.n_heads * d_out), "a_src": (cfg.n_heads, d_out),
                       "a_dst": (cfg.n_heads, d_out)})
        d_prev = d_out if i == cfg.n_layers - 1 else cfg.n_heads * d_out
    return {"layers": layers}


def init_params(cfg: GATConfig, generator: torch.Generator, device: Optional[torch.device] = None) -> Dict:
    """The reference's tree: ``w`` ~ N(0, 1/d_prev), ``a_src`` and ``a_dst``
    ~ N(0, 1/d_out), drawn from ``generator`` layer by layer."""
    return init_tree(generator, param_shapes(cfg), lambda name, shape: shape[0] if name == "w" else shape[1],
                     device)


def forward(cfg: GATConfig, params: Dict, g: GraphBatch) -> torch.Tensor:
    """Per-node logits (N, out_dim)."""
    h = g.node_feat.to(torch.float32)
    n = g.n_nodes
    src, dst = g.edge_src.long(), g.edge_dst.long()
    for i, lp in enumerate(params["layers"]):
        final = i == cfg.n_layers - 1
        d_out = _d_out(cfg, i)
        wh = (h @ lp["w"]).reshape(n, cfg.n_heads, d_out)
        # SDDMM-style scores on edges
        s_src = torch.einsum("nhd,hd->nh", wh, lp["a_src"])  # (N, H)
        s_dst = torch.einsum("nhd,hd->nh", wh, lp["a_dst"])
        scores = F.leaky_relu(s_src[src] + s_dst[dst], cfg.negative_slope)  # (E, H)
        alpha = segment_softmax(scores, g.edge_dst, n, g.edge_mask)  # (E, H)
        msgs = wh[src] * alpha[..., None]  # (E, H, D)
        agg = _segment_sum(msgs * g.edge_mask[:, None, None], g.edge_dst, n)
        if final:
            h = torch.mean(agg, dim=1)  # average heads -> (N, out_dim)
        else:
            h = F.elu(agg.reshape(n, cfg.n_heads * d_out))
    return h
