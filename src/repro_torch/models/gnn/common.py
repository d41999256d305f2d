"""GNN substrate: padded graph batches and segment-op message passing.

Port of ``src/repro/models/gnn/common.py``.  Message passing is built from
``index_add`` and ``scatter_reduce`` over explicit edge-index tensors, the
counterparts of the reference's ``jax.ops.segment_sum``/``segment_max``
(no Pallas kernel there, so plain PyTorch is the port), with the
reference's mask rules: masked messages add zero, and a segment no message
reaches reads 0 from a max.  Shapes stay static (padded and masked), as in
the reference.  The initialisers draw from an explicit ``torch.Generator``
on its own device, then move to ``device``, so a CPU and a CUDA run start
from the same parameters.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    """A padded (batch of) graph(s).

    ``node_feat`` is float features OR integer atom types (molecular nets).
    Padded edges carry ``edge_mask == False`` and point at node 0.
    ``graph_ids`` maps nodes to graphs for batched-small-graph readout.
    """

    node_feat: torch.Tensor           # (N, F) float32 or (N,) int32
    edge_src: torch.Tensor            # (E,) int
    edge_dst: torch.Tensor            # (E,) int
    node_mask: torch.Tensor           # (N,) bool
    edge_mask: torch.Tensor           # (E,) bool
    positions: Optional[torch.Tensor] = None   # (N, 3) float32
    graph_ids: Optional[torch.Tensor] = None   # (N,) int
    # DimeNet-style triplet index lists {"in": (T,), "out": (T,), "mask": (T,)}
    triplets: Optional[dict] = None

    @property
    def n_nodes(self) -> int:
        return self.node_feat.shape[0]

    @property
    def n_edges(self) -> int:
        return self.edge_src.shape[0]


def _segment_sum(values: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: row ``k`` is the sum of the rows whose id is k."""
    return values.new_zeros((n, *values.shape[1:])).index_add(0, ids.long(), values)


def _segment_max(values: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.ops.segment_max``: -inf where no row lands."""
    index = ids.long().view(-1, *([1] * (values.dim() - 1))).expand_as(values)
    init = values.new_full((n, *values.shape[1:]), -math.inf)
    return init.scatter_reduce(0, index, values, "amax", include_self=True)


def scatter_sum(messages: torch.Tensor, dst: torch.Tensor, n_nodes: int, mask=None) -> torch.Tensor:
    if mask is not None:
        messages = messages * mask[:, None].to(messages.dtype)
    return _segment_sum(messages, dst, n_nodes)


def scatter_mean(messages: torch.Tensor, dst: torch.Tensor, n_nodes: int, mask=None) -> torch.Tensor:
    if mask is None:
        mask = torch.ones(messages.shape[0], dtype=torch.bool, device=messages.device)
    s = scatter_sum(messages, dst, n_nodes, mask)
    deg = _segment_sum(mask.to(torch.float32), dst, n_nodes)
    return s / torch.clamp(deg, min=1.0)[:, None]


def scatter_max(messages: torch.Tensor, dst: torch.Tensor, n_nodes: int, mask=None) -> torch.Tensor:
    if mask is not None:
        messages = torch.where(mask[:, None], messages, -math.inf)
    out = _segment_max(messages, dst, n_nodes)
    return torch.where(torch.isfinite(out), out, 0.0)


def segment_softmax(scores: torch.Tensor, dst: torch.Tensor, n_nodes: int, mask=None) -> torch.Tensor:
    """Numerically-stable softmax over edges grouped by destination node.
    scores: (E, H)."""
    if mask is not None:
        scores = torch.where(mask[:, None], scores, -math.inf)
    mx = _segment_max(scores, dst, n_nodes)  # (N, H)
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    ex = torch.exp(scores - mx[dst.long()])
    if mask is not None:
        ex = ex * mask[:, None]
    denom = _segment_sum(ex, dst, n_nodes)
    return ex / torch.clamp(denom[dst.long()], min=1e-16)


def graph_readout_sum(node_vals: torch.Tensor, graph_ids: torch.Tensor, n_graphs: int, node_mask) -> torch.Tensor:
    vals = node_vals * node_mask[:, None].to(node_vals.dtype)
    return _segment_sum(vals, graph_ids, n_graphs)


def edge_distances(positions: torch.Tensor, src: torch.Tensor, dst: torch.Tensor, mask):
    """Pairwise distances per edge (molecular nets).  Padded edges -> 1.0 to
    keep rsqrt/denominators finite."""
    diff = positions[dst.long()] - positions[src.long()]
    d = torch.sqrt(torch.clamp(torch.sum(diff * diff, dim=-1), min=1e-12))
    return torch.where(mask, d, 1.0), diff


def dense_init(generator: torch.Generator, shape: Sequence[int], fan_in: int, dtype=torch.float32,
               device: Optional[torch.device] = None) -> torch.Tensor:
    """N(0, 1/fan_in), drawn on the generator's device, moved to ``device``."""
    x = torch.randn(tuple(shape), generator=generator, device=generator.device, dtype=dtype)
    return (x / math.sqrt(fan_in)).to(device)


def init_tree(generator: torch.Generator, shapes, fan_in: Callable[[str, tuple], int],
              device: Optional[torch.device] = None):
    """A parameter tree of ``shapes`` (nested dicts and lists of shape
    tuples): each 1-D leaf zeros (the biases), every other leaf
    ``dense_init`` with ``fan_in(name, shape)``, drawn in the tree's order."""
    if isinstance(shapes, list):
        return [init_tree(generator, s, fan_in, device) for s in shapes]
    out = {}
    for name, shape in shapes.items():
        if isinstance(shape, (dict, list)):
            out[name] = init_tree(generator, shape, fan_in, device)
        elif len(shape) == 1:
            out[name] = torch.zeros(shape, dtype=torch.float32, device=device)
        else:
            out[name] = dense_init(generator, shape, fan_in(name, shape), device=device)
    return out


def mlp_shapes(dims: Sequence[int], prefix: str = "") -> Dict[str, tuple]:
    """The shapes of an MLP's leaves: ``w{i}`` (in, out) and ``b{i}``."""
    shapes = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        shapes[f"{prefix}w{i}"] = (a, b)
        shapes[f"{prefix}b{i}"] = (b,)
    return shapes


def mlp_params(generator: torch.Generator, dims: Sequence[int], prefix: str = "",
               device: Optional[torch.device] = None) -> Dict[str, torch.Tensor]:
    return init_tree(generator, mlp_shapes(dims, prefix), lambda name, shape: shape[0], device)


def mlp_apply(ps: Dict[str, torch.Tensor], x: torch.Tensor, n_layers: int, prefix: str = "",
              act: Callable = F.silu, final_act: bool = False) -> torch.Tensor:
    for i in range(n_layers):
        x = x @ ps[f"{prefix}w{i}"] + ps[f"{prefix}b{i}"]
        if i < n_layers - 1 or final_act:
            x = act(x)
    return x
