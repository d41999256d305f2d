"""Layered uniform neighbor sampling over CSR (GraphSAGE minibatch training).

Port of ``src/repro/models/gnn/sampler.py``, a numpy copy: the same draws
from the same ``rng`` give the same subgraph.  Host-side by design: sampling
is data-pipeline work that feeds padded device batches.  This is a REAL
sampler (uniform with replacement per the GraphSAGE paper's estimator) over
a CSR adjacency, producing static-shape padded subgraphs, so every step
sees the same shapes.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class CSRGraph:
    indptr: np.ndarray   # (N+1,) int64
    indices: np.ndarray  # (E,) int32
    n_nodes: int

    @staticmethod
    def from_edges(src: np.ndarray, dst: np.ndarray, n_nodes: int) -> "CSRGraph":
        """CSR over incoming edges: row v holds the in-neighbors of v
        (GraphSAGE aggregates from in-neighbors).  The stable order by
        ``dst`` is ``torch.sort``'s on the host, which runs on every core
        (the same permutation as ``np.argsort(dst, kind="stable")``)."""
        order = torch.sort(torch.from_numpy(np.asarray(dst, np.int64)), stable=True).indices.numpy()
        s, d = src[order], dst[order]
        indptr = np.zeros(n_nodes + 1, np.int64)
        np.add.at(indptr, d + 1, 1)
        indptr = np.cumsum(indptr)
        return CSRGraph(indptr, s.astype(np.int32), n_nodes)

    def degree(self, v: np.ndarray) -> np.ndarray:
        return (self.indptr[v + 1] - self.indptr[v]).astype(np.int64)

    def sample_neighbors(self, v: np.ndarray, fanout: int, rng) -> np.ndarray:
        """Uniform-with-replacement sample of `fanout` in-neighbors per node;
        isolated nodes get self-loops.  Returns (len(v), fanout) int32."""
        deg = self.degree(v)
        off = rng.integers(0, 2**62, size=(len(v), fanout)) % np.maximum(deg, 1)[:, None]
        idx = self.indptr[v][:, None] + off
        nbrs = self.indices[np.minimum(idx, len(self.indices) - 1)]
        return np.where(deg[:, None] > 0, nbrs, v[:, None]).astype(np.int32)


def sampled_block_sizes(batch_nodes: int, fanouts: Sequence[int]) -> Tuple[int, int]:
    """Padded (n_nodes, n_edges) of a merged k-hop sampled subgraph."""
    n_nodes = batch_nodes
    frontier = batch_nodes
    n_edges = 0
    for f in fanouts:
        n_edges += frontier * f
        frontier *= f
        n_nodes += frontier
    return n_nodes, n_edges


def sample_subgraph(
    g: CSRGraph,
    seeds: np.ndarray,
    fanouts: Sequence[int],
    rng,
    features: np.ndarray | None = None,
):
    """Merged multi-hop sampled subgraph with STATIC padded shapes.

    Returns dict of numpy arrays:
      nodes       (N_pad,)  global node ids (padding repeats node 0)
      edge_src/dst(E_pad,)  LOCAL indices into `nodes`
      node_mask / edge_mask
      seed_slots  (B,)      local indices of the seeds (always 0..B-1)
    """
    n_pad, e_pad = sampled_block_sizes(len(seeds), fanouts)
    nodes = [seeds.astype(np.int32)]
    src_l: List[np.ndarray] = []
    dst_l: List[np.ndarray] = []
    frontier = seeds.astype(np.int32)
    frontier_local = np.arange(len(seeds), dtype=np.int32)
    next_local = len(seeds)
    for f in fanouts:
        nbrs = g.sample_neighbors(frontier, f, rng)              # (|F|, f)
        flat = nbrs.reshape(-1)
        local_ids = np.arange(next_local, next_local + len(flat), dtype=np.int32)
        # message edge: neighbor -> frontier node
        src_l.append(local_ids)
        dst_l.append(np.repeat(frontier_local, f))
        nodes.append(flat)
        frontier = flat
        frontier_local = local_ids
        next_local += len(flat)
    nodes = np.concatenate(nodes)
    edge_src = np.concatenate(src_l)
    edge_dst = np.concatenate(dst_l)
    node_mask = np.ones(len(nodes), bool)
    edge_mask = np.ones(len(edge_src), bool)
    # pad to static sizes
    nodes = np.pad(nodes, (0, n_pad - len(nodes)))
    node_mask = np.pad(node_mask, (0, n_pad - len(node_mask)))
    edge_src = np.pad(edge_src, (0, e_pad - len(edge_src)))
    edge_dst = np.pad(edge_dst, (0, e_pad - len(edge_dst)))
    edge_mask = np.pad(edge_mask, (0, e_pad - len(edge_mask)))
    out = {
        "nodes": nodes,
        "edge_src": edge_src,
        "edge_dst": edge_dst,
        "node_mask": node_mask,
        "edge_mask": edge_mask,
        "seed_slots": np.arange(len(seeds), dtype=np.int32),
    }
    if features is not None:
        out["node_feat"] = features[nodes]
    return out


def degree_weighted_seeds(
    degrees: np.ndarray, batch: int, rng, alpha: float = 0.5
) -> np.ndarray:
    """Importance seed sampling ∝ deg^alpha — the hook where the gLava sketch
    plugs in: on a STREAMED graph the exact degree table does not exist, and
    ``repro_torch.integration.sketch_sampler`` substitutes sketch-estimated
    degrees (paper point queries) here."""
    p = np.power(np.maximum(degrees.astype(np.float64), 1.0), alpha)
    p /= p.sum()
    return rng.choice(len(degrees), size=batch, replace=False, p=p).astype(np.int32)
