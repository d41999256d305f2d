"""Synthetic graph data: Zipf or uniform edge streams with integer weights,
citation-style node-classification graphs, and the triplet lists for
directional message passing.

Port of ``src/repro/data/graphs.py`` (``random_edges``, ``edge_stream``,
``citation_graph``, ``molecule_batch``, ``build_triplets``; host-side numpy,
so the same ``rng`` gives the same arrays on both sides).  ``triplet_budget``
and its two constants are copied from ``src/repro/configs/base.py:87-112``;
``repro_torch.configs.base`` imports them from here."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def random_edges(
    n_nodes: int, n_edges: int, rng, zipf_a: Optional[float] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Edge list; zipf_a skews endpoint popularity (heavy hitters — the
    regime the paper's sketches are built for)."""
    if zipf_a:
        ranks = np.arange(1, n_nodes + 1, dtype=np.float64)
        p = ranks ** (-zipf_a)
        p /= p.sum()
        src = rng.choice(n_nodes, size=n_edges, p=p)
        dst = rng.choice(n_nodes, size=n_edges, p=p)
    else:
        src = rng.integers(0, n_nodes, n_edges)
        dst = rng.integers(0, n_nodes, n_edges)
    return src.astype(np.int32), dst.astype(np.int32)


def edge_stream(
    n_nodes: int, n_edges: int, rng, zipf_a: float = 1.1, max_weight: int = 8
) -> Dict[str, np.ndarray]:
    """A weighted, timestamped graph stream (x, y; w, t) — paper Section 3.1."""
    src, dst = random_edges(n_nodes, n_edges, rng, zipf_a)
    w = rng.integers(1, max_weight + 1, n_edges).astype(np.float32)
    t = np.sort(rng.random(n_edges)).astype(np.float32)
    return {"src": src.astype(np.uint32), "dst": dst.astype(np.uint32), "weight": w, "time": t}


TRIPLET_FACTOR = 8          # static triplet budget = factor × n_edges …
TRIPLET_CAP = 1 << 26       # … capped (documented coverage bound; log at use)


def triplet_budget(n_edges: int) -> int:
    return min(TRIPLET_FACTOR * n_edges, TRIPLET_CAP)


def build_triplets(
    edge_src: np.ndarray,
    edge_dst: np.ndarray,
    budget: Optional[int] = None,
    edge_mask: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
    """Directional triplet lists for DimeNet: for every edge e_out=(j→i),
    pair with every edge e_in=(k→j), k != i.

    Returns padded {"in": (T,), "out": (T,), "mask": (T,)} with
    T = budget or triplet_budget(len(edges)).  Truncation (rare; only on
    pathological degree skew) is recorded in the returned "truncated" flag.
    """
    e = len(edge_src)
    t_cap = budget if budget is not None else triplet_budget(e)
    valid = np.ones(e, bool) if edge_mask is None else edge_mask.astype(bool)
    in_by_node: Dict[int, list] = {}
    for idx in np.nonzero(valid)[0]:
        in_by_node.setdefault(int(edge_dst[idx]), []).append(idx)
    t_in, t_out = [], []
    truncated = False
    for e_out in np.nonzero(valid)[0]:
        j, i = int(edge_src[e_out]), int(edge_dst[e_out])
        for e_in in in_by_node.get(j, ()):
            if int(edge_src[e_in]) == i:
                continue  # exclude backtracking k == i
            t_in.append(e_in)
            t_out.append(e_out)
            if len(t_in) >= t_cap:
                truncated = True
                break
        if truncated:
            break
    n = len(t_in)
    out = {
        "in": np.zeros(t_cap, np.int32),
        "out": np.zeros(t_cap, np.int32),
        "mask": np.zeros(t_cap, np.float32),
        "truncated": truncated,
    }
    out["in"][:n] = t_in
    out["out"][:n] = t_out
    out["mask"][:n] = 1.0
    return out


def citation_graph(
    n_nodes: int, n_edges: int, d_feat: int, n_classes: int, rng
) -> Dict[str, np.ndarray]:
    """Cora/products-style node-classification graph with correlated
    class/feature structure (so training actually learns)."""
    labels = rng.integers(0, n_classes, n_nodes).astype(np.int32)
    centroids = rng.normal(0, 1, (n_classes, d_feat)).astype(np.float32)
    feats = centroids[labels] + 0.5 * rng.normal(0, 1, (n_nodes, d_feat)).astype(
        np.float32
    )
    # homophilous edges: 70% within class
    n_homo = int(0.7 * n_edges)
    src_h = rng.integers(0, n_nodes, n_homo)
    # partner within same class via sorted-by-label trick
    order = np.argsort(labels, kind="stable")
    pos_of = np.empty(n_nodes, np.int64)
    pos_of[order] = np.arange(n_nodes)
    jitter = rng.integers(-5, 6, n_homo)
    dst_h = order[np.clip(pos_of[src_h] + jitter, 0, n_nodes - 1)]
    src_r, dst_r = random_edges(n_nodes, n_edges - n_homo, rng)
    src = np.concatenate([src_h, src_r]).astype(np.int32)
    dst = np.concatenate([dst_h, dst_r]).astype(np.int32)
    positions = rng.normal(0, 3, (n_nodes, 3)).astype(np.float32)  # for molecular nets
    return {
        "node_feat": feats,
        "edge_src": src,
        "edge_dst": dst,
        "labels": labels,
        "positions": positions,
    }


def molecule_batch(
    n_graphs: int, nodes_per: int, edges_per: int, n_atom_types: int, rng
) -> Dict[str, np.ndarray]:
    """Batch of small molecules: atom types + 3-D positions + edges within a
    cutoff-ish radius; regression target = synthetic 'energy'."""
    n = n_graphs * nodes_per
    types = rng.integers(1, n_atom_types, n).astype(np.int32)
    positions = rng.normal(0, 1.5, (n, 3)).astype(np.float32)
    src_l, dst_l = [], []
    for g in range(n_graphs):
        base = g * nodes_per
        s = rng.integers(0, nodes_per, edges_per) + base
        d = rng.integers(0, nodes_per, edges_per) + base
        src_l.append(s)
        dst_l.append(d)
    src = np.concatenate(src_l).astype(np.int32)
    dst = np.concatenate(dst_l).astype(np.int32)
    graph_ids = np.repeat(np.arange(n_graphs, dtype=np.int32), nodes_per)
    dists = np.linalg.norm(positions[dst] - positions[src], axis=1)
    energy = np.zeros(n_graphs, np.float32)
    np.add.at(energy, graph_ids[src], np.exp(-dists).astype(np.float32))
    return {
        "node_feat": types,
        "positions": positions,
        "edge_src": src,
        "edge_dst": dst,
        "graph_ids": graph_ids,
        "labels": energy[:, None],
    }
