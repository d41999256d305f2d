"""Synthetic graph streams: Zipf or uniform endpoints, integer weights.

Port of ``src/repro/data/graphs.py`` (``random_edges`` and ``edge_stream``;
host-side numpy, so the same ``rng`` gives the same stream on both sides)."""
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
