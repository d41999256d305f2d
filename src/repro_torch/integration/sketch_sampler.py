"""gLava → GNN integration: sketch-estimated degrees drive the neighbor
sampler.

Port of ``src/repro/integration/sketch_sampler.py``.  On a streamed graph
the exact degree table does not exist; the gLava point queries
f̃_v(a, →)/f̃_v(a, ←) (paper Section 4.2) estimate a node's degree in O(d)
from the flow registers, and those estimates replace exact degrees in the
importance-seed sampler.  They only over-estimate (the CountMin property),
so collided nodes are biased up, never starved.  The sketch lives on the
CUDA device unless ``device="cpu"`` is given; its ingest takes the ``auto``
backend (the CUDA scatter kernel on a card; the reference's jnp scatter)."""
from __future__ import annotations

import numpy as np

from repro_torch.core import queries
from repro_torch.core.hashing import keys_to_tensor
from repro_torch.core.sketch import GLavaSketch, SketchConfig
from repro_torch.device import DeviceLike, resolve_device


class StreamingDegreeSketch:
    """Maintains a gLava sketch over a streamed edge list and serves degree
    estimates to the sampler."""

    def __init__(self, config: SketchConfig, seed: int = 0, device: DeviceLike = None):
        self.sketch = GLavaSketch.empty(config, seed, resolve_device(device))

    def _keys(self, ids: np.ndarray):
        return keys_to_tensor(np.asarray(ids, np.uint32), self.sketch.device)

    def observe(self, src: np.ndarray, dst: np.ndarray):
        self.sketch.update_(self._keys(src), self._keys(dst))

    def degree_estimates(self, nodes: np.ndarray, direction: str = "out") -> np.ndarray:
        keys = self._keys(nodes)
        if direction == "out":
            est = queries.node_out_flow(self.sketch, keys)
        else:
            est = queries.node_in_flow(self.sketch, keys)
        return est.cpu().numpy()

    def seed_weights(self, n_nodes: int, alpha: float = 0.5, chunk: int = 65536):
        """deg^alpha importance weights for ALL nodes (chunked point
        queries)."""
        out = np.empty(n_nodes, np.float64)
        for lo in range(0, n_nodes, chunk):
            hi = min(n_nodes, lo + chunk)
            est = self.degree_estimates(np.arange(lo, hi, dtype=np.uint32))
            out[lo:hi] = np.power(np.maximum(est, 1.0), alpha)
        return out / out.sum()


def sketch_weighted_seeds(
    deg_sketch: StreamingDegreeSketch,
    n_nodes: int,
    batch: int,
    rng,
    alpha: float = 0.5,
) -> np.ndarray:
    p = deg_sketch.seed_weights(n_nodes, alpha)
    return rng.choice(n_nodes, size=batch, replace=False, p=p).astype(np.int32)
