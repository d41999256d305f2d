"""gLava → RecSys integration: a NON-SQUARE user×item sketch (paper
Section 6.1.2) over the interaction stream drives popularity-aware negative
sampling.

Port of ``src/repro/integration/popularity.py``.  Users hash on rows, items
on columns; item popularity is the in-flow point query f̃_v(item, ←), and
negatives are drawn ∝ popularity^beta without per-item exact counters.  The
sketch lives on the CUDA device unless ``device="cpu"`` is given; its
ingest takes the ``auto`` backend (the CUDA scatter kernel on a card)."""
from __future__ import annotations

import numpy as np

from repro_torch.core import queries
from repro_torch.core.hashing import keys_to_tensor
from repro_torch.core.sketch import GLavaSketch, SketchConfig
from repro_torch.device import DeviceLike, resolve_device


class InteractionPopularitySketch:
    def __init__(
        self,
        n_items_hint: int,
        depth: int = 4,
        width_users: int = 4096,
        width_items: int = 8192,
        seed: int = 0,
        device: DeviceLike = None,
    ):
        cfg = SketchConfig(depth=depth, width_rows=width_users, width_cols=width_items)
        self.sketch = GLavaSketch.empty(cfg, seed, resolve_device(device))
        self.n_items = n_items_hint

    def _keys(self, ids: np.ndarray):
        return keys_to_tensor(np.asarray(ids, np.uint32), self.sketch.device)

    def observe(self, user_ids: np.ndarray, item_ids: np.ndarray):
        self.sketch.update_(self._keys(user_ids), self._keys(item_ids))

    def item_popularity(self, items: np.ndarray) -> np.ndarray:
        return queries.node_in_flow(self.sketch, self._keys(items)).cpu().numpy()

    def sample_negatives(
        self, k: int, rng, beta: float = 0.75, candidate_pool: int = 65536
    ) -> np.ndarray:
        """Draw k popularity^beta-weighted negatives from a uniform candidate
        pool (two-stage: the pool keeps the point-query batch bounded)."""
        pool = rng.integers(1, self.n_items + 1, candidate_pool).astype(np.uint32)
        pop = self.item_popularity(pool)
        w = np.power(np.maximum(pop, 1e-6), beta)
        w /= w.sum()
        return rng.choice(pool, size=k, replace=True, p=w).astype(np.int32)

    def user_activity(self, user_ids: np.ndarray) -> np.ndarray:
        return queries.node_out_flow(self.sketch, self._keys(user_ids)).cpu().numpy()
