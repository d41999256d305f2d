"""RecSys data plane: Zipf-popular item interaction sequences + Cloze
masking (BERT4Rec training), and the user→item bipartite interaction stream
consumed by the gLava popularity sketch (negative sampling / candidate
stats).

Port of ``src/repro/data/recsys.py``: host-side numpy, copied as it is, so
the same ``np.random.default_rng`` gives the same arrays on both sides and
leaves the generator in the same state (``interaction_sequences`` draws
with ``rng.choice(..., p=p)``, so the order of draws is the contract)."""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def item_popularity(n_items: int, a: float = 1.05) -> np.ndarray:
    ranks = np.arange(1, n_items + 1, dtype=np.float64)
    p = ranks ** -a
    return p / p.sum()


def interaction_sequences(
    n_items: int, batch: int, seq: int, rng, p: np.ndarray | None = None
) -> np.ndarray:
    """(B, S) item ids in [1, n_items]; 0 is PAD.  Random-length prefixes are
    padded to model ragged user histories."""
    if p is None:
        p = item_popularity(n_items)
    items = rng.choice(n_items, size=(batch, seq), p=p).astype(np.int32) + 1
    lengths = rng.integers(seq // 4, seq + 1, batch)
    mask = np.arange(seq)[None, :] < lengths[:, None]
    # left-pad (recent history at the end, as BERT4Rec does)
    out = np.zeros((batch, seq), np.int32)
    for b in range(batch):
        L = lengths[b]
        out[b, seq - L :] = items[b, :L]
    return out


def cloze_mask(
    items: np.ndarray, mask_id: int, rng, mask_prob: float = 0.2
) -> Tuple[np.ndarray, np.ndarray]:
    """BERT4Rec Cloze: returns (masked_items, targets) — targets hold the
    true item at masked positions, 0 elsewhere."""
    maskable = items != 0
    m = (rng.random(items.shape) < mask_prob) & maskable
    # guarantee ≥1 mask per row (mask the last valid position)
    none = ~m.any(axis=1)
    last_valid = items.shape[1] - 1 - np.argmax(maskable[:, ::-1], axis=1)
    m[np.nonzero(none)[0], last_valid[none]] = True
    m &= maskable
    masked = np.where(m, mask_id, items)
    targets = np.where(m, items, 0)
    return masked.astype(np.int32), targets.astype(np.int32)


def cloze_mask_positions(
    items: np.ndarray, mask_id: int, max_masked: int, rng, mask_prob: float = 0.2
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Static-shape Cloze for the sampled-softmax loss: at most `max_masked`
    positions per row.  Returns (masked_items, mask_positions (B, M),
    mask_targets (B, M) — 0 marks unused slots)."""
    b, s = items.shape
    masked, targets = cloze_mask(items, mask_id, rng, mask_prob)
    positions = np.zeros((b, max_masked), np.int32)
    ptargets = np.zeros((b, max_masked), np.int32)
    for i in range(b):
        idx = np.nonzero(targets[i])[0][:max_masked]
        # un-mask any overflow beyond the static budget
        overflow = np.nonzero(targets[i])[0][max_masked:]
        masked[i, overflow] = items[i, overflow]
        positions[i, : len(idx)] = idx
        ptargets[i, : len(idx)] = targets[i, idx]
    return masked, positions, ptargets


def interaction_stream(items: np.ndarray, user_ids: np.ndarray) -> Dict[str, np.ndarray]:
    """User→item interactions as a bipartite graph stream for the
    (non-square!) gLava sketch — users hash on rows, items on columns."""
    b, s = items.shape
    src = np.repeat(user_ids.astype(np.uint32), s)
    dst = items.reshape(-1).astype(np.uint32)
    keep = dst != 0
    return {
        "src": src[keep],
        "dst": dst[keep],
        "weight": np.ones(int(keep.sum()), np.float32),
    }
