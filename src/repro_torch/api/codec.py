"""Key codec: node labels -> uint32 device keys, at the API boundary.

Port of ``src/repro/api/codec.py``.  Integer labels are a masked cast (the
identity on values already in the uint32 key space); string labels hash
with 32-bit FNV-1a, vectorized over the batch
(:func:`repro_torch.core.hashing.fnv1a_labels`).  Encoding is deterministic
and stateless, so the port and the reference map a label to the same key.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.hashing import fnv1a_labels


def encode_labels(labels) -> np.ndarray:
    """Encode node labels (scalar, sequence, or array; str or int) to uint32,
    in the input's shape (0-d for a scalar label)."""
    return fnv1a_labels(labels)


def encode_label(label) -> np.uint32:
    """Scalar convenience: one label -> one uint32 key."""
    return np.uint32(encode_labels(label))
