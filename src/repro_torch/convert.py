"""Carry a reference sketch's state across to the port.

The JAX package's ``GLavaSketch`` is a pytree whose leaves, read out as
numpy arrays, are ``counters``, ``row_flows``, ``col_flows`` and the hash
coefficients ``row_hash.a``/``row_hash.b`` (plus ``col_hash.a``/``.b`` when
the sketch is non-square).  :func:`sketch_from_arrays` builds the port's
:class:`~repro_torch.core.sketch.GLavaSketch` from exactly those arrays, so
both sides hash identically; ``GraphStream.open(sketch=...)`` opens a
session on it.  This module takes numpy only and never imports the
reference.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.hashing import HashFamily
from repro_torch.core.sketch import GLavaSketch, SketchConfig


def sketch_from_arrays(
    config: SketchConfig,
    counters: np.ndarray,
    row_flows: np.ndarray,
    col_flows: np.ndarray,
    row_a: np.ndarray,
    row_b: np.ndarray,
    col_a: Optional[np.ndarray] = None,
    col_b: Optional[np.ndarray] = None,
    device: Optional[torch.device] = None,
) -> GLavaSketch:
    """A port sketch on ``device`` from the reference's leaves.  Square
    configs share one family (``col_a``/``col_b`` must then be omitted or
    equal to the row coefficients)."""
    d, wr, wc = config.depth, config.width_rows, config.width_cols
    if np.shape(counters) != (d, wr, wc):
        raise ValueError(f"counters shape {np.shape(counters)} != {(d, wr, wc)}")
    row_hash = HashFamily.from_host(row_a, row_b, wr, device)
    if config.is_square:
        for given, want in ((col_a, row_a), (col_b, row_b)):
            if given is not None and not np.array_equal(np.asarray(given), np.asarray(want)):
                raise ValueError("a square sketch shares one hash family for rows and columns")
        col_hash = row_hash
    else:
        if col_a is None or col_b is None:
            raise ValueError("a non-square sketch needs col_a and col_b")
        col_hash = HashFamily.from_host(col_a, col_b, wc, device)

    def f32(x):
        return torch.from_numpy(np.array(x, np.float32, copy=True)).to(device)

    return GLavaSketch(f32(counters), row_hash, col_hash, config, f32(row_flows), f32(col_flows))
