"""Plain PyTorch version of one boolean squaring step of transitive closure
(port of ``src/repro/kernels/closure/ref.py``)."""
from __future__ import annotations

import torch


def closure_step_ref(a: torch.Tensor) -> torch.Tensor:
    """a (..., w, w) float32 in {0, 1} -> a OR (a @ a > 0), as float32 {0, 1}."""
    prod = torch.matmul(a, a)
    return torch.clamp(a + (prod > 0).to(a.dtype), 0.0, 1.0)
