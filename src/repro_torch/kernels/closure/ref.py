"""Plain PyTorch version of one boolean squaring step of transitive closure
(port of ``src/repro/kernels/closure/ref.py``)."""
from __future__ import annotations

import torch


def closure_step_ref(a: torch.Tensor) -> torch.Tensor:
    """a (..., w, w) uint8 in {0, 1} -> a OR (a @ a > 0), as uint8 {0, 1}.
    The product runs in float32, exact: every sum is at most w <= 2^24."""
    af = a.to(torch.float32)
    return ((torch.matmul(af, af) > 0) | (a != 0)).to(torch.uint8)
