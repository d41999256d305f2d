"""Plain PyTorch version of the boolean product (``bool_product_wgmma_kernel``
of ``csrc/closure.cu``)."""
from __future__ import annotations

from typing import Optional

import torch


def bool_product_ref(a: torch.Tensor, b_t: torch.Tensor, c0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``c0 OR (a @ b > 0)`` as uint8 {0, 1}, for a (n, M, K) and b given as
    ``b_t`` (n, N, K), both uint8 in {0, 1}, and c0 (n, M, N) or None.  The
    product runs in float32, exact: every sum is at most K <= 2^24."""
    p = torch.matmul(a.to(torch.float32), b_t.to(torch.float32).transpose(-1, -2)) > 0
    if c0 is not None:
        p |= c0 != 0
    return p.to(torch.uint8)
