"""Plain PyTorch version of the flow reductions (port of
``src/repro/kernels/flow/ref.py``)."""
from __future__ import annotations

import torch


def flows_ref(counters: torch.Tensor):
    """counters (d, wr, wc) -> (out-flows (d, wr) row sums, in-flows (d, wc)
    column sums), paper Section 4.2 Step 1."""
    return counters.sum(dim=2), counters.sum(dim=1)
