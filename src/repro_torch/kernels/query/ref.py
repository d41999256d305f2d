"""Plain PyTorch version of the batched edge query (port of
``src/repro/kernels/query/ref.py``)."""
from __future__ import annotations

import torch


def edge_query_cells_ref(counters: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor):
    """counters (d, wr, wc); rows/cols (d, Q) -> per-sketch cell values (d, Q)."""
    d_idx = torch.arange(counters.shape[0], device=counters.device)[:, None]
    return counters[d_idx, rows.long(), cols.long()]


def edge_query_min_ref(counters: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor):
    """The fused kernel's function: gather + Γ (min over d) -> (Q,)."""
    return edge_query_cells_ref(counters, rows, cols).amin(dim=0)
