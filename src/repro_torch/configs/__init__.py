"""Architecture registry (port of ``src/repro/configs``): ``get_arch(id)``
gives an ``ArchSpec`` with its FULL ``config`` and its ``smoke_config``."""
from repro_torch.configs.base import (
    ARCH_IDS,
    ArchSpec,
    ShapeSpec,
    all_archs,
    all_cells,
    get_arch,
    load_all,
    triplet_budget,
)

__all__ = [
    "ARCH_IDS",
    "ArchSpec",
    "ShapeSpec",
    "all_archs",
    "all_cells",
    "get_arch",
    "load_all",
    "triplet_budget",
]
