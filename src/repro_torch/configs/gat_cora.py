"""gat-cora [arXiv:1710.10903]: 2 layers, d_hidden=8 per head, 8 heads,
attention aggregator (SDDMM + segment-softmax regime).

Port of ``src/repro/configs/gat_cora.py`` (the same fields; dtypes as
``torch.dtype``)."""
from repro_torch.configs.base import ArchSpec, gnn_shapes, register
from repro_torch.models.gnn.gat import GATConfig

FULL = GATConfig(name="gat-cora", n_layers=2, d_in=1433, d_hidden=8, n_heads=8, out_dim=7)
SMOKE = GATConfig(name="gat-smoke", n_layers=2, d_in=12, d_hidden=4, n_heads=2, out_dim=3)

SPEC = register(
    ArchSpec(
        arch_id="gat-cora",
        family="gnn",
        config=FULL,
        smoke_config=SMOKE,
        shapes=gnn_shapes(),
        notes="Edge-softmax attention; d_in/out_dim overridden per shape cell.",
    )
)
