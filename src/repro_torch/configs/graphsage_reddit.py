"""graphsage-reddit [arXiv:1706.02216]: 2 layers, d_hidden=128, mean
aggregator, sample sizes 25-10 (minibatch_lg shape overrides to 15-10).

Port of ``src/repro/configs/graphsage_reddit.py`` (the same fields; dtypes as
``torch.dtype``)."""
from repro_torch.configs.base import ArchSpec, gnn_shapes, register
from repro_torch.models.gnn.graphsage import SAGEConfig

FULL = SAGEConfig(name="graphsage-reddit", n_layers=2, d_in=602, d_hidden=128, out_dim=41)
SMOKE = SAGEConfig(name="graphsage-smoke", n_layers=2, d_in=16, d_hidden=8, out_dim=4)

SPEC = register(
    ArchSpec(
        arch_id="graphsage-reddit",
        family="gnn",
        config=FULL,
        smoke_config=SMOKE,
        shapes=gnn_shapes(),
        notes="SpMM regime; d_in/out_dim are overridden per shape cell.",
    )
)
