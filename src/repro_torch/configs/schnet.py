"""schnet [arXiv:1706.08566]: 3 interactions, d_hidden=64, 300 RBF, cutoff 10.

Molecular net: positions are REQUIRED inputs.  On the citation/product graph
shapes the pipeline synthesizes 3-D positions and the model projects the
continuous features (feature_mode="project"); on molecule it embeds atom
types (DESIGN.md Section 5).

Port of ``src/repro/configs/schnet.py`` (the same fields; dtypes as
``torch.dtype``)."""
from repro_torch.configs.base import ArchSpec, gnn_shapes, register
from repro_torch.models.gnn.schnet import SchNetConfig

FULL = SchNetConfig(
    name="schnet", n_interactions=3, d_hidden=64, n_rbf=300, cutoff=10.0
)
SMOKE = SchNetConfig(
    name="schnet-smoke", n_interactions=2, d_hidden=16, n_rbf=24, cutoff=5.0,
    n_atom_types=10,
)

SPEC = register(
    ArchSpec(
        arch_id="schnet",
        family="gnn",
        config=FULL,
        smoke_config=SMOKE,
        shapes=gnn_shapes(),
        notes="Triplet-free molecular regime; task head per shape cell.",
    )
)
