"""dimenet [arXiv:2003.03123]: 6 blocks, d_hidden=128, n_bilinear=8,
n_spherical=7, n_radial=6 — triplet-gather kernel regime.

Triplet lists get a static budget min(8·n_edges, 2^26) (configs.base.
triplet_budget); the cap is logged whenever it truncates (DESIGN.md).

Port of ``src/repro/configs/dimenet.py`` (the same fields; dtypes as
``torch.dtype``)."""
from repro_torch.configs.base import ArchSpec, gnn_shapes, register
from repro_torch.models.gnn.dimenet import DimeNetConfig

FULL = DimeNetConfig(
    name="dimenet", n_blocks=6, d_hidden=128, n_bilinear=8, n_spherical=7,
    n_radial=6, cutoff=5.0,
)
SMOKE = DimeNetConfig(
    name="dimenet-smoke", n_blocks=2, d_hidden=16, n_bilinear=4, n_spherical=3,
    n_radial=4, cutoff=5.0, n_atom_types=10,
)

SPEC = register(
    ArchSpec(
        arch_id="dimenet",
        family="gnn",
        config=FULL,
        smoke_config=SMOKE,
        shapes=gnn_shapes(),
        notes="Quadratic-in-degree triplet lists; budgeted statically.",
    )
)
