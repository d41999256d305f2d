"""The paper's own configs: production gLava sketch sizes.

Port of ``src/repro/configs/glava.py`` (the four ``SketchConfig`` presets,
the stream shapes and the ``glava`` ``ArchSpec``).  Sized from Thm 1 /
Lemma 5.2 (w = e/sqrt(eps) resp. e/eps, d = ln(1/delta)) for network
monitoring.  glava-web's counters are 64 GiB total — row-sharded over the
model axis per DESIGN.md Section 4."""
from repro_torch.configs.base import ArchSpec, ShapeSpec, register
from repro_torch.core.sketch import SketchConfig

# d=4 ≈ ln(1/δ) for δ=2%, w=65536 → ε ≈ (e/w)² ≈ 1.7e-9 for edge queries.
WEB = SketchConfig(depth=4, width_rows=65536, width_cols=65536)
BASE = SketchConfig(depth=5, width_rows=8192, width_cols=8192)
NONSQUARE = SketchConfig(depth=5, width_rows=16384, width_cols=4096)
SMOKE = SketchConfig(depth=3, width_rows=256, width_cols=256)

STREAM_SHAPES = {
    "ingest_1m": ShapeSpec("ingest_1m", "sketch_ingest", dict(batch=1_048_576)),
    "query_64k": ShapeSpec("query_64k", "sketch_query", dict(batch=65536)),
}

# The ``query_64k`` stream shape: one batch of 2^16 edge queries.
QUERY_64K = STREAM_SHAPES["query_64k"].params["batch"]

SPEC = register(
    ArchSpec(
        arch_id="glava",
        family="sketch",
        config=BASE,
        smoke_config=SMOKE,
        shapes=STREAM_SHAPES,
        notes="The paper's data structure itself, as a servable config.",
    )
)
