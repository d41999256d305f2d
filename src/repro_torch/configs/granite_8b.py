"""granite-8b [arXiv:2405.04324]: 36L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=49152 — llama-architecture code model.

Port of ``src/repro/configs/granite_8b.py`` (the same fields; dtypes as
``torch.dtype``)."""
import torch

from repro_torch.configs.base import ArchSpec, lm_shapes, register
from repro_torch.models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="granite-8b",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab=49152,
    rope_theta=1e4,
    param_dtype=torch.bfloat16,
)

SMOKE = TransformerConfig(
    name="granite-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=256,
    compute_dtype=torch.float32,
)

SPEC = register(
    ArchSpec(
        arch_id="granite-8b",
        family="lm",
        config=FULL,
        smoke_config=SMOKE,
        shapes=lm_shapes(None),
        notes="Dense llama-arch; long_500k skipped (full attention).",
    )
)
