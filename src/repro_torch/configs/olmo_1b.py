"""olmo-1b [arXiv:2402.00838]: 16L d_model=2048 16H (MHA: kv=16) d_ff=8192
vocab=50304 — non-parametric LayerNorm, tied embeddings.

Port of ``src/repro/configs/olmo_1b.py`` (the same fields; dtypes as
``torch.dtype``)."""
import torch

from repro_torch.configs.base import ArchSpec, lm_shapes, register
from repro_torch.models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="olmo-1b",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=50304,
    norm="layernorm_nonparam",
    tie_embeddings=True,
    rope_theta=1e4,
    param_dtype=torch.bfloat16,
)

SMOKE = TransformerConfig(
    name="olmo-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=256,
    norm="layernorm_nonparam",
    tie_embeddings=True,
    compute_dtype=torch.float32,
)

SPEC = register(
    ArchSpec(
        arch_id="olmo-1b",
        family="lm",
        config=FULL,
        smoke_config=SMOKE,
        shapes=lm_shapes(None),
        notes="Non-parametric LN, tied embeddings; long_500k skipped.",
    )
)
