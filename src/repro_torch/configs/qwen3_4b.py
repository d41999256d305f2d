"""qwen3-4b [hf:Qwen/Qwen3-8B family]: 36L d_model=2560 32H (GQA kv=8)
d_ff=9728 vocab=151936 — qk-norm, explicit head_dim=128.

Port of ``src/repro/configs/qwen3_4b.py`` (the same fields; dtypes as
``torch.dtype``)."""
import torch

from repro_torch.configs.base import ArchSpec, lm_shapes, register
from repro_torch.models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="qwen3-4b",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=9728,
    vocab=151936,
    qk_norm=True,
    rope_theta=1e6,
    param_dtype=torch.bfloat16,
)

SMOKE = TransformerConfig(
    name="qwen3-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab=256,
    qk_norm=True,
    compute_dtype=torch.float32,
)

SPEC = register(
    ArchSpec(
        arch_id="qwen3-4b",
        family="lm",
        config=FULL,
        smoke_config=SMOKE,
        shapes=lm_shapes(None),
        notes="Dense GQA + qk-norm; long_500k skipped (full attention).",
    )
)
