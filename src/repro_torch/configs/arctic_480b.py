"""arctic-480b [hf:Snowflake/snowflake-arctic-base]: 35L d_model=7168 56H
(GQA kv=8) d_ff=4864 vocab=32000, MoE 128 experts top-2 + dense residual.

~475B total params — the FSDP fit case: bf16 params + bf16 Adam moments
sharded over all mesh axes (DESIGN.md Section 4).  128 experts / 16-way
model axis = 8 experts per chip (partition="expert" = EP).
n_heads=56 does not divide the 16-way model axis; the merged head*dh dim
(7168) does — the sharding resolver uses the merged dim (DESIGN.md).

Port of ``src/repro/configs/arctic_480b.py`` (the same fields; dtypes as
``torch.dtype``)."""
import torch

from repro_torch.configs.base import ArchSpec, lm_shapes, register
from repro_torch.models.layers import MoEArgs
from repro_torch.models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="arctic-480b",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_head=128,
    d_ff=4864,
    vocab=32000,
    rope_theta=1e6,
    moe=MoEArgs(n_experts=128, top_k=2, dense_residual=True, partition="expert"),
    param_dtype=torch.bfloat16,
)

SMOKE = TransformerConfig(
    name="arctic-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=96,
    vocab=256,
    moe=MoEArgs(n_experts=8, top_k=2, dense_residual=True, partition="expert"),
    compute_dtype=torch.float32,
)

SPEC = register(
    ArchSpec(
        arch_id="arctic-480b",
        family="lm",
        config=FULL,
        smoke_config=SMOKE,
        shapes=lm_shapes(None),
        notes="Dense-residual MoE; pure full attention -> long_500k skipped.",
    )
)
