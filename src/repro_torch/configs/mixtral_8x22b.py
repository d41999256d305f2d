"""mixtral-8x22b [arXiv:2401.04088; hf]: 56L d_model=6144 48H (GQA kv=8)
d_ff=16384 vocab=32768, MoE 8 experts top-2, sliding-window attention.

SWA bounds the KV cache by the window → long_500k decode is sub-quadratic
and RUNS for this arch (the only assigned LM with a live long_500k cell).
8 experts < 16-way model axis → expert tensors are TP-sharded on the FFN dim
(partition="ffn") instead of EP (DESIGN.md Section 4).

Port of ``src/repro/configs/mixtral_8x22b.py`` (the same fields; dtypes as
``torch.dtype``)."""
import torch

from repro_torch.configs.base import ArchSpec, lm_shapes, register
from repro_torch.models.layers import MoEArgs
from repro_torch.models.transformer import TransformerConfig

SLIDING_WINDOW = 4096

FULL = TransformerConfig(
    name="mixtral-8x22b",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=16384,
    vocab=32768,
    sliding_window=SLIDING_WINDOW,
    rope_theta=1e6,
    moe=MoEArgs(n_experts=8, top_k=2, partition="ffn"),
    param_dtype=torch.bfloat16,
)

SMOKE = TransformerConfig(
    name="mixtral-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab=256,
    sliding_window=8,
    moe=MoEArgs(n_experts=4, top_k=2, partition="ffn"),
    compute_dtype=torch.float32,
)

SPEC = register(
    ArchSpec(
        arch_id="mixtral-8x22b",
        family="lm",
        config=FULL,
        smoke_config=SMOKE,
        shapes=lm_shapes(SLIDING_WINDOW),
        notes="MoE top-2 + SWA; long_500k uses the ring KV cache (window 4096).",
    )
)
