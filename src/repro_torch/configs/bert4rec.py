"""bert4rec [arXiv:1904.06690]: embed_dim=64, 2 blocks, 2 heads, seq_len=200,
bidirectional sequential interaction.  Item table sized 1M (retrieval_cand
scores 1M candidates), sharded on the vocab axis.

Port of ``src/repro/configs/bert4rec.py`` (the same fields; dtypes as
``torch.dtype``)."""
import torch

from repro_torch.configs.base import ArchSpec, recsys_shapes, register
from repro_torch.models.recsys.bert4rec import Bert4RecConfig

FULL = Bert4RecConfig(
    name="bert4rec", n_items=1_000_000, embed_dim=64, n_blocks=2, n_heads=2,
    seq_len=200,
)
SMOKE = Bert4RecConfig(
    name="bert4rec-smoke", n_items=500, embed_dim=16, n_blocks=2, n_heads=2,
    seq_len=12, compute_dtype=torch.float32,
)

SPEC = register(
    ArchSpec(
        arch_id="bert4rec",
        family="recsys",
        config=FULL,
        smoke_config=SMOKE,
        shapes=recsys_shapes(),
        notes="Encoder-only: no autoregressive decode shape exists for this "
        "family; all four recsys shapes are live.",
    )
)
