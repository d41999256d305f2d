"""Models (port of ``src/repro/models``): the transformer LM with its
building blocks and serving entry points, the GNNs (``models.gnn``) and
BERT4Rec (``models.recsys``)."""
from repro_torch.models import gnn, recsys  # noqa: F401
from repro_torch.models.layers import (  # noqa: F401
    MoEArgs,
    chunked_attention,
    decode_attention,
    gqa_attention,
    moe_block,
    moe_capacity,
    moe_ffn_sharded,
    moe_weight_shards,
    swa_attention_halo,
)
from repro_torch.models.transformer import (  # noqa: F401
    TransformerConfig,
    cache_capacity,
    decode_step,
    forward,
    init_cache,
    init_params,
    loss_fn,
    param_specs,
    prefill,
)
