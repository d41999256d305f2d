"""BERT4Rec (Sun et al., arXiv:1904.06690) — bidirectional self-attention
sequential recommender with Cloze (masked-item) training.

Port of ``src/repro/models/recsys/bert4rec.py``: ``Bert4RecConfig``,
``init_params``, ``param_specs``, ``encode``, ``cloze_loss``,
``cloze_loss_sampled``, ``score_all_items``, ``score_candidates`` and
``embedding_bag`` as plain functions on the reference's parameter tree
(``repro_torch.convert.bert4rec_params_from_arrays`` carries one across).
No Pallas kernel in the reference: gathers, GEMMs and reductions.

Assigned config: embed_dim=64, 2 blocks, 2 heads, seq_len=200, bidirectional
interaction.  The item-embedding table is the huge-sparse-table axis of the
recsys regime (1M items here); lookups are gathers, and the multi-hot bag
path is EmbeddingBag built from a gather and a masked reduce.

Where torch's defaults differ from the reference's, the reference wins:
the layer norm's variance is the population variance (``jnp.var``;
``correction=0``), GELU is ``jax.nn.gelu``'s tanh approximation
(:func:`gelu`), and ``encode`` keeps the reference's bf16 order: the
embedding sum in float32, then cast; block parameters cast to
``compute_dtype`` (the norm weights too, then widened again); the norms in
float32, cast back; the attention logits in float32 from the rounded q and
k, masked with -1e30, softmaxed in float32 and cast.

Encoder-only: no autoregressive decode — the four recsys shapes are
train_batch (Cloze loss), serve_p99 / serve_bulk (score all items at the
last position), retrieval_cand (one user against 1M candidates).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class Bert4RecConfig:
    name: str = "bert4rec"
    n_items: int = 1_000_000     # vocab incl. [PAD]=0; [MASK]=n_items+1
    embed_dim: int = 64
    n_blocks: int = 2
    n_heads: int = 2
    seq_len: int = 200
    d_ff_mult: int = 4
    n_negatives: int = 2048      # sampled-softmax negatives (train_batch)
    compute_dtype: torch.dtype = torch.bfloat16

    @property
    def vocab(self) -> int:
        # PAD + MASK, padded to a 512 multiple so the vocab axis shards
        # evenly on the 16/32-way mesh axes.
        return ((self.n_items + 2 + 511) // 512) * 512

    @property
    def max_masked(self) -> int:
        return max(1, self.seq_len // 4)

    @property
    def mask_id(self) -> int:
        return self.n_items + 1

    def param_count(self) -> int:
        d = self.embed_dim
        per = 4 * d * d + 2 * d * d * self.d_ff_mult
        return self.vocab * d + self.seq_len * d + self.n_blocks * per


def param_shapes(cfg: Bert4RecConfig) -> Dict:
    """The shape of every parameter, as the reference's tree (the blocks
    stacked on a leading ``n_blocks`` axis)."""
    d, f, nb = cfg.embed_dim, cfg.embed_dim * cfg.d_ff_mult, cfg.n_blocks
    blocks = {"wq": (nb, d, d), "wk": (nb, d, d), "wv": (nb, d, d), "wo": (nb, d, d), "w1": (nb, d, f),
              "w2": (nb, f, d), "ln1_w": (nb, d), "ln1_b": (nb, d), "ln2_w": (nb, d), "ln2_b": (nb, d)}
    return {"item_embed": (cfg.vocab, d), "pos_embed": (cfg.seq_len, d), "out_bias": (cfg.vocab,),
            "blocks": blocks}


def init_params(cfg: Bert4RecConfig, generator: torch.Generator, device: Optional[torch.device] = None) -> Dict:
    """The reference's tree in float32: every matrix ~ N(0, 1/fan_in) (its
    second-to-last dimension; ``embed_dim`` for the two embeddings), drawn
    from ``generator`` (on its own device) in the reference's order, then
    moved to ``device``; norm weights 1, norm biases and ``out_bias`` 0."""
    shapes = param_shapes(cfg)

    def draw(shape, fan_in):
        x = torch.randn(shape, generator=generator, device=generator.device, dtype=torch.float32)
        return x.div_(math.sqrt(fan_in)).to(device)

    blocks = {name: draw(shapes["blocks"][name], shapes["blocks"][name][-2])
              for name in ("wq", "wk", "wv", "wo", "w1", "w2")}
    for name in ("ln1", "ln2"):
        blocks[f"{name}_w"] = torch.ones(shapes["blocks"][f"{name}_w"], dtype=torch.float32, device=device)
        blocks[f"{name}_b"] = torch.zeros(shapes["blocks"][f"{name}_b"], dtype=torch.float32, device=device)
    return {
        "item_embed": draw(shapes["item_embed"], cfg.embed_dim),
        "pos_embed": draw(shapes["pos_embed"], cfg.embed_dim),
        "out_bias": torch.zeros(shapes["out_bias"], dtype=torch.float32, device=device),
        "blocks": {name: blocks[name] for name in shapes["blocks"]},
    }


def param_specs(cfg: Bert4RecConfig) -> Dict:
    """Logical-axis names of each parameter's dimensions, on the parameter
    tree (the reference's tuples; ``distributed/sharding.py::resolve_tree``
    resolves them onto a mesh)."""
    return {
        "item_embed": ("vocab", None),
        "pos_embed": (None, None),
        "out_bias": ("vocab",),
        "blocks": {
            "wq": (None, "embed", "heads"),
            "wk": (None, "embed", "heads"),
            "wv": (None, "embed", "heads"),
            "wo": (None, "heads", "embed"),
            "w1": (None, "embed", "ffn"),
            "w2": (None, "ffn", "embed"),
            "ln1_w": (None, None),
            "ln1_b": (None, None),
            "ln2_w": (None, None),
            "ln2_b": (None, None),
        },
    }


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation (``F.gelu``'s
    default is the exact erf form)."""
    return F.gelu(x, approximate="tanh")


def _rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` (rows of a 2-D table, entries of a 1-D one) through
    ``F.embedding``, whose backward sums the gradients of repeated ids in
    segments: advanced indexing's backward adds an id's duplicates one after
    another, 1.1 s for a train_batch's zipf-popular items on the card."""
    if table.dim() == 1:
        return F.embedding(ids, table[:, None])[..., 0]
    return F.embedding(ids, table)


def _layer_norm(x, w, b, eps=1e-6):
    mu = torch.mean(x, -1, keepdim=True)
    var = torch.var(x, -1, keepdim=True, correction=0)  # jnp.var: the population variance
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def _norm(x, w, b, dt):
    """The reference's float32 norm of a ``dt`` activation with ``dt``
    parameters, cast back to ``dt``."""
    return _layer_norm(x.to(torch.float32), w.to(torch.float32), b.to(torch.float32)).to(dt)


def encode(cfg: Bert4RecConfig, params: Dict, items: torch.Tensor) -> torch.Tensor:
    """items (B, S) int -> hidden states (B, S, D) in ``compute_dtype``.
    PAD=0 is masked out of attention (bidirectional otherwise)."""
    b, s = items.shape
    dt = cfg.compute_dtype
    items = items.long()
    x = (_rows(params["item_embed"], items) + params["pos_embed"][None, :s]).to(dt)
    attn_mask = (items != 0)[:, None, None, :]  # (B, 1, 1, S)
    h = cfg.n_heads
    dh = cfg.embed_dim // h
    scale = math.sqrt(dh)
    for i in range(cfg.n_blocks):
        bp = {name: w[i].to(dt) for name, w in params["blocks"].items()}
        y = _norm(x, bp["ln1_w"], bp["ln1_b"], dt)
        q = (y @ bp["wq"]).reshape(b, s, h, dh)
        k = (y @ bp["wk"]).reshape(b, s, h, dh)
        v = (y @ bp["wv"]).reshape(b, s, h, dh)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), k.to(torch.float32)) / scale
        logits = logits.masked_fill_(~attn_mask, -1e30)  # in place: one (B, h, S, S) float32 tensor fewer
        probs = torch.softmax(logits, -1).to(dt)
        attn = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, -1)
        x = x + attn @ bp["wo"]
        y2 = _norm(x, bp["ln2_w"], bp["ln2_b"], dt)
        x = x + gelu(y2 @ bp["w1"]) @ bp["w2"]
    return x


def _masked_mean(per_slot: torch.Tensor, targets: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    mask = (targets != 0).to(torch.float32)
    loss = torch.sum(per_slot * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return loss, {"xent": loss, "n_masked": torch.sum(mask)}


def cloze_loss(cfg: Bert4RecConfig, params: Dict, items: torch.Tensor,
               targets: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """Full-softmax Cloze loss (small vocabs / smoke configs).  items has
    [MASK] tokens; targets holds the true item at masked positions, else 0."""
    hidden = encode(cfg, params, items).to(torch.float32)
    logits = hidden @ params["item_embed"].T + params["out_bias"]
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return _masked_mean(logz - gold, targets)


def cloze_loss_sampled(
    cfg: Bert4RecConfig,
    params: Dict,
    items: torch.Tensor,           # (B, S) with [MASK]
    mask_positions: torch.Tensor,  # (B, M) indices of masked slots
    mask_targets: torch.Tensor,    # (B, M) true items at those slots; 0 = unused
    negatives: torch.Tensor,       # (K,) shared negative samples
) -> Tuple[torch.Tensor, Dict]:
    """Sampled-softmax Cloze for production vocabs (1M items): gather the
    ≤M masked positions and score gold vs K shared negatives (no logQ
    correction, as the reference)."""
    hidden = encode(cfg, params, items).to(torch.float32)            # (B, S, D)
    pos = mask_positions.long()[..., None].expand(-1, -1, hidden.shape[-1])
    h_m = torch.gather(hidden, 1, pos)                                # (B, M, D)
    targets = mask_targets.long()
    gold_emb = _rows(params["item_embed"], targets)                   # (B, M, D)
    gold = torch.sum(h_m * gold_emb, -1) + _rows(params["out_bias"], targets)
    neg_ids = negatives.long()
    neg_emb = _rows(params["item_embed"], neg_ids)                    # (K, D)
    neg = torch.einsum("bmd,kd->bmk", h_m, neg_emb).add_(_rows(params["out_bias"], neg_ids))
    logits = torch.cat([gold[..., None], neg], dim=-1)                # (B, M, K+1)
    logz = torch.logsumexp(logits, dim=-1)
    return _masked_mean(logz - gold, mask_targets)


def score_all_items(cfg: Bert4RecConfig, params: Dict, items: torch.Tensor) -> torch.Tensor:
    """Next-item serving: hidden state at the LAST position scores every item
    — (B, vocab) logits.  serve_p99 / serve_bulk shapes."""
    last = encode(cfg, params, items).to(torch.float32)[:, -1]
    return torch.addmm(params["out_bias"], last, params["item_embed"].T)  # one (B, vocab) output


def score_candidates(cfg: Bert4RecConfig, params: Dict, items: torch.Tensor,
                     candidates: torch.Tensor) -> torch.Tensor:
    """retrieval_cand: score (B,) users' last positions against an explicit
    (B, C) candidate list — gather + batched dot, NOT a loop."""
    last = encode(cfg, params, items).to(torch.float32)[:, -1]     # (B, D)
    cand = candidates.long()
    cand_emb = _rows(params["item_embed"], cand)                      # (B, C, D)
    return torch.einsum("bd,bcd->bc", last, cand_emb) + _rows(params["out_bias"], cand)


def embedding_bag(table: torch.Tensor, bags: torch.Tensor, bag_mask: torch.Tensor,
                  mode: str = "mean") -> torch.Tensor:
    """EmbeddingBag built from a gather and a masked reduce.

    bags: (B, L) int item ids, bag_mask: (B, L) bool. Returns (B, D); an
    empty bag gives 0 in every mode.  Used for multi-hot user-feature bags
    in the retrieval tower.
    """
    emb = _rows(table, bags.long())  # (B, L, D)
    m = bag_mask[..., None].to(emb.dtype)
    s = torch.sum(emb * m, dim=1)
    if mode == "sum":
        return s
    if mode == "mean":
        return s / torch.clamp(torch.sum(m, dim=1), min=1.0)
    if mode == "max":
        out = torch.amax(torch.where(bag_mask[..., None], emb, -math.inf), dim=1)
        return torch.where(torch.isfinite(out), out, 0.0)
    raise ValueError(mode)
