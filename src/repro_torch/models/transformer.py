"""Decoder-only transformer LM, dense: GQA (+ optional qk-norm), RoPE,
optional sliding-window mask, SwiGLU FFN, RMSNorm or OLMo's non-parametric
LayerNorm.

Port of ``src/repro/models/transformer.py`` (the training forward and
loss).  Parameters keep the reference's tree: the same names, each layer
parameter stacked on a leading L axis, matrices in the ``(in, out)`` layout
(``h @ W``), so a reference checkpoint converts by plain copies
(``repro_torch.convert.transformer_params_from_arrays``) and the flat
gradient comes out in the reference's order.  ``forward`` walks the layers
in a Python loop and casts each layer's parameters to ``compute_dtype`` as
the reference's scan body does.

Not ported yet (ROADMAP A12): MoE, query-chunked and halo attention,
activation sharding constraints, rematerialisation, ``prefill`` and
``decode_step``; a config that asks for one raises ``NotImplementedError``.
The reference's ``scan_layers`` and ``attn_window_slicing`` knobs have no
counterpart: an eager loop has no scan, and window slicing applies only to
chunked attention.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.models.layers import apply_norm, apply_rope, gqa_attention, rms_norm, swiglu

_NOT_PORTED = ("moe", "attn_q_chunk", "remat", "act_pspec", "attn_halo_mesh")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None
    norm: str = "rmsnorm"            # "rmsnorm" | "layernorm_nonparam"
    qk_norm: bool = False
    sliding_window: Optional[int] = None
    rope_theta: float = 1e6
    tie_embeddings: bool = False
    moe: Optional[Any] = None
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    attn_q_chunk: Optional[int] = None
    remat: bool = False
    act_pspec: Optional[Any] = None
    attn_halo_mesh: Optional[Any] = None

    def __post_init__(self):
        for field in _NOT_PORTED:
            if getattr(self, field):
                raise NotImplementedError(
                    f"TransformerConfig.{field} is not ported yet (ROADMAP A12)"
                )

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    def param_count(self) -> int:
        d, dh = self.d_model, self.head_dim
        attn = d * dh * (self.n_heads * 2 + self.n_kv_heads * 2)
        per_layer = attn + 3 * d * self.d_ff
        emb = self.vocab * d
        head = 0 if self.tie_embeddings else d * self.vocab
        return self.n_layers * per_layer + emb + head


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def param_shapes(cfg: TransformerConfig) -> Dict:
    """The shape of every parameter, as the reference's tree."""
    d, dh = cfg.d_model, cfg.head_dim
    hq, hkv, f, L = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.n_layers
    layers = {
        "wq": (L, d, hq * dh),
        "wk": (L, d, hkv * dh),
        "wv": (L, d, hkv * dh),
        "wo": (L, hq * dh, d),
        "w_gate": (L, d, f),
        "w_up": (L, d, f),
        "w_down": (L, f, d),
    }
    if cfg.norm == "rmsnorm":
        layers["attn_norm_w"] = (L, d)
        layers["mlp_norm_w"] = (L, d)
    if cfg.qk_norm:
        layers["q_norm_w"] = (L, dh)
        layers["k_norm_w"] = (L, dh)
    shapes = {"embed": (cfg.vocab, d), "layers": layers}
    if cfg.norm == "rmsnorm":
        shapes["final_norm_w"] = (d,)
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, cfg.vocab)
    return shapes


# Matrices in the reference's order of random draws; norm weights start at 1.
_DRAWN = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "embed", "lm_head")


def init_params(
    cfg: TransformerConfig, generator: torch.Generator, device: Optional[torch.device] = None
) -> Dict:
    """The reference's ``init_params`` tree: each matrix ~ N(0, 1/fan_in),
    drawn from ``generator`` (on its own device) in the reference's order,
    then moved to ``device``; norm weights 1."""
    shapes = param_shapes(cfg)
    flat = {**{k: v for k, v in shapes.items() if k != "layers"}, **shapes["layers"]}
    leaves = {}
    for name in _DRAWN:
        if name in flat:
            shape = flat[name]
            fan_in = cfg.d_model if name == "embed" else shape[-2]
            x = torch.randn(shape, generator=generator, device=generator.device, dtype=torch.float32)
            leaves[name] = (x / math.sqrt(fan_in)).to(device=device, dtype=cfg.param_dtype)
    for name, shape in flat.items():
        if name not in leaves:
            leaves[name] = torch.ones(shape, dtype=cfg.param_dtype, device=device)
    return {k: ({n: leaves[n] for n in v} if k == "layers" else leaves[k]) for k, v in shapes.items()}


# ---------------------------------------------------------------------------
# Layer body
# ---------------------------------------------------------------------------


def _project_qkv(cfg: TransformerConfig, lp, h, positions):
    b, s, _ = h.shape
    dh = cfg.head_dim
    q = (h @ lp["wq"]).reshape(b, s, cfg.n_heads, dh)
    k = (h @ lp["wk"]).reshape(b, s, cfg.n_kv_heads, dh)
    v = (h @ lp["wv"]).reshape(b, s, cfg.n_kv_heads, dh)
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm_w"])
        k = rms_norm(k, lp["k_norm_w"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _layer(cfg: TransformerConfig, x, lp, positions):
    h = apply_norm(cfg.norm, x, lp.get("attn_norm_w"))
    q, k, v = _project_qkv(cfg, lp, h, positions)
    attn = gqa_attention(q, k, v, causal=True, sliding_window=cfg.sliding_window)
    b, s, _ = x.shape
    x = x + attn.reshape(b, s, -1) @ lp["wo"]
    h2 = apply_norm(cfg.norm, x, lp.get("mlp_norm_w"))
    return x + swiglu(h2, lp["w_gate"], lp["w_up"], lp["w_down"])


# ---------------------------------------------------------------------------
# Training forward / loss
# ---------------------------------------------------------------------------


def forward(cfg: TransformerConfig, params: Dict, tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (logits (B, S, V), aux_loss)."""
    b, s = tokens.shape
    tokens = tokens.long()
    x = params["embed"][tokens].to(cfg.compute_dtype)
    positions = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
    for i in range(cfg.n_layers):
        lp = {name: w[i].to(cfg.compute_dtype) for name, w in params["layers"].items()}
        x = _layer(cfg, x, lp, positions)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)  # dense: no MoE loss
    x = apply_norm(cfg.norm, x, params.get("final_norm_w"))
    head = params["lm_head"] if "lm_head" in params else params["embed"].T
    logits = x @ head.to(cfg.compute_dtype)
    return logits, aux


def loss_fn(cfg: TransformerConfig, params: Dict, tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """Causal LM loss over tokens (B, S+1): predict tokens[:,1:]."""
    inputs, targets = tokens[:, :-1], tokens[:, 1:].long()
    logits, aux = forward(cfg, params, inputs)
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    xent = torch.mean(logz - gold)
    return xent + aux, {"xent": xent, "aux": aux}


class Transformer(nn.Module):
    """The model as a module: its parameters are the reference's tree
    (``param_tree()``), drawn from ``generator`` on construction."""

    def __init__(
        self,
        cfg: TransformerConfig,
        generator: torch.Generator,
        device: Optional[torch.device] = None,
    ):
        super().__init__()
        self.cfg = cfg
        params = init_params(cfg, generator, device)
        self.layers = nn.ParameterDict({k: nn.Parameter(v) for k, v in params.pop("layers").items()})
        self.top = nn.ParameterDict({k: nn.Parameter(v) for k, v in params.items()})

    def param_tree(self) -> Dict:
        """The parameters as the reference's tree (the module's own tensors)."""
        return {**dict(self.top.items()), "layers": dict(self.layers.items())}

    def forward(self, tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return forward(self.cfg, self.param_tree(), tokens)

    def loss_fn(self, tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        return loss_fn(self.cfg, self.param_tree(), tokens)
