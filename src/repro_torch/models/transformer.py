"""Decoder-only transformer LM: GQA (+ optional qk-norm), RoPE, optional
sliding-window attention (dense, query-chunked, window-sliced or by halo
exchange over a sequence-sharded mesh), SwiGLU FFN, capacity-based MoE (with
an optional dense residual branch), RMSNorm or OLMo's non-parametric
LayerNorm, and the serving entry points over a ring KV cache.

Port of ``src/repro/models/transformer.py``.  Parameters keep the
reference's tree: the same names, each layer parameter stacked on a leading
L axis, matrices in the ``(in, out)`` layout (``h @ W``), so a reference
checkpoint converts by plain copies
(``repro_torch.convert.transformer_params_from_arrays``) and the flat
gradient comes out in the reference's order.  ``forward``, ``prefill`` and
``decode_step`` walk the layers in a Python loop and cast each layer's
parameters to ``compute_dtype`` as the reference's scan body does; with
``remat`` each layer body (cast included) runs under
``torch.utils.checkpoint``.

Three entry points, as the reference's:
  ``loss_fn``      train_4k      (causal LM loss; ``forward`` under it)
  ``prefill``      prefill_32k   (last-position logits + the KV cache)
  ``decode_step``  decode_32k    (one token against the cache)

The cache is a dict of ``k``, ``v`` (L, B, cap, Hkv, Dh) and ``len`` (a 0-d
int32 tensor on the card: the tokens seen so far); a sliding-window model's
cache is a ring of ``cap = min(max_seq, window)`` slots, absolute position
``p`` in slot ``p % cap``.  ``decode_step`` writes its slot in place
(``index_copy_`` at ``len % cap``, read on the device) and never reads
``len`` back to the host.

On a mesh (``moe.shard_dispatch`` with ``moe.mesh``, or ``attn_halo_mesh``)
each rank calls ``forward`` with its local shard of the tokens (batch over
the data axes, sequence over ``"model"``) and gets its shard of the
logits; with ``shard_dispatch`` the ``moe_gate``/``moe_up``/``moe_down``
leaves hold this rank's shards (``layers.moe_weight_shards``).  The serving
entry points take a whole sequence on one rank.

``act_pspec`` is the reference's GSPMD constraint on the layer carry, a
:class:`~repro_torch.distributed.sharding.Placement` or ``None``: the
carry's layout on the mesh, which the dry run reads for the per-device
remat carry (``launch/dryrun.py``).  A sharding constraint changes no
value, so the forward reads it nowhere; any other value raises
``TypeError``.  The reference's ``scan_layers`` has no counterpart: an
eager loop has no scan.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import Placement, check_placement
from repro_torch.models.layers import (
    MoEArgs,
    _all_gather,
    apply_norm,
    apply_rope,
    chunked_attention,
    decode_attention,
    gqa_attention,
    moe_block,
    moe_ffn_sharded,
    rms_norm,
    swa_attention_halo,
    swiglu,
)


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
    moe: Optional[MoEArgs] = None
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    attn_q_chunk: Optional[int] = None   # query-chunked attention block size
    remat: bool = False                  # rematerialize each layer body
    act_pspec: Optional[Placement] = None  # the layer carry's layout on the mesh
    attn_window_slicing: bool = False    # SWA chunks slice their K/V window
    attn_halo_mesh: Optional[Any] = None  # a port Mesh: halo-exchange SWA

    def __post_init__(self):
        check_placement(self.act_pspec, "TransformerConfig.act_pspec")

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    def param_count(self) -> int:
        d, dh = self.d_model, self.head_dim
        attn = d * dh * (self.n_heads * 2 + self.n_kv_heads * 2)
        dense = 3 * d * self.d_ff
        per_layer = attn + dense
        if self.moe is not None:
            per_layer += self.moe.n_experts * 3 * d * self.d_ff + d * self.moe.n_experts
            if not self.moe.dense_residual:
                per_layer -= dense  # the experts replace the dense FFN
        emb = self.vocab * d
        head = 0 if self.tie_embeddings else d * self.vocab
        return self.n_layers * per_layer + emb + head

    def active_param_count(self) -> int:
        """Parameters a token touches (MoE: its top-k experts only): the N
        of MODEL_FLOPS = 6·N_active·D."""
        if self.moe is None:
            return self.param_count()
        inactive = (self.moe.n_experts - self.moe.top_k) * 3 * self.d_model * self.d_ff
        return self.param_count() - self.n_layers * inactive


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
    }
    if cfg.norm == "rmsnorm":
        layers["attn_norm_w"] = (L, d)
        layers["mlp_norm_w"] = (L, d)
    if cfg.qk_norm:
        layers["q_norm_w"] = (L, dh)
        layers["k_norm_w"] = (L, dh)
    if cfg.moe is None or cfg.moe.dense_residual:
        layers["w_gate"] = (L, d, f)
        layers["w_up"] = (L, d, f)
        layers["w_down"] = (L, f, d)
    if cfg.moe is not None:
        e = cfg.moe.n_experts
        layers["router"] = (L, d, e)
        layers["moe_gate"] = (L, e, d, f)
        layers["moe_up"] = (L, e, d, f)
        layers["moe_down"] = (L, e, f, d)
    shapes = {"embed": (cfg.vocab, d), "layers": layers}
    if cfg.norm == "rmsnorm":
        shapes["final_norm_w"] = (d,)
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, cfg.vocab)
    return shapes


# Matrices in the reference's order of random draws; norm weights start at 1.
_DRAWN = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "router", "moe_gate", "moe_up", "moe_down",
          "embed", "lm_head")


def init_params(
    cfg: TransformerConfig, generator: torch.Generator, device: Optional[torch.device] = None
) -> Dict:
    """The reference's ``init_params`` tree: each matrix ~ N(0, 1/fan_in)
    (fan_in its second-to-last dimension, ``d_model`` for the embedding),
    drawn in float32 from ``generator`` (on its own device) in the
    reference's order, then cast to ``param_dtype`` and moved to
    ``device``; norm weights 1."""
    shapes = param_shapes(cfg)
    flat = {**{k: v for k, v in shapes.items() if k != "layers"}, **shapes["layers"]}
    leaves = {}
    for name in _DRAWN:
        if name in flat:
            shape = flat[name]
            fan_in = cfg.d_model if name == "embed" else shape[-2]
            x = torch.randn(shape, generator=generator, device=generator.device, dtype=torch.float32)
            leaves[name] = x.div_(math.sqrt(fan_in)).to(device=device, dtype=cfg.param_dtype)
            del x
    for name, shape in flat.items():
        if name not in leaves:
            leaves[name] = torch.ones(shape, dtype=cfg.param_dtype, device=device)
    return {k: ({n: leaves[n] for n in v} if k == "layers" else leaves[k]) for k, v in shapes.items()}


def param_specs(cfg: TransformerConfig) -> Dict:
    """Logical-axis names of each parameter's dimensions, on the parameter
    tree (the reference's tuples; ``distributed/sharding.py::resolve_tree``
    resolves them onto a mesh)."""
    layers: Dict[str, tuple] = {
        "wq": (None, "embed", "heads"),
        "wk": (None, "embed", "kv_heads"),
        "wv": (None, "embed", "kv_heads"),
        "wo": (None, "heads", "embed"),
    }
    if cfg.norm == "rmsnorm":
        layers["attn_norm_w"] = (None, None)
        layers["mlp_norm_w"] = (None, None)
    if cfg.qk_norm:
        layers["q_norm_w"] = (None, None)
        layers["k_norm_w"] = (None, None)
    if cfg.moe is None or cfg.moe.dense_residual:
        layers["w_gate"] = (None, "embed", "ffn")
        layers["w_up"] = (None, "embed", "ffn")
        layers["w_down"] = (None, "ffn", "embed")
    if cfg.moe is not None:
        layers["router"] = (None, "embed", None)
        if cfg.moe.partition == "expert":
            espec, espec_dn = (None, "experts", "embed", None), (None, "experts", None, "embed")
        else:  # "ffn": each expert's F over the model axis
            espec, espec_dn = (None, None, "embed", "ffn"), (None, None, "ffn", "embed")
        layers["moe_gate"] = espec
        layers["moe_up"] = espec
        layers["moe_down"] = espec_dn
    specs = {"embed": ("vocab", "embed"), "layers": layers}
    if cfg.norm == "rmsnorm":
        specs["final_norm_w"] = (None,)
    if not cfg.tie_embeddings:
        specs["lm_head"] = ("embed", "vocab")
    return specs


# ---------------------------------------------------------------------------
# Layer body
# ---------------------------------------------------------------------------


def _layer_params(cfg: TransformerConfig, layers: Dict, i: int) -> Dict:
    return {name: w[i].to(cfg.compute_dtype) for name, w in layers.items()}


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


def _ffn(cfg: TransformerConfig, lp, h2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense / MoE / MoE + dense-residual FFN on (B, S, D)."""
    b, s, d = h2.shape
    aux = torch.zeros((), dtype=torch.float32, device=h2.device)
    y = torch.zeros_like(h2)
    if cfg.moe is not None:
        experts = (lp["router"], lp["moe_gate"], lp["moe_up"], lp["moe_down"])
        if cfg.moe.shard_dispatch and cfg.moe.mesh is not None:
            moe_out, aux = moe_ffn_sharded(h2, *experts, cfg.moe)
        else:
            moe_out, aux = moe_block(h2.reshape(b * s, d), *experts, cfg.moe)
        y = y + moe_out.reshape(b, s, d)
    if cfg.moe is None or cfg.moe.dense_residual:
        y = y + swiglu(h2, lp["w_gate"], lp["w_up"], lp["w_down"])
    return y, aux


def _model_shard(cfg: TransformerConfig) -> Tuple[int, int]:
    """(this rank's index, the size) of ``attn_halo_mesh``'s ``"model"``
    axis, over which the sequence is sharded; (0, 1) without a mesh."""
    mesh = cfg.attn_halo_mesh
    if mesh is None or "model" not in mesh.shape:
        return 0, 1
    return mesh.index("model"), mesh.size("model")


def _attend(cfg: TransformerConfig, q, k, v):
    """Halo, chunked or dense causal attention, on the reference's
    conditions.  With ``attn_halo_mesh`` q, k, v are this rank's shard of a
    sequence sharded over ``"model"``: the halo exchange when the window
    is shorter than the other shards' span and the local length is a
    multiple of the chunk; otherwise the whole K/V is gathered and the
    local queries attend it densely (what GSPMD does in the reference)."""
    rank, tp = _model_shard(cfg)
    if tp > 1:
        mesh = cfg.attn_halo_mesh
        s = q.shape[1] * tp
        qc = cfg.attn_q_chunk or 512
        usable = cfg.sliding_window is not None and (s // tp) % qc == 0 and cfg.sliding_window < s * (tp - 1) // tp
        if usable:
            return swa_attention_halo(q, k, v, sliding_window=cfg.sliding_window, mesh=mesh, q_chunk=qc)
        k, v = (_all_gather(mesh, t, "model", 1) for t in (k, v))
        return gqa_attention(q, k, v, causal=True, q_offset=rank * q.shape[1], sliding_window=cfg.sliding_window)
    if cfg.attn_q_chunk is not None:
        return chunked_attention(
            q, k, v, causal=True, sliding_window=cfg.sliding_window,
            q_chunk=cfg.attn_q_chunk, window_slicing=cfg.attn_window_slicing,
        )
    return gqa_attention(q, k, v, causal=True, sliding_window=cfg.sliding_window)


def _block(cfg: TransformerConfig, x, lp, positions):
    """One layer on (B, S, D): returns (x, k, v, aux)."""
    h = apply_norm(cfg.norm, x, lp.get("attn_norm_w"))
    q, k, v = _project_qkv(cfg, lp, h, positions)
    attn = _attend(cfg, q, k, v)
    b, s, _ = x.shape
    x = x + attn.reshape(b, s, -1) @ lp["wo"]
    h2 = apply_norm(cfg.norm, x, lp.get("mlp_norm_w"))
    y, aux = _ffn(cfg, lp, h2)
    return x + y, k, v, aux


def _layer(cfg: TransformerConfig, x, lp, positions):
    """One layer on its parameters ``lp``, cast to the compute dtype:
    returns (x, aux)."""
    x, _, _, aux = _block(cfg, x, {name: w.to(cfg.compute_dtype) for name, w in lp.items()}, positions)
    return x, aux


def _positions(cfg: TransformerConfig, b: int, s: int, device) -> torch.Tensor:
    """Absolute int32 positions of a (B, S) block (the reference's
    ``jnp.arange``): this rank's shard of the sequence on
    ``attn_halo_mesh``."""
    rank, _ = _model_shard(cfg)
    return (rank * s + torch.arange(s, dtype=torch.int32, device=device))[None, :].expand(b, s)


def _logits(cfg: TransformerConfig, params: Dict, x):
    x = apply_norm(cfg.norm, x, params.get("final_norm_w"))
    head = params["lm_head"] if "lm_head" in params else params["embed"].T
    return x @ head.to(cfg.compute_dtype)


# ---------------------------------------------------------------------------
# Training forward / loss
# ---------------------------------------------------------------------------


def forward(cfg: TransformerConfig, params: Dict, tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (logits (B, S, V), aux_loss summed over the layers)."""
    b, s = tokens.shape
    tokens = tokens.long()
    x = params["embed"][tokens].to(cfg.compute_dtype)
    positions = _positions(cfg, b, s, tokens.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    # One unbind a stacked leaf: its backward stacks the L layer gradients
    # once, where L indexings would each add a zero-filled (L, ...) gradient.
    layers = {name: torch.unbind(w) for name, w in params["layers"].items()}
    for i in range(cfg.n_layers):
        lp = {name: ws[i] for name, ws in layers.items()}
        if remat:
            x, a = checkpoint(_layer, cfg, x, lp, positions, use_reentrant=False)
        else:
            x, a = _layer(cfg, x, lp, positions)
        aux = aux + a
    return _logits(cfg, params, x), aux


def loss_fn(cfg: TransformerConfig, params: Dict, tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """Causal LM loss over tokens (B, S+1): predict tokens[:,1:]."""
    inputs, targets = tokens[:, :-1], tokens[:, 1:].long()
    logits, aux = forward(cfg, params, inputs)
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    xent = torch.mean(logz - gold)
    return xent + aux, {"xent": xent, "aux": aux}


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------


def cache_capacity(cfg: TransformerConfig, max_seq: int) -> int:
    """Ring capacity: a sliding window bounds the cache by the window."""
    if cfg.sliding_window is not None:
        return min(max_seq, cfg.sliding_window)
    return max_seq


def init_cache(cfg: TransformerConfig, batch: int, max_seq: int, device: Optional[torch.device] = None) -> Dict:
    """An empty cache for ``batch`` sequences of up to ``max_seq`` tokens."""
    shape = (cfg.n_layers, batch, cache_capacity(cfg, max_seq), cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
        "len": torch.zeros((), dtype=torch.int32, device=device),  # tokens seen so far (absolute)
    }


def _one_sequence(cfg: TransformerConfig, what: str) -> None:
    if _model_shard(cfg)[1] > 1 or (cfg.moe is not None and cfg.moe.shard_dispatch and cfg.moe.mesh is not None):
        raise ValueError(f"{what} serves whole sequences on one rank; this config shards them over a mesh")


def prefill(
    cfg: TransformerConfig,
    params: Dict,
    tokens: torch.Tensor,
    max_seq: Optional[int] = None,
) -> Tuple[torch.Tensor, Dict]:
    """tokens (B, S) -> (last-position logits (B, V) float32, cache).

    ``max_seq`` sizes the cache for the decoding that follows (>= S); a
    sliding-window model's cache is capped at the window and laid out as a
    ring (position p in slot p % cap)."""
    _one_sequence(cfg, "prefill")
    b, s = tokens.shape
    tokens = tokens.long()
    x = params["embed"][tokens].to(cfg.compute_dtype)
    positions = _positions(cfg, b, s, tokens.device)
    target_cap = cache_capacity(cfg, max_seq or s)
    cap = min(target_cap, s)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, k, v, _ = _block(cfg, x, _layer_params(cfg, params["layers"], i), positions)
        ks.append(k[:, s - cap:])  # the last `cap` rotated keys and their values
        vs.append(v[:, s - cap:])
    ks, vs = torch.stack(ks), torch.stack(vs)
    logits = _logits(cfg, params, x[:, -1])
    if cap < target_cap:
        # Full-attention decode headroom: positions occupy slots [0, s).
        ks, vs = (F.pad(t, (0, 0, 0, 0, 0, target_cap - cap)) for t in (ks, vs))
    elif cfg.sliding_window is not None and s > cap:
        # Ring layout: absolute position p lives in slot p % cap.
        shift = (s - cap) % cap
        ks, vs = torch.roll(ks, shift, dims=2), torch.roll(vs, shift, dims=2)
    cache = {"k": ks, "v": vs, "len": torch.full((), s, dtype=torch.int32, device=tokens.device)}
    return logits.to(torch.float32), cache


def decode_step(
    cfg: TransformerConfig, params: Dict, token: torch.Tensor, cache: Dict
) -> Tuple[torch.Tensor, Dict]:
    """One decode step: token (B,) -> (logits (B, V) float32, cache).

    Writes the new keys and values into ``cache["k"]``/``cache["v"]`` in
    place, at slot ``len % cap`` (a device index: ``len`` is never read
    on the host), and returns a cache dict holding the same tensors and
    ``len + 1``."""
    _one_sequence(cfg, "decode_step")
    b = token.shape[0]
    cap = cache["k"].shape[2]
    pos = cache["len"]  # 0-d: the absolute position of this token
    slot = torch.remainder(pos, cap).to(torch.int64).reshape(1)
    valid = torch.clamp(pos + 1, max=cap)
    x = params["embed"][token.long()][:, None, :].to(cfg.compute_dtype)
    positions = pos.reshape(1, 1).expand(b, 1)
    for i in range(cfg.n_layers):
        lp = _layer_params(cfg, params["layers"], i)
        h = apply_norm(cfg.norm, x, lp.get("attn_norm_w"))
        q, k, v = _project_qkv(cfg, lp, h, positions)
        ck, cv = cache["k"][i], cache["v"][i]
        ck.index_copy_(1, slot, k.to(ck.dtype))
        cv.index_copy_(1, slot, v.to(cv.dtype))
        attn = decode_attention(q, ck, cv, valid)
        x = x + attn.reshape(b, 1, -1) @ lp["wo"]
        h2 = apply_norm(cfg.norm, x, lp.get("mlp_norm_w"))
        y, _ = _ffn(cfg, lp, h2)
        x = x + y
    logits = _logits(cfg, params, x[:, 0])
    return logits.to(torch.float32), {"k": cache["k"], "v": cache["v"], "len": pos + 1}


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
