"""Transformer building blocks, dense subset: norms, RoPE, grouped-query
attention (causal, with an optional sliding-window mask) and the SwiGLU MLP.

Port of ``src/repro/models/layers.py``.  The reference computes these in
plain jnp (none is a Pallas kernel), so the port is plain torch ops and
``torch.matmul``, step for step in the reference's math and dtypes: norms
and rotary angles in float32 and cast back, attention logits and softmax in
float32 with the probabilities cast to ``v``'s dtype, split-half (not
interleaved) rotation.  ``chunked_attention``, ``decode_attention``,
``swa_attention_halo`` and the MoE functions are not ported yet (ROADMAP
A12).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor], eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.to(torch.float32)
    return y.to(dtype)


def layer_norm_nonparam(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """OLMo's non-parametric LayerNorm: standardize, no scale/bias."""
    dtype = x.dtype
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(dtype)


def apply_norm(kind: str, x: torch.Tensor, weight: Optional[torch.Tensor]) -> torch.Tensor:
    if kind == "rmsnorm":
        return rms_norm(x, weight)
    if kind == "layernorm_nonparam":
        return layer_norm_nonparam(x)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    exponents = torch.arange(0, d_head, 2, dtype=torch.float32, device=device) / d_head
    return 1.0 / (theta ** exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (B, S) int."""
    d_head = x.shape[-1]
    freqs = rope_freqs(d_head, theta, x.device)  # (Dh/2,)
    angles = positions[..., None].to(torch.float32) * freqs  # (B, S, Dh/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def gqa_attention(
    q: torch.Tensor,  # (B, Sq, Hq, Dh)
    k: torch.Tensor,  # (B, Skv, Hkv, Dh)
    v: torch.Tensor,  # (B, Skv, Hkv, Dh)
    *,
    causal: bool,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Grouped-query attention.  q head h attends kv head h // (Hq//Hkv).
    (The reference's ``q_offset`` and ``kv_valid_len`` serve decoding, which
    waits for ROADMAP A12.)"""
    b, sq, hq, dh = q.shape
    _, skv, hkv, _ = k.shape
    groups = hq // hkv
    qg = q.reshape(b, sq, hkv, groups, dh)
    scale = 1.0 / math.sqrt(dh)
    logits = torch.einsum(
        "bqhgd,bkhd->bhgqk", qg.to(torch.float32), k.to(torch.float32)
    ) * scale  # (B, Hkv, G, Sq, Skv)

    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if sliding_window is not None:
        mask &= k_pos > q_pos - sliding_window
    logits = torch.where(mask, logits, torch.full((), -1e30, device=q.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)
    return out.reshape(b, sq, hq, dh)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down
