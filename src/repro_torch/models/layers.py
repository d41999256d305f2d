"""Transformer building blocks: norms, RoPE, grouped-query attention (full,
sliding-window, query-chunked, decode against a ring cache, and the halo
exchange of a sequence-sharded window), the SwiGLU MLP and the
capacity-based mixture of experts (local and sharded).

Port of ``src/repro/models/layers.py``.  The reference computes these in
plain jnp (none is a Pallas kernel), so the port is plain torch ops and
``torch.matmul``, step for step in the reference's math and dtypes: norms
and rotary angles in float32 and cast back, attention logits and softmax in
float32 with the probabilities cast to ``v``'s dtype, split-half (not
interleaved) rotation, the router in float32, the MoE combine in ``x``'s
dtype with the gates cast to the expert output's.

The sharded forms (:func:`swa_attention_halo`, :func:`moe_ffn_sharded`)
take this rank's local shards and a :class:`repro_torch.distributed.mesh.
Mesh`, where the reference takes global arrays under ``shard_map``.  The
mesh has only ``all_reduce_`` (gloo runs only ``all_reduce`` and
``broadcast`` on CUDA tensors), so each of the reference's collectives is
one ``SUM`` all-reduce: a gather or an all-to-all sums zero-filled buffers
that each hold one rank's disjoint block (exact in any dtype), a ppermute
does the same and each rank keeps its left neighbour's block, a
``psum_scatter`` sums and keeps the rank's slice, a ``pmean`` sums and
divides by the group's size.  ``dist.all_reduce`` records no autograd
graph, so the sharded forms are forward only (the serving path).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import Placement, check_placement


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

_MASKED = -1e30


def _attend_at(q, k, v, q_pos, k_pos, *, causal, sliding_window, kv_valid_len=None):
    """``softmax(q·kᵀ/√Dh + mask)·v`` for ``q`` (B, Sq, Hq, Dh) against
    ``k``/``v`` (B, Skv, Hkv, Dh) at absolute positions ``q_pos`` (Sq, 1) and
    ``k_pos`` (1, Skv) (negative key positions are padding and masked);
    q head h attends kv head h // (Hq // Hkv).  Returns (B, Sq, Hq, Dh)."""
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    # The G query heads of a KV head share one (G·Sq)-row product with it.
    qf = q.to(torch.float32).reshape(b, sq, hkv, g, dh).permute(0, 2, 3, 1, 4).reshape(b, hkv, g * sq, dh)
    kf = k.permute(0, 2, 1, 3).to(torch.float32, memory_format=torch.contiguous_format)  # (B, Hkv, Skv, Dh)
    logits = (torch.matmul(qf, kf.transpose(-1, -2)) * (1.0 / math.sqrt(dh))).reshape(b, hkv, g, sq, skv)
    mask = k_pos >= 0
    if causal:
        mask = mask & (k_pos <= q_pos)
    if sliding_window is not None:
        mask = mask & (k_pos > q_pos - sliding_window)
    if kv_valid_len is not None:
        mask = mask & (k_pos < torch.reshape(kv_valid_len, (-1, 1, 1, 1, 1)))
    probs = torch.softmax(logits.masked_fill(~mask, _MASKED), dim=-1).to(v.dtype)
    out = torch.matmul(probs.reshape(b, hkv, g * sq, skv), v.permute(0, 2, 1, 3))  # (B, Hkv, G·Sq, Dh)
    return out.reshape(b, hkv, g, sq, dh).permute(0, 3, 1, 2, 4).reshape(b, sq, hq, dh)


def gqa_attention(
    q: torch.Tensor,  # (B, Sq, Hq, Dh)
    k: torch.Tensor,  # (B, Skv, Hkv, Dh)
    v: torch.Tensor,  # (B, Skv, Hkv, Dh)
    *,
    causal: bool,
    q_offset: Union[torch.Tensor, int] = 0,
    sliding_window: Optional[int] = None,
    kv_valid_len: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Grouped-query attention.  q head h attends kv head h // (Hq//Hkv).

    ``q_offset``: absolute position of q[0] (decode: the cache length; an
    int or a 0-d tensor on ``q``'s device).  ``kv_valid_len``: the number of
    valid cache slots, a (B,) or 0-d tensor (decode with ring or partial
    caches); None means all of Skv is valid."""
    q_pos = torch.arange(q.shape[1], device=q.device)[:, None] + q_offset
    k_pos = torch.arange(k.shape[1], device=q.device)[None, :]
    return _attend_at(q, k, v, q_pos, k_pos, causal=causal, sliding_window=sliding_window,
                      kv_valid_len=kv_valid_len)


def _chunk_rows(fn, *args):
    """``fn(*args)``, rematerialized in the backward when grad is enabled
    (as the reference's ``jax.checkpoint`` on a chunk body: the chunk's
    probabilities are recomputed, not stored)."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def chunked_attention(
    q: torch.Tensor,  # (B, Sq, Hq, Dh)
    k: torch.Tensor,  # (B, Skv, Hkv, Dh)
    v: torch.Tensor,
    *,
    causal: bool,
    sliding_window: Optional[int] = None,
    q_chunk: int = 512,
    window_slicing: bool = False,
) -> torch.Tensor:
    """Query-chunked attention with rematerialized chunk bodies.

    Peak live memory is one (B, Hkv, G, q_chunk, Skv) fp32 logits block
    instead of the full S² score tensor; a Python loop over the chunks
    writes into one preallocated output, and each chunk body runs under
    ``torch.utils.checkpoint`` when grad is enabled.  The last chunk holds
    the ``Sq % q_chunk`` queries left, unpadded.

    ``window_slicing``: each query chunk attends only its (window +
    q_chunk)-wide K/V slice, ``[max(0, q0 - window), q0 + q_chunk)``,
    instead of all of Skv, with the key positions labelled from the start
    actually used, so it equals dense masked attention at every length.
    (The reference's slice clamps the last chunk's start while labelling
    the keys from the unclamped one, so it differs from dense attention
    when Sq is not a multiple of ``q_chunk``: ``src/repro/models/layers.py:
    169–171``.)"""
    sq, skv = q.shape[1], k.shape[1]
    sliced = window_slicing and sliding_window is not None and skv > sliding_window + q_chunk
    out = torch.empty(q.shape, dtype=v.dtype, device=q.device)

    def one_chunk(qblk, kb, vb, q0, k0):
        q_pos = q0 + torch.arange(qblk.shape[1], device=q.device)[:, None]
        k_pos = k0 + torch.arange(kb.shape[1], device=q.device)[None, :]
        return _attend_at(qblk, kb, vb, q_pos, k_pos, causal=causal, sliding_window=sliding_window)

    for q0 in range(0, sq, q_chunk):
        q1 = min(q0 + q_chunk, sq)
        if sliced:
            k0, k1 = max(0, q0 - sliding_window), min(skv, q0 + q_chunk)
        else:
            k0, k1 = 0, skv
        out[:, q0:q1] = _chunk_rows(one_chunk, q[:, q0:q1], k[:, k0:k1], v[:, k0:k1], q0, k0)
    return out


def decode_attention(
    q: torch.Tensor,        # (B, 1, Hq, Dh)
    cache_k: torch.Tensor,  # (B, Skv, Hkv, Dh): k already rotated at write time
    cache_v: torch.Tensor,
    cache_len: torch.Tensor,  # (B,) or 0-d: number of valid slots
) -> torch.Tensor:
    """One-token decode against a (possibly ring) KV cache.  Ring caches pass
    ``cache_len == capacity`` once full; the order inside the ring does not
    matter for plain (non-ALiBi) attention since k carries its own
    rotation."""
    return gqa_attention(q, cache_k, cache_v, causal=False, kv_valid_len=cache_len)


# ---------------------------------------------------------------------------
# Collectives on a Mesh, each one SUM all-reduce
# ---------------------------------------------------------------------------


def _dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def _all_gather(mesh, x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """``jax.lax.all_gather(x, axes, axis=dim, tiled=True)``: a SUM of a
    zero-filled buffer holding this rank's block at its index over
    ``axes``: the all-reduce carries the whole gathered tensor, where a
    gather moves (n-1)/n of it into each rank."""
    n = mesh.size(axes)
    if n == 1:
        return x
    shape = list(x.shape)
    step = shape[dim]
    shape[dim] = n * step
    buf = torch.zeros(shape, dtype=x.dtype, device=x.device)
    i = mesh.index(axes)
    buf.narrow(dim, i * step, step).copy_(x)
    return mesh.all_reduce_(buf, dist.ReduceOp.SUM, axes)


def _ppermute_right(mesh, x: torch.Tensor, axis: str) -> torch.Tensor:
    """``jax.lax.ppermute(x, axis, [(i, i + 1 mod n)])``: each rank gets its
    left neighbour's ``x``, from a gather of every rank's ``x`` (n× the
    payload where a ppermute moves it once)."""
    n = mesh.size(axis)
    if n == 1:
        return x
    return _all_gather(mesh, x[None], axis, 0)[(mesh.index(axis) - 1) % n]


def _all_to_all(mesh, x: torch.Tensor, axis: str, split_dim: int, concat_dim: int) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)``:
    block j of ``x`` along ``split_dim`` goes to rank j, and the blocks a
    rank receives are concatenated along ``concat_dim`` in source order.
    From a gather of every rank's whole ``x``: n× the payload where an
    all-to-all moves (n-1)/n of it."""
    n = mesh.size(axis)
    if n == 1:
        return x
    step = x.shape[split_dim] // n
    every = _all_gather(mesh, x[None], axis, 0)  # (n_src, ...)
    mine = every.narrow(split_dim + 1, mesh.index(axis) * step, step)
    return torch.cat(list(mine.unbind(0)), dim=concat_dim)


def _psum_scatter(mesh, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    """``jax.lax.psum_scatter(x, axis, scatter_dimension=dim, tiled=True)``:
    a SUM of the whole ``x``, then this rank's slice (the all-reduce moves
    n× what a reduce-scatter leaves each rank).  The sum's order is gloo's."""
    n = mesh.size(axis)
    if n == 1:
        return x
    x = mesh.all_reduce_(x.contiguous().clone(), dist.ReduceOp.SUM, axis)
    step = x.shape[dim] // n
    return x.narrow(dim, mesh.index(axis) * step, step)


def _pmean(mesh, x: torch.Tensor, axes) -> torch.Tensor:
    """``jax.lax.pmean(x, axes)``: a SUM over ``axes`` divided by their size."""
    n = mesh.size(axes)
    if n == 1:
        return x
    return mesh.all_reduce_(x.clone(), dist.ReduceOp.SUM, axes) / n


def swa_attention_halo(
    q: torch.Tensor,  # this rank's (B_loc, S_loc, Hq, Dh): batch over the data axes, sequence over "model"
    k: torch.Tensor,  # (B_loc, S_loc, Hkv, Dh)
    v: torch.Tensor,
    *,
    sliding_window: int,
    mesh,
    q_chunk: int = 512,
) -> torch.Tensor:
    """Causal sliding-window attention on a sequence sharded over the
    mesh's ``"model"`` axis, by HALO EXCHANGE instead of a full K/V gather.

    Each rank holds S_loc = S / tp consecutive positions, rank i of
    ``"model"`` positions ``[i·S_loc, (i+1)·S_loc)``.  A window-w query shard
    needs keys from itself and ceil(w / S_loc) left neighbours, so K and V
    go to the right neighbour ``n_halo = min(ceil(w / S_loc), tp - 1)``
    times (each time one emulated ppermute of K and V stacked: an
    all-reduce of tp× their bytes), and each rank attends locally in chunks
    of ``q_chunk`` queries (``S_loc % q_chunk == 0``); wrapped-around keys
    get negative positions and are masked.  Returns this rank's (B_loc,
    S_loc, Hq, Dh)."""
    tp = mesh.size("model")
    s_loc = q.shape[1]
    if s_loc % q_chunk:
        raise ValueError(f"the local sequence {s_loc} is not a multiple of q_chunk={q_chunk}")
    n_halo = min(-(-sliding_window // s_loc), tp - 1)
    kv = torch.stack([k, v])
    parts = [kv]
    for _ in range(n_halo):
        kv = _ppermute_right(mesh, kv, "model")
        parts.insert(0, kv)
    k_ext, v_ext = torch.cat(parts, dim=2)  # each (B_loc, (n_halo + 1)·S_loc, Hkv, Dh)
    q_start = mesh.index("model") * s_loc
    k_pos = q_start - n_halo * s_loc + torch.arange(k_ext.shape[1], device=q.device)[None, :]
    out = torch.empty(q.shape, dtype=v.dtype, device=q.device)

    def one_chunk(qblk, q0):
        q_pos = q0 + torch.arange(q_chunk, device=q.device)[:, None]
        return _attend_at(qblk, k_ext, v_ext, q_pos, k_pos, causal=True, sliding_window=sliding_window)

    for c0 in range(0, s_loc, q_chunk):
        out[:, c0:c0 + q_chunk] = _chunk_rows(one_chunk, q[:, c0:c0 + q_chunk], q_start + c0)
    return out


# ---------------------------------------------------------------------------
# MLP / MoE
# ---------------------------------------------------------------------------


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down


@dataclasses.dataclass(frozen=True)
class MoEArgs:
    """A mixture of experts' settings, as the reference's.  ``partition``
    is the sharded form's strategy: ``"expert"`` (experts over the
    ``"model"`` axis) or ``"ffn"`` (each expert's F dimension over it, when
    the experts do not divide the axis).  ``shard_dispatch`` with a
    ``mesh`` (a port :class:`~repro_torch.distributed.mesh.Mesh`) makes the
    transformer call :func:`moe_ffn_sharded` on each rank's shards.

    ``dispatch_pspec`` is the reference's GSPMD constraint on the (E, C, D)
    dispatch and combine buffers, a
    :class:`~repro_torch.distributed.sharding.Placement` or ``None``: their
    layout on the mesh (``launch/steps.py`` sets it).  A sharding
    constraint changes no value, so the eager program reads it nowhere; any
    other value raises ``TypeError``."""

    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    dense_residual: bool = False  # Arctic: a dense FFN beside the experts
    aux_loss_coef: float = 0.01
    partition: str = "expert"
    dispatch_pspec: Optional[Placement] = None
    shard_dispatch: bool = False
    mesh: Optional[Any] = None

    def __post_init__(self):
        check_placement(self.dispatch_pspec, "MoEArgs.dispatch_pspec")


def moe_capacity(n_tokens: int, args: MoEArgs) -> int:
    """Slots an expert holds for ``n_tokens`` tokens: ``ceil(T·k/E·cf)``
    rounded up to a multiple of 4, at least 4."""
    c = int(math.ceil(n_tokens * args.top_k / args.n_experts * args.capacity_factor))
    return max(4, int(math.ceil(c / 4)) * 4)


def route(x: torch.Tensor, router_w: torch.Tensor, n_experts: int, top_k: int, capacity: int,
          aux_loss_coef: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing of the (T, D) tokens ``x`` into ``capacity`` slots an
    expert: returns the (E, C) int64 token table (T in an unfilled slot),
    the (E, C) float32 gates (0 there) and the load-balance aux loss.

    A (token, k) pair takes the next free slot of its expert in token-major
    order; a pair past the capacity is dropped.  The reference sends a
    dropped pair to expert index E, which XLA's scatter drops; here its
    flat index is E·C, one slot past the table, written and then cut off,
    so no index is ever out of range (a CUDA device assert would end the
    process)."""
    t = x.shape[0]
    e, k, c = n_experts, top_k, capacity
    logits = x.to(torch.float32) @ router_w.to(torch.float32)  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, k, dim=-1)       # (T, K)
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)

    experts = torch.arange(e, device=x.device)
    onehot = expert_idx[..., None] == experts                   # (T, K, E)
    me = torch.mean(probs, dim=0)
    ce = torch.mean(torch.sum(onehot.to(torch.float32), dim=1), dim=0)
    aux = aux_loss_coef * e * torch.sum(me * ce)

    e_flat = expert_idx.reshape(-1)                             # (T·K,)
    pos = torch.cumsum(onehot.reshape(t * k, e).to(torch.int64), dim=0) - 1
    slot = torch.gather(pos, 1, e_flat[:, None])[:, 0]
    flat = torch.where(slot < c, e_flat * c + slot, e * c)      # E·C: dropped
    token_id = torch.arange(t * k, device=x.device) // k
    table = torch.full((e * c + 1,), t, dtype=torch.int64, device=x.device).scatter(0, flat, token_id)
    gates = torch.zeros(e * c + 1, dtype=torch.float32, device=x.device).scatter(0, flat, gate_vals.reshape(-1))
    return table[: e * c].reshape(e, c), gates[: e * c].reshape(e, c), aux


def _experts(xe: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
             gates: torch.Tensor) -> torch.Tensor:
    """The expert SwiGLUs on the (E, C, D) dispatched tokens, weighted by
    the (E, C) gates cast to the output's dtype."""
    h = F.silu(torch.matmul(xe, w_gate)) * torch.matmul(xe, w_up)
    ye = torch.matmul(h, w_down)
    return ye * gates[..., None].to(ye.dtype)


def _combine(ye: torch.Tensor, table: torch.Tensor, t: int, dtype: torch.dtype) -> torch.Tensor:
    """Sum each token's expert outputs into a (T + 1, D) buffer of
    ``dtype`` (row T takes the unfilled slots) and drop row T.  On the card
    ``index_add`` adds in any order; a token receives at most top_k adds
    onto zero, which for top_k <= 2 is exact in any order ((0 + a) + b =
    (0 + b) + a); for top_k > 2 the order may change the last bit."""
    d = ye.shape[-1]
    y = torch.zeros((t + 1, d), dtype=dtype, device=ye.device)
    return y.index_add(0, table.reshape(-1), ye.reshape(-1, d).to(dtype))[:t]


def _dispatch(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The (E, C, D) gather ``x_pad[table]``, row T of ``x_pad`` zeros."""
    x_pad = torch.cat([x, torch.zeros((1, x.shape[1]), dtype=x.dtype, device=x.device)], dim=0)
    return x_pad[table]


def moe_block(
    x: torch.Tensor,        # (T, D)
    router_w: torch.Tensor,  # (D, E)
    w_gate: torch.Tensor,    # (E, D, F)
    w_up: torch.Tensor,      # (E, D, F)
    w_down: torch.Tensor,    # (E, F, D)
    args: MoEArgs,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-based top-k MoE with gather dispatch and scatter combine:
    an (E, C) token table and a gather, the experts as batched matmuls, an
    ``index_add`` back.  Returns (output (T, D), aux_loss)."""
    t = x.shape[0]
    table, gates, aux = route(x, router_w, args.n_experts, args.top_k, moe_capacity(t, args), args.aux_loss_coef)
    ye = _experts(_dispatch(x, table), w_gate, w_up, w_down, gates)
    return _combine(ye, table, t, x.dtype), aux


def moe_weight_shards(w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor, args: MoEArgs):
    """This rank's shards of the full (E, D, F), (E, D, F), (E, F, D) expert
    weights on ``args.mesh``, as the reference's ``moe_ffn_sharded`` lays
    them out: ``"expert"``: E over ``"model"``, D over the data axes;
    ``"ffn"``: F over ``"model"``, D over the data axes."""
    mesh = args.mesh
    dp = _dp_axes(mesh)
    n_dp, i_dp = mesh.size(dp), mesh.index(dp)
    tp, i_tp = mesh.size("model"), mesh.index("model")

    def block(w, dim, n, i):
        step = w.shape[dim] // n
        return w.narrow(dim, i * step, step)

    if args.partition == "expert":
        wg, wu = (block(block(w, 0, tp, i_tp), 1, n_dp, i_dp) for w in (w_gate, w_up))
        wd = block(block(w_down, 0, tp, i_tp), 2, n_dp, i_dp)
    else:
        wg, wu = (block(block(w, 2, tp, i_tp), 1, n_dp, i_dp) for w in (w_gate, w_up))
        wd = block(block(w_down, 1, tp, i_tp), 2, n_dp, i_dp)
    return wg.contiguous(), wu.contiguous(), wd.contiguous()


def moe_ffn_sharded(
    x: torch.Tensor,         # this rank's (B_loc, S_loc, D): batch over the data axes, sequence over "model"
    router_w: torch.Tensor,  # (D, E), whole on every rank
    w_gate: torch.Tensor,    # this rank's shards (moe_weight_shards)
    w_up: torch.Tensor,
    w_down: torch.Tensor,
    args: MoEArgs,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The expert FFN with explicit collectives on ``args.mesh``; each rank
    calls it with its local activations and weight shards and gets its
    (B_loc, S_loc, D) output and the aux loss averaged over the mesh.

    ``partition="expert"``: the FSDP gather of this rank's experts over the
    data axes, local routing of the rank's tokens (capacity from its T_loc),
    the gather dispatch, an all-to-all over ``"model"`` (tokens to their
    experts' owners), the expert matmuls, the reverse all-to-all, the local
    combine.  ``partition="ffn"``: the ``"model"`` peers gather their token
    shards, route the same tokens, compute every expert on the F/tp weight
    shard, combine (still partial over F), then a ``psum_scatter`` returns
    each peer its own rows.  Each collective is one SUM all-reduce (module
    docstring): the weight gather and the token gather carry n× a rank's
    block, the all-to-alls n× the (E, C_loc, D) buffer, the psum_scatter
    the whole (tp·T_loc, D) combine."""
    mesh = args.mesh
    dp = _dp_axes(mesh)
    e, k = args.n_experts, args.top_k
    b_loc, s_loc, d = x.shape
    t_loc = b_loc * s_loc
    xl = x.reshape(t_loc, d)
    w_gate, w_up = (_all_gather(mesh, w, dp, 1) for w in (w_gate, w_up))
    w_down = _all_gather(mesh, w_down, dp, 2)

    if args.partition == "expert":
        c_loc = moe_capacity(t_loc, args)
        table, gates, aux = route(xl, router_w, e, k, c_loc, args.aux_loss_coef)
        xe = _all_to_all(mesh, _dispatch(xl, table), "model", 0, 1)        # (E/tp, tp·C_loc, D)
        gt = _all_to_all(mesh, gates[..., None], "model", 0, 1)[..., 0]
        ye = _experts(xe, w_gate, w_up, w_down, gt)
        ye = _all_to_all(mesh, ye, "model", 1, 0)                           # (E, C_loc, D)
        y = _combine(ye, table, t_loc, x.dtype)
    else:
        xg = _all_gather(mesh, xl, "model", 0)                              # (tp·T_loc, D)
        t = xg.shape[0]
        table, gates, aux = route(xg, router_w, e, k, moe_capacity(t, args), args.aux_loss_coef)
        ye = _experts(_dispatch(xg, table), w_gate, w_up, w_down, gates)   # partial over F
        y = _psum_scatter(mesh, _combine(ye, table, t, x.dtype), "model", 0)
    aux = _pmean(mesh, aux, ("model",) + dp)
    return y.reshape(b_loc, s_loc, d), aux
