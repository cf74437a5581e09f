"""Transformer building blocks: RMSNorm, RoPE, chunked GQA attention, decode
attention, SwiGLU, sort-based MoE, and their initializers.

Counterpart of ``repro.models.layers``, function for function, with the
reference's casts: bf16 times float32 gives float32 in both frameworks, and
each ``.astype`` there is a ``.to`` here. Matrix products of two types (the
MoE router's float32 weights against bf16 activations) promote both sides as
``jnp.matmul`` does. ``chunked_gqa_attention`` is the flash kernel's
differentiable twin; the LM trains through it (``kernels.flash_attention``'s
backward), each chunk checkpointed as the reference's ``jax.checkpoint``ed
scan body is.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch.overrides import handle_torch_function, has_torch_function
from torch.utils.checkpoint import checkpoint

__all__ = [
    "MoEConfig",
    "rms_norm",
    "rope",
    "apply_rope",
    "chunked_gqa_attention",
    "decode_gqa_attention",
    "swiglu",
    "moe_ffn",
    "moe_ffn_grouped",
    "route_logits",
    "combine_experts",
    "init_dense_ffn",
    "init_moe_ffn",
    "init_attention",
]

_NEG = -1e30


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    var = torch.mean(torch.square(x.to(torch.float32)), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * w


def rope(positions: torch.Tensor, d: int, theta: float = 10000.0):
    """Returns (cos, sin) of shape (..., d//2), float32."""
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=positions.device) / d))
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, D); cos/sin broadcastable (S, D/2). LLaMA half-rotation."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with both promoted to their common type, as ``jnp.matmul``."""
    t = torch.promote_types(a.dtype, b.dtype)
    return a.to(t) @ b.to(t)


def _attn_block(q, k, v, m, l, acc, qpos, kpos, scale, causal):
    """Online-softmax update for one KV chunk. q: (B, Hkv, G, S, hd); k/v:
    (B, Hkv, chunk, hd); K/V are never repeated to query heads."""
    s = torch.einsum("bkgqd,bkcd->bkgqc", q, k).to(torch.float32) * scale
    if causal:
        s = torch.where(qpos[:, None] >= kpos[None, :], s, _NEG)
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l * alpha + p.sum(dim=-1)
    acc_new = acc * alpha[..., None] + torch.einsum(
        "bkgqc,bkcd->bkgqd", p.to(v.dtype), v).to(torch.float32)
    return m_new, l_new, acc_new


def chunked_gqa_attention(
    q: torch.Tensor,  # (B, Hq, S, D)
    k: torch.Tensor,  # (B, Hkv, S, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    chunk: int = 1024,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Memory-O(S·chunk) attention: KV chunks in order with online softmax.

    Under autograd each chunk's update is checkpointed, so the backward
    recomputes chunk logits instead of storing them. Unlike the reference,
    S need not be a multiple of ``chunk``: the last chunk may be shorter.
    """
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    group = hq // hkv
    scale = (d ** -0.5) if scale is None else scale
    chunk = min(chunk, s)
    qg = q.reshape(b, hkv, group, s, d)  # grouped view: no K/V repeat
    qpos = torch.arange(s, dtype=torch.int32, device=q.device)
    m = torch.full((b, hkv, group, s), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hkv, group, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, group, s, d), dtype=torch.float32, device=q.device)
    remat = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    for c0 in range(0, s, chunk):
        kc, vc = k[:, :, c0:c0 + chunk], v[:, :, c0:c0 + chunk]
        kpos = torch.arange(c0, c0 + kc.shape[2], dtype=torch.int32, device=q.device)
        args = (qg, kc, vc, m, l, acc, qpos, kpos, scale, causal)
        m, l, acc = (checkpoint(_attn_block, *args, use_reentrant=False) if remat
                     else _attn_block(*args))
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, hq, s, d).to(q.dtype)


def decode_gqa_attention(
    q: torch.Tensor,  # (B, Hq, 1, D) — one new token
    k_cache: torch.Tensor,  # (B, Hkv, S, D)
    v_cache: torch.Tensor,
    length_mask: torch.Tensor,  # (B, S) bool — which cache slots are filled
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-step decode attention over the whole cache, masked. Takes the
    torch-function protocol (a dry run's ``launch.sharded.ShardedForms``)."""
    if has_torch_function((q, k_cache, v_cache, length_mask)):
        return handle_torch_function(decode_gqa_attention, (q, k_cache, v_cache, length_mask),
                                     q, k_cache, v_cache, length_mask, scale)
    return _decode_gqa_attention(q, k_cache, v_cache, length_mask, scale)


def _decode_gqa_attention(q, k_cache, v_cache, length_mask, scale=None):
    b, hq, _, d = q.shape
    hkv = k_cache.shape[1]
    group = hq // hkv
    scale = (d ** -0.5) if scale is None else scale
    qg = q.reshape(b, hkv, group, d)
    s = torch.einsum("bkgd,bksd->bkgs", qg, k_cache).to(torch.float32) * scale
    s = torch.where(length_mask[:, None, None, :], s, _NEG)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bksd->bkgd", w.to(v_cache.dtype), v_cache)
    return o.reshape(b, hq, 1, d)


def swiglu(x: torch.Tensor, w1, w3, w2) -> torch.Tensor:
    return (F.silu(x @ w1) * (x @ w3)) @ w2


# ---------------------------------------------------------------------------
# Sort-based MoE (capacity-dropped): flatten (token, expert) assignments, sort
# by expert, pack each expert's tokens into (E, C) slots, grouped-GEMM, and
# combine weighted by router gates. The expert choice and the slot order must
# be the reference's exactly (a different tie moves the output by more than
# any tolerance): top-k is a stable descending sort (``jax.lax.top_k`` puts
# the lower index first on ties) and the expert sort is stable, as
# ``jnp.argsort``. ``.at[slot].set`` with the dump slot ``e * capacity`` is a
# write into a buffer one longer, then a slice; ``.at[].add`` is
# ``index_add_`` (both add in update order on the CPU).
# ---------------------------------------------------------------------------


def _top_k(gates: torch.Tensor, k: int):
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(x, router_w, cfg: MoEConfig, capacity: int):
    """Slots of one dispatch group: (token of each slot, t for an empty one;
    its gate in x's type; the mean gates; the expert load)."""
    return route_logits(_mm(x, router_w).to(torch.float32), cfg, capacity, x.dtype)


def route_logits(logits: torch.Tensor, cfg: MoEConfig, capacity: int, dtype: torch.dtype):
    """``_route`` from the group's router logits (T, E), float32. Every
    shape is static: each expert's first sorted position comes from
    ``searchsorted`` on the sorted ids (the reference counts each expert's
    ids into a fixed-length vector, then takes its exclusive cumulative
    sum: the same integers), so a fake trace sizes it and the card makes no
    host sync."""
    t = logits.shape[0]
    e, k = cfg.num_experts, cfg.top_k
    gates = torch.softmax(logits, dim=-1)
    top_g, top_i = _top_k(gates, k)
    top_g = top_g / torch.clamp(top_g.sum(-1, keepdim=True), min=1e-9)
    eids = top_i.reshape(-1)  # (T*k,)
    gvals = top_g.reshape(-1)
    order = torch.argsort(eids, stable=True)
    eids_s = eids[order]
    tok_s = order // k
    g_s = gvals[order]
    starts = torch.searchsorted(eids_s, torch.arange(e, device=logits.device))
    pos = torch.arange(t * k, device=logits.device) - starts[eids_s]
    slot = torch.where(pos < capacity, eids_s * capacity + pos, e * capacity)  # dump slot
    tok_for_slot = torch.full((e * capacity + 1,), t, dtype=torch.long, device=logits.device)
    tok_for_slot[slot] = tok_s
    g_for_slot = torch.zeros((e * capacity + 1,), dtype=dtype, device=logits.device)
    g_for_slot[slot] = g_s.to(dtype)
    me = gates.mean(dim=0)  # (E,)
    ce = torch.zeros((e,), dtype=torch.float32, device=logits.device).index_add_(
        0, eids, torch.ones_like(eids, dtype=torch.float32)) / (t * k)
    return tok_for_slot[:-1], g_for_slot[:-1], me, ce


def _experts(gathered, w1, w3, w2):
    """(..., E, C, d) slots through each expert's SwiGLU."""
    h = torch.einsum("...ecd,edf->...ecf", gathered, w1)
    h3 = torch.einsum("...ecd,edf->...ecf", gathered, w3)
    return torch.einsum("...ecf,efd->...ecd", F.silu(h) * h3, w2)


def combine_experts(x, tok_for_slot, g_for_slot, w1, w3, w2, capacity: int):
    """One group's tokens x (T, d) through the experts of ``w1``/``w3``/``w2``
    (E', ...): slot j of expert i holds token ``tok_for_slot[i * capacity +
    j]`` (T for an empty slot) with gate ``g_for_slot[...]``; the weighted
    outputs added into their tokens' rows, (T, d)."""
    t, d = x.shape
    x_pad = torch.cat([x, torch.zeros((1, d), dtype=x.dtype, device=x.device)], dim=0)
    gathered = x_pad[tok_for_slot].reshape(w1.shape[0], capacity, d)
    out_slots = _experts(gathered, w1, w3, w2)
    out_slots = out_slots.reshape(-1, d) * g_for_slot[:, None]
    return torch.zeros((t + 1, d), dtype=x.dtype, device=x.device).index_add_(
        0, tok_for_slot, out_slots)[:t]


def moe_ffn_grouped(
    x: torch.Tensor,  # (T, d)
    router_w, w1, w3, w2,
    cfg: MoEConfig,
    capacity: int,  # PER-GROUP capacity
    groups: int,
    expert_sharding=None,  # (mesh, placements) of the (G, E, C, d) buffers
):
    """Grouped MoE dispatch: tokens split into ``groups`` independent
    dispatch groups, each with its own capacity. ``expert_sharding`` is the
    reference's GSPMD constraint: on plain tensors inert; it places a dry
    run's DTensor form (``launch.sharded``), which this function reaches
    through the torch-function protocol."""
    if has_torch_function((x, router_w, w1, w3, w2)):
        return handle_torch_function(moe_ffn_grouped, (x, router_w, w1, w3, w2), x, router_w,
                                     w1, w3, w2, cfg, capacity, groups,
                                     expert_sharding=expert_sharding)
    t, d = x.shape
    g, e = groups, cfg.num_experts
    tg = t // g
    xg = x.reshape(g, tg, d)
    routes = [_route(xg[i], router_w, cfg, capacity) for i in range(g)]
    tok_slot = torch.stack([r[0] for r in routes])  # (G, E*C)
    g_slot = torch.stack([r[1] for r in routes])
    me = torch.stack([r[2] for r in routes])
    ce = torch.stack([r[3] for r in routes])
    x_pad = torch.cat([xg, torch.zeros((g, 1, d), dtype=x.dtype, device=x.device)], dim=1)
    gathered = torch.gather(x_pad, 1, tok_slot[..., None].expand(-1, -1, d))
    out_slots = _experts(gathered.reshape(g, e, capacity, d), w1, w3, w2)
    out_slots = out_slots.reshape(g, e * capacity, d) * g_slot[..., None]
    out = torch.stack([
        torch.zeros((tg + 1, d), dtype=x.dtype, device=x.device).index_add_(
            0, tok_slot[i], out_slots[i])[:tg]
        for i in range(g)])  # (G, Tg, d)
    aux = cfg.router_aux_weight * e * torch.mean(torch.sum(me * ce, dim=-1))
    return out.reshape(t, d), aux


def moe_ffn(
    x: torch.Tensor,  # (T, d)
    router_w: torch.Tensor,  # (d, E)
    w1: torch.Tensor,  # (E, d, f)
    w3: torch.Tensor,  # (E, d, f)
    w2: torch.Tensor,  # (E, f, d)
    cfg: MoEConfig,
    capacity: int,
    expert_sharding=None,  # (mesh, placements) of the (E, C, d) buffers
):
    """Ungrouped MoE dispatch; ``expert_sharding`` as ``moe_ffn_grouped``'s."""
    if has_torch_function((x, router_w, w1, w3, w2)):
        return handle_torch_function(moe_ffn, (x, router_w, w1, w3, w2), x, router_w, w1, w3,
                                     w2, cfg, capacity, expert_sharding=expert_sharding)
    tok_for_slot, g_for_slot, me, ce = _route(x, router_w, cfg, capacity)
    out = combine_experts(x, tok_for_slot, g_for_slot, w1, w3, w2, capacity)
    # Switch-style load-balance auxiliary loss
    aux = cfg.router_aux_weight * cfg.num_experts * torch.sum(me * ce)
    return out, aux


# ---------------------------------------------------------------------------
# Initializers: one layer's leaves, each drawn in float32 from ``generator``
# (on its device) and stored in ``dtype`` on ``device``. The reference uses
# JAX random keys, so the values differ; the scales are the same.
# ---------------------------------------------------------------------------


def _normal(generator, shape, scale, dtype, device):
    t = torch.randn(shape, generator=generator, device=generator.device) * scale
    return t.to(dtype=dtype, device=device)


def init_attention(generator, d_model, n_heads, n_kv, head_dim, dtype, device):
    s = d_model ** -0.5
    return {
        "wq": _normal(generator, (d_model, n_heads * head_dim), s, dtype, device),
        "wk": _normal(generator, (d_model, n_kv * head_dim), s, dtype, device),
        "wv": _normal(generator, (d_model, n_kv * head_dim), s, dtype, device),
        "wo": _normal(generator, (n_heads * head_dim, d_model), s, dtype, device),
    }


def init_dense_ffn(generator, d_model, d_ff, dtype, device):
    s = d_model ** -0.5
    return {
        "w1": _normal(generator, (d_model, d_ff), s, dtype, device),
        "w3": _normal(generator, (d_model, d_ff), s, dtype, device),
        "w2": _normal(generator, (d_ff, d_model), d_ff ** -0.5, dtype, device),
    }


def init_moe_ffn(generator, d_model, moe: MoEConfig, dtype, device):
    e, f = moe.num_experts, moe.d_ff_expert
    s = d_model ** -0.5
    return {
        "router": _normal(generator, (d_model, e), s, torch.float32, device),
        "w1": _normal(generator, (e, d_model, f), s, dtype, device),
        "w3": _normal(generator, (e, d_model, f), s, dtype, device),
        "w2": _normal(generator, (e, f, d_model), f ** -0.5, dtype, device),
    }
