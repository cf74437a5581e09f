"""Decoder-only LM (dense + MoE): GQA, qk-norm, RoPE, SwiGLU, KV-cache
decode. Covers the qwen3-14b / smollm-135m / llama3-8b / granite-moe /
qwen3-moe configs.

Counterpart of ``repro.models.transformer``. Parameters are a plain dict
with the reference's layer-stacked (L, ...) leaves, so
``params_from_reference`` maps the reference's tree directly; the layers run
in a Python loop over slices of them. The forward's attention is
``kernels.flash_attention.flash_attention``: the hand-written Hopper kernel
on the card, its plain version on the CPU, and the chunked twin backward.
Decode keeps the reference's plain ``decode_gqa_attention`` and writes the
new K/V into the cache in place (the reference's donated
``dynamic_update_slice``), so no step copies the cache. ``remat=True``
checkpoints each block (``torch.utils.checkpoint``, non-reentrant), as the
reference's ``jax.checkpoint`` with ``nothing_saveable``. The GSPMD fields
of ``LMConfig`` (``act_sharding``, ``logit_sharding``, ``expert_sharding``,
``attn_sharding``, ``scan_unroll``) are kept so that configs compare value
for value; the sharding fields reach ``_wsc`` where the reference
constrains: a redistribute when the activations are DTensors (the dry run on
a production mesh), the identity on plain tensors. ``expert_sharding``
reaches the MoE functions, as the reference's ``_ffn`` passes it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import (
    MoEConfig,
    apply_rope,
    decode_gqa_attention,
    init_attention,
    init_dense_ffn,
    init_moe_ffn,
    moe_ffn,
    moe_ffn_grouped,
    rms_norm,
    rope,
    swiglu,
)

__all__ = ["LMConfig", "init_params", "params_from_reference", "forward", "init_kv_cache",
           "decode_step", "count_params", "active_params", "FLASH_BLOCKS"]

# the flash kernel's tile on the model's forward (query rows, keys), per
# input type: the fastest of tools/flash_times.py's sweeps on the card (bf16:
# every legal tile at smollm-135m's 32k prefill, llama3-8b's 4k layer and the
# 4k train step; float32: PR 16's)
FLASH_BLOCKS = {torch.bfloat16: dict(block_q=128, block_k=128),
                torch.float32: dict(block_q=128, block_k=64)}


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 10000.0
    moe: Optional[MoEConfig] = None
    dtype: Any = torch.bfloat16
    attn_chunk: int = 1024
    remat: bool = True
    # the reference's GSPMD activation constraints, passed to _wsc: (mesh,
    # placements) pairs on a production mesh, redistributing DTensors
    act_sharding: Any = None  # (B, S, d)
    logit_sharding: Any = None  # (B, S, V)
    expert_sharding: Any = None  # (E, C, d) MoE dispatch buffers
    attn_sharding: Any = None  # (B, Hq, S, hd)
    moe_groups: int = 1  # >1: grouped dispatch
    vocab_real: Any = None  # set when vocab is PADDED; the loss masks the tail
    scan_unroll: bool = False  # the reference's dry-run costing switch; inert here

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    def capacity(self, tokens_per_shard: int) -> int:
        assert self.moe is not None
        c = int(tokens_per_shard * self.moe.top_k / self.moe.num_experts
                * self.moe.capacity_factor)
        return max(8, ((c + 7) // 8) * 8)


def _init_layer(cfg: LMConfig, generator, device) -> Dict[str, Any]:
    p = {
        "attn": init_attention(generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                               cfg.dtype, device),
        "ln1": torch.ones((cfg.d_model,), dtype=cfg.dtype, device=device),
        "ln2": torch.ones((cfg.d_model,), dtype=cfg.dtype, device=device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((cfg.hd,), dtype=cfg.dtype, device=device)
        p["k_norm"] = torch.ones((cfg.hd,), dtype=cfg.dtype, device=device)
    if cfg.moe is None:
        p["ffn"] = init_dense_ffn(generator, cfg.d_model, cfg.d_ff, cfg.dtype, device)
    else:
        p["ffn"] = init_moe_ffn(generator, cfg.d_model, cfg.moe, cfg.dtype, device)
    return p


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _layer(layers, i: int):
    """Layer ``i``'s parameters: views into the stacked leaves."""
    return _map(lambda t: t[i], layers)


def init_params(cfg: LMConfig, generator: torch.Generator, device="cuda") -> Dict[str, Any]:
    """Random parameters drawn from ``generator`` (on its device), on
    ``device``: N(0, 1/d_model) embeddings and projections (1/f for the
    down projections), ones for the norms. Each stacked leaf is filled one
    layer at a time, so no float32 copy of a whole leaf exists (llama3-8b's
    w1 is 32 x 4096 x 14336)."""
    dev = resolve_device(device)
    layers = None
    for i in range(cfg.n_layers):
        lp = _init_layer(cfg, generator, dev)
        if layers is None:
            layers = _map(lambda t: torch.empty((cfg.n_layers,) + tuple(t.shape),
                                                dtype=t.dtype, device=dev), lp)
        _map(lambda buf, t: buf[i].copy_(t), layers, lp)
        del lp
    s = cfg.d_model ** -0.5

    def normal(shape):
        t = torch.randn(shape, generator=generator, device=generator.device) * s
        return t.to(dtype=cfg.dtype, device=dev)

    return {
        "embed": normal((cfg.vocab, cfg.d_model)),
        "layers": layers,
        "final_norm": torch.ones((cfg.d_model,), dtype=cfg.dtype, device=dev),
        "unembed": normal((cfg.d_model, cfg.vocab)),
    }


def params_from_reference(tree, cfg: LMConfig, device="cuda") -> Dict[str, Any]:
    """The reference's ``init_params`` tree (leaves as numpy arrays, stacked
    layers with their leading axis) as the port's params on ``device``, each
    leaf in its own type (bf16 arrays come across exactly, through
    float32)."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        a = np.asarray(x)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(device=dev, dtype=torch.bfloat16)
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    return conv(tree)


def _attention(lp, x, cfg: LMConfig, cos, sin, *, cache=None, length_mask=None):
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ lp["attn"]["wq"]).reshape(b, s, h, hd).transpose(1, 2)
    k = (x @ lp["attn"]["wk"]).reshape(b, s, kvh, hd).transpose(1, 2)
    v = (x @ lp["attn"]["wv"]).reshape(b, s, kvh, hd).transpose(1, 2)
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"])
        k = rms_norm(k, lp["k_norm"])
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    q = _wsc(q, cfg.attn_sharding)
    if cache is None:
        o = flash_attention(q, k, v, causal=True, chunk=min(cfg.attn_chunk, s),
                            **FLASH_BLOCKS[q.dtype])
    else:
        k_cache, v_cache, pos = cache
        k_cache[:, :, pos:pos + s] = k  # in place: the cache is never copied
        v_cache[:, :, pos:pos + s] = v
        o = decode_gqa_attention(q, k_cache, v_cache, length_mask)
    o = o.transpose(1, 2).reshape(b, s, h * hd)
    return o @ lp["attn"]["wo"]


def _ffn(lp, x, cfg: LMConfig):
    b, s, d = x.shape
    if cfg.moe is None:
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        return swiglu(x, lp["ffn"]["w1"], lp["ffn"]["w3"], lp["ffn"]["w2"]), zero
    flat = x.reshape(b * s, d)
    ffn = lp["ffn"]
    if cfg.moe_groups > 1:
        out, aux = moe_ffn_grouped(flat, ffn["router"], ffn["w1"], ffn["w3"], ffn["w2"],
                                   cfg.moe, capacity=cfg.capacity(b * s // cfg.moe_groups),
                                   groups=cfg.moe_groups, expert_sharding=cfg.expert_sharding)
    else:
        out, aux = moe_ffn(flat, ffn["router"], ffn["w1"], ffn["w3"], ffn["w2"], cfg.moe,
                           capacity=cfg.capacity(b * s), expert_sharding=cfg.expert_sharding)
    return out.reshape(b, s, d), aux


def _wsc(x, sharding):
    """The reference's GSPMD sharding constraint, kept where the reference
    calls it: a DTensor is redistributed to ``sharding``, a ``(DeviceMesh,
    placements)`` pair (``launch.cells``, on a production mesh). The identity
    on a plain tensor (one card, or a rank's local shard) and where no
    sharding is set."""
    if sharding is None or not hasattr(x, "redistribute"):  # not a DTensor
        return x
    mesh, place = sharding
    return x.redistribute(mesh, place)


def _block(lp, x, cfg: LMConfig, cos, sin):
    a = _wsc(_attention(lp, rms_norm(x, lp["ln1"]), cfg, cos, sin), cfg.act_sharding)
    x = _wsc(x + a, cfg.act_sharding)
    f, aux = _ffn(lp, rms_norm(x, lp["ln2"]), cfg)
    f = _wsc(f, cfg.act_sharding)
    return _wsc(x + f, cfg.act_sharding), aux


def forward(params, tokens: torch.Tensor, cfg: LMConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> logits (B, S, V), aux_loss (float32 scalar)."""
    b, s = tokens.shape
    x = _wsc(params["embed"][tokens.long()], cfg.act_sharding)
    cos, sin = rope(torch.arange(s, device=tokens.device), cfg.hd, cfg.rope_theta)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        if remat:
            x, a = checkpoint(_block, lp, x, cfg, cos, sin, use_reentrant=False)
        else:
            x, a = _block(lp, x, cfg, cos, sin)
        aux = aux + a
    x = rms_norm(x, params["final_norm"])
    return _wsc(x @ params["unembed"], cfg.logit_sharding), aux


# ---------------------------------------------------------------------------
# KV-cache decode
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: LMConfig, batch: int, max_len: int, dtype=None, device="cuda"):
    dtype = dtype or cfg.dtype
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.hd)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def decode_step(params, cache, tokens: torch.Tensor, pos: int, cfg: LMConfig):
    """One decode step. tokens (B, 1); pos the current position.

    Returns (logits (B, V), cache): the cache (L, B, Hkv, S, D) is the one
    given, its slot ``pos`` written in place.
    """
    b = tokens.shape[0]
    pos = int(pos)
    max_len = cache["k"].shape[3]
    x = _wsc(params["embed"][tokens.long()], cfg.act_sharding)  # (B, 1, d)
    cos, sin = rope(torch.tensor([pos], device=tokens.device), cfg.hd, cfg.rope_theta)
    length_mask = (torch.arange(max_len, device=tokens.device)[None, :] <= pos).expand(b, max_len)
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        x = x + _attention(lp, rms_norm(x, lp["ln1"]), cfg, cos, sin,
                           cache=(cache["k"][i], cache["v"][i], pos), length_mask=length_mask)
        f, _ = _ffn(lp, rms_norm(x, lp["ln2"]), cfg)
        x = x + f
    x = rms_norm(x, params["final_norm"])
    return (x @ params["unembed"])[:, 0, :], cache


def count_params(cfg: LMConfig) -> int:
    d, hd = cfg.d_model, cfg.hd
    attn = d * (cfg.n_heads * hd) * 2 + d * (cfg.n_kv_heads * hd) * 2
    if cfg.moe is None:
        ffn = 3 * d * cfg.d_ff
    else:
        ffn = cfg.moe.num_experts * 3 * d * cfg.moe.d_ff_expert + d * cfg.moe.num_experts
    per_layer = attn + ffn + 2 * d + (2 * hd if cfg.qk_norm else 0)
    return cfg.n_layers * per_layer + 2 * cfg.vocab * d + d


def active_params(cfg: LMConfig) -> int:
    """Active (per-token) parameters — MoE counts only top_k experts."""
    if cfg.moe is None:
        return count_params(cfg)
    d, hd = cfg.d_model, cfg.hd
    attn = d * (cfg.n_heads * hd) * 2 + d * (cfg.n_kv_heads * hd) * 2
    ffn = cfg.moe.top_k * 3 * d * cfg.moe.d_ff_expert + d * cfg.moe.num_experts
    per_layer = attn + ffn + 2 * d + (2 * hd if cfg.qk_norm else 0)
    return cfg.n_layers * per_layer + 2 * cfg.vocab * d + d
