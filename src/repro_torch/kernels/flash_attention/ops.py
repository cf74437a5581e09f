"""Differentiable flash attention: the kernel (or, on the CPU, its plain
version) forward, the chunked online-softmax twin backward.

Counterpart of ``repro.kernels.flash_attention.ops``, in the reference's
(B, H, S, D) layout. The reference has no backward kernel (it trains through
``models.layers.chunked_gqa_attention`` under ``jax.checkpoint``), so the
backward here recomputes that twin under autograd, one ``chunk`` of keys at a
time with each chunk checkpointed, and differentiates it: memory stays
O(S·chunk) per call, as the reference's rematerialized scan.
"""
from __future__ import annotations

import torch
from torch.overrides import handle_torch_function, has_torch_function

from repro_torch.kernels.flash_attention import kernel
from repro_torch.models.layers import chunked_gqa_attention

__all__ = ["flash_attention"]


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale, block_q, block_k, chunk):
        out = kernel.flash_attention_tiles(q, k, v, causal=causal, scale=scale,
                                           block_q=block_q, block_k=block_k)
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.scale, ctx.chunk = causal, scale, chunk
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            live = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = chunked_gqa_attention(*live, causal=ctx.causal, chunk=ctx.chunk,
                                        scale=ctx.scale)
            dq, dk, dv = torch.autograd.grad(out, live, g)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(
    q: torch.Tensor,  # (B, Hq, S, D)
    k: torch.Tensor,  # (B, Hkv, S, D)
    v: torch.Tensor,  # (B, Hkv, S, D)
    *,
    causal: bool = True,
    scale: float | None = None,
    block_q: int = 128,
    block_k: int = 128,
    chunk: int = 1024,
) -> torch.Tensor:
    """Grouped-query attention -> (B, Hq, S, D) in q's type, differentiable in
    q, k and v; ``chunk`` is the backward's KV chunk (the LM's
    ``attn_chunk``). Inputs are made contiguous for the kernel. Takes the
    torch-function protocol (a dry run's ``launch.sharded.ShardedForms``)."""
    if has_torch_function((q, k, v)):
        return handle_torch_function(flash_attention, (q, k, v), q, k, v, causal=causal,
                                     scale=scale, block_q=block_q, block_k=block_k,
                                     chunk=chunk)
    return _FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), causal,
                                 scale, block_q, block_k, chunk)
