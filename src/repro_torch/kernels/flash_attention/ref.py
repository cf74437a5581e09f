"""Plain oracle of causal grouped-query attention (the full logits): the
counterpart of ``repro.kernels.flash_attention.ref``."""
from __future__ import annotations

import torch

__all__ = ["gqa_attention_reference"]


def gqa_attention_reference(
    q: torch.Tensor,  # (B, Hq, S, D)
    k: torch.Tensor,  # (B, Hkv, S, D)
    v: torch.Tensor,  # (B, Hkv, S, D)
    causal: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    """The reference's function: logits ``q . k`` in q's type, then float32
    times ``scale``, -1e30 above the diagonal, a softmax over keys, weights
    cast to q's type before the product with v. The query heads are viewed
    as (Hkv, group) rather than K and V repeated; the values are the same."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    group = hq // hkv
    scale = (d ** -0.5) if scale is None else scale
    qg = q.reshape(b, hkv, group, s, d)
    logits = torch.einsum("bkgqd,bkcd->bkgqc", qg, k).float() * scale
    if causal:
        mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
        logits = torch.where(mask, logits, -1e30)
    w = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    w = w / w.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgqc,bkcd->bkgqd", w.to(q.dtype), v)
    return out.reshape(b, hq, s, d)
