"""Loss functions (always reduced in float32). Counterpart of
``repro.train.losses``."""
from __future__ import annotations

import torch

__all__ = ["softmax_xent", "masked_softmax_xent", "binary_xent", "mse"]


def _per_row(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    lg = logits.to(torch.float32)
    lse = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, labels.long()[..., None])[..., 0]
    return lse - gold


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return _per_row(logits, labels).mean()


def masked_softmax_xent(logits, labels, mask) -> torch.Tensor:
    per = _per_row(logits, labels) * mask
    return per.sum() / torch.clamp(mask.sum(), min=1.0)


def binary_xent(logits, labels) -> torch.Tensor:
    lg = logits.to(torch.float32)
    return torch.mean(torch.clamp(lg, min=0) - lg * labels + torch.log1p(torch.exp(-lg.abs())))


def mse(pred, target) -> torch.Tensor:
    return torch.mean(torch.square(pred.to(torch.float32) - target.to(torch.float32)))
