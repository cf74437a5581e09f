"""Loss functions (always reduced in float32). Counterpart of
``repro.train.losses``."""
from __future__ import annotations

import torch
from torch.overrides import handle_torch_function, has_torch_function

__all__ = ["softmax_xent", "masked_softmax_xent", "binary_xent", "mse"]


def _per_row(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    lg = logits.to(torch.float32)
    lse = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, labels.long()[..., None])[..., 0]
    return lse - gold


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the rows. Takes the torch-function protocol (a
    dry run's ``launch.sharded.ShardedForms``: the vocab-parallel form)."""
    if has_torch_function((logits, labels)):
        return handle_torch_function(softmax_xent, (logits, labels), logits, labels)
    return _per_row(logits, labels).mean()


def masked_softmax_xent(logits, labels, mask) -> torch.Tensor:
    """Cross-entropy averaged over the rows ``mask`` keeps; the torch-function
    protocol as ``softmax_xent``."""
    if has_torch_function((logits, labels, mask)):
        return handle_torch_function(masked_softmax_xent, (logits, labels, mask), logits,
                                     labels, mask)
    per = _per_row(logits, labels) * mask
    return per.sum() / torch.clamp(mask.sum(), min=1.0)


def binary_xent(logits, labels) -> torch.Tensor:
    lg = logits.to(torch.float32)
    return torch.mean(torch.clamp(lg, min=0) - lg * labels + torch.log1p(torch.exp(-lg.abs())))


def mse(pred, target) -> torch.Tensor:
    return torch.mean(torch.square(pred.to(torch.float32) - target.to(torch.float32)))
