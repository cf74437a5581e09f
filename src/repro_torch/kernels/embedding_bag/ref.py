"""Plain PyTorch embedding bag: a take plus a masked sum or mean.

Counterpart of ``repro.kernels.embedding_bag.ref``. It is what the tests
compare with the reference and what ``ops.embedding_bag`` runs on a CPU
tensor; on the card ``chip_smoke.py`` holds the CUDA kernel against it.
Padding ids are negative and add nothing. A bag's rows are added in id
order, the order of both the TPU kernel and the CUDA kernel, so the kernel
gives the same bits; a batched product (the reference's einsum) sums in
another order and differs by rounding where the rows cancel.
"""
from __future__ import annotations

import torch

__all__ = ["embedding_bag_reference"]


def embedding_bag_reference(
    table: torch.Tensor,  # (N, D)
    ids: torch.Tensor,  # (B, L) integer, < 0 = padding
    mode: str = "sum",  # 'sum' | 'mean'
    weights: torch.Tensor | None = None,  # (B, L) per-id weights
) -> torch.Tensor:
    valid = ids >= 0
    idx = ids.clamp(min=0).long()
    zero = torch.zeros((), dtype=table.dtype, device=table.device)
    out = torch.zeros((ids.shape[0], table.shape[1]), dtype=table.dtype, device=table.device)
    for i in range(ids.shape[1]):  # in id order
        row = table[idx[:, i]]  # (B, D)
        if weights is not None:
            row = row * weights[:, i, None].to(table.dtype)
        out += torch.where(valid[:, i, None], row, zero)
    if mode == "mean":
        out = out / valid.sum(dim=1, keepdim=True).clamp(min=1).to(table.dtype)
    return out
