"""Plain PyTorch embedding bag: a take plus a masked sum or mean.

Counterpart of ``repro.kernels.embedding_bag.ref``. It is what the tests
compare with the reference and what ``ops.embedding_bag`` runs on a CPU
tensor; on the card ``chip_smoke.py`` holds the CUDA kernel against it.
Padding ids are negative and add nothing. A bag's rows are added in id
order, the order of both the TPU kernel and the CUDA kernel, so the kernel
gives the same bits; a batched product (the reference's einsum) sums in
another order and differs by rounding where the rows cancel.

``embedding_bag_backward_reference`` is the plain version of the backward
(the segment-sum kernel, ``csrc/segment_sum.cu``, over the ids' runs): the
table's gradient, each row the sum of its terms in (b, i) order from +0.
On the CPU ``index_add_`` adds its source rows one index after another, in
that order (the tests hold it to ``np.add.at``); on the card it adds with
atomics, in an order that
changes from run to run.
"""
from __future__ import annotations

import torch

__all__ = ["embedding_bag_reference", "embedding_bag_backward_reference"]


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


def embedding_bag_backward_reference(
    grad_out: torch.Tensor,  # (B, D) float32, the bags' gradient
    ids: torch.Tensor,  # (B, L) integer, < 0 = padding
    num_rows: int,  # N, the table's rows
    mode: str = "sum",  # 'sum' | 'mean'
) -> torch.Tensor:
    """The table's (N, D) gradient: row n sums, over every (b, i) with
    ids[b, i] == n in (b, i) row-major order from +0, grad_out[b] (sum) or
    grad_out[b] / max(count_b, 1) (mean, divided first as the forward
    divides). Padding adds nothing; untouched rows are 0."""
    valid = ids >= 0
    g = grad_out
    if mode == "mean":
        g = g / valid.sum(dim=1, keepdim=True).clamp(min=1).to(g.dtype)
    keep = valid.reshape(-1)
    rows = ids.reshape(-1)[keep].long()
    bags = torch.arange(ids.numel(), device=ids.device)[keep] // max(ids.shape[1], 1)
    out = torch.zeros((num_rows, grad_out.shape[1]), dtype=grad_out.dtype,
                      device=grad_out.device)
    return out.index_add_(0, rows, g[bags])
