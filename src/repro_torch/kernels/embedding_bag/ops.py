"""EmbeddingBag entry point: the Hopper kernel on the card, the plain
version on the CPU.

Counterpart of ``repro.kernels.embedding_bag.ops``. A CUDA tensor goes to
the kernel (``kernel.embedding_bag_cuda``), which raises if it cannot be
built or launched and never falls back; a CPU tensor goes to
``ref.embedding_bag_reference``. Unlike the Pallas kernel, any number of
bags is accepted (DIN's retrieval and recommend paths run B = 1).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.embedding_bag.kernel import embedding_bag_cuda
from repro_torch.kernels.embedding_bag.ref import embedding_bag_reference

__all__ = ["embedding_bag"]


def embedding_bag(table: torch.Tensor, ids: torch.Tensor, mode: str = "sum") -> torch.Tensor:
    """(N, D) float32 table x (B, L) int32 ids (< 0 = padding) -> (B, D)."""
    if mode not in ("sum", "mean"):
        raise ValueError(f"mode must be 'sum' or 'mean', got {mode!r}")
    if table.dim() != 2 or table.dtype != torch.float32:
        raise ValueError(f"table must be (N, D) float32, got {tuple(table.shape)} {table.dtype}")
    if ids.dim() != 2 or ids.dtype != torch.int32:
        raise ValueError(f"ids must be (B, L) int32, got {tuple(ids.shape)} {ids.dtype}")
    if ids.device != table.device:
        raise ValueError(f"ids are on {ids.device}, the table on {table.device}")
    if table.device.type == "cuda":
        if not (table.is_contiguous() and ids.is_contiguous()):
            raise ValueError("kernel operands must be contiguous")
        return embedding_bag_cuda(table, ids, mode)
    if table.device.type != "cpu":
        raise ValueError(f"unsupported device {table.device}")
    return embedding_bag_reference(table, ids, mode)
