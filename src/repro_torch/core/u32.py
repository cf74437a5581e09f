"""The port's single uint32 label convention.

The reference keeps BFS/WCC labels as uint32 (``INF_U32 = 0xFFFFFFFF``).
PyTorch on the CPU implements almost no uint32 arithmetic (``minimum``,
``+``, ``>>``, ``amin``, ``index_select`` and ``scatter_reduce`` all raise),
so the port never computes on uint32 tensors. Instead:

  * a uint32 label is STORED as its bit pattern in an int32 tensor
    (``0xFFFFFFFF`` is stored as -1);
  * ordered operations (min, saturating add, comparisons by magnitude)
    WIDEN to int64 with ``& 0xFFFFFFFF``, compute there, and NARROW back;
  * the CUDA kernel reinterprets the same int32 storage as ``uint32_t``.

Equality, indexing, gathers and copies work on the int32 storage directly,
because they only move bit patterns. Every module of the port goes through
these helpers, so the convention lives in this one place.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "U32_MAX",
    "to_bits",
    "from_bits",
    "widen",
    "narrow",
    "minimum",
    "identity_bits",
]

U32_MAX = 0xFFFFFFFF


def to_bits(a: np.ndarray) -> torch.Tensor:
    """numpy uint32 array -> int32 tensor holding the same bits (CPU copy)."""
    return torch.from_numpy(np.array(a, dtype=np.uint32).view(np.int32))


def from_bits(t: torch.Tensor) -> np.ndarray:
    """int32 bit-pattern tensor -> numpy uint32 array."""
    return t.detach().cpu().numpy().view(np.uint32)


def widen(bits: torch.Tensor) -> torch.Tensor:
    """int32 storage -> int64 holding the unsigned value in [0, 2^32)."""
    return bits.to(torch.int64) & U32_MAX


def narrow(vals: torch.Tensor) -> torch.Tensor:
    """int64 unsigned values in [0, 2^32) -> int32 storage (two's complement)."""
    return torch.where(vals > 0x7FFFFFFF, vals - (1 << 32), vals).to(torch.int32)


def minimum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned elementwise min of two int32-storage tensors."""
    return narrow(torch.minimum(widen(a), widen(b)))


def identity_bits(identity: float) -> int:
    """A problem's float identity (e.g. ``float(0xFFFFFFFF)``) as int32 storage."""
    v = int(identity) & U32_MAX
    return v - (1 << 32) if v > 0x7FFFFFFF else v
