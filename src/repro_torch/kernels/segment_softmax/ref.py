"""Plain segment form of the segment softmax (GAT's edge softmax over
in-edges): the counterpart of ``repro.kernels.segment_softmax.ref``. Its
segment sum is the fixed-order sum's plain version
(``kernels.segment_sum.segment_sum_plain``), the same bits on any device."""
from __future__ import annotations

import torch

from repro_torch.kernels.segment_sum import segment_sum_plain

__all__ = ["segment_softmax_reference"]

_NEG = -1e30


def segment_softmax_reference(
    scores: torch.Tensor,  # (E,)
    dst: torch.Tensor,  # (E,) segment ids
    valid: torch.Tensor,  # (E,) bool
    num_rows: int,
) -> torch.Tensor:
    """Numerically-stable per-segment softmax; invalid edges get weight 0."""
    idx = dst.long()
    s = torch.where(valid, scores, _NEG)
    seg_max = torch.full((num_rows,), _NEG, dtype=s.dtype, device=s.device)
    seg_max = seg_max.scatter_reduce(0, idx, s, "amax", include_self=True)
    seg_max = torch.where(seg_max <= _NEG / 2, 0.0, seg_max)  # empty rows
    e = torch.where(valid, torch.exp(s - seg_max[idx]), 0.0)
    seg_sum = segment_sum_plain(e, idx, num_rows)
    return torch.where(valid, e / torch.clamp(seg_sum[idx], min=1e-30), 0.0)
