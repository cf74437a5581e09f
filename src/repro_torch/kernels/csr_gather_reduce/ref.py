"""Plain segment form of the graph-core accumulator (gather + segment
reduce): the counterpart of ``repro.kernels.csr_gather_reduce.ref``."""
from __future__ import annotations

import torch

from repro_torch.core import u32

__all__ = ["gather_reduce_reference"]


def gather_reduce_reference(
    payload: torch.Tensor,  # (G,) gathered label block; int32 = uint32 bits
    src_gidx: torch.Tensor,  # (E,) into payload
    dst_lidx: torch.Tensor,  # (E,) into output rows
    valid: torch.Tensor,  # (E,) bool
    num_rows: int,
    kind: str = "min",  # reduce UDF
    identity: float = 0.0,
    weights: torch.Tensor | None = None,  # (E,) optional saturating add (SSSP)
) -> torch.Tensor:
    """Per destination row, the min or sum of the mapped payloads of its
    valid edges; rows no edge reaches hold the identity (float min: what
    ``segment_min`` fills, +inf, is the caller's to map)."""
    vals = payload[src_gidx.long()]
    idx = dst_lidx.long()
    if vals.dtype == torch.int32:  # uint32 bits: the unsigned min in int64
        if kind != "min":
            raise ValueError("uint32 payloads reduce with 'min'")
        ident = int(identity) & u32.U32_MAX
        wide = torch.where(valid, u32.widen(vals), ident)
        out = torch.full((num_rows,), u32.U32_MAX, dtype=torch.int64, device=vals.device)
        return u32.narrow(out.scatter_reduce(0, idx, wide, "amin", include_self=True))
    if weights is not None:
        vals = torch.where(vals >= identity, torch.full_like(vals, identity), vals + weights)
    vals = torch.where(valid, vals, torch.full_like(vals, identity))
    if kind == "min":
        out = torch.full((num_rows,), float("inf"), dtype=vals.dtype, device=vals.device)
        return out.scatter_reduce(0, idx, vals, "amin", include_self=True)
    return torch.zeros(num_rows, dtype=vals.dtype, device=vals.device).index_add(0, idx, vals)
