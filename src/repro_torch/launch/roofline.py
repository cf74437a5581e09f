"""Roofline terms of a dry-run cell, per device, on the port's ``HW``.

Counterpart of ``repro.launch.roofline``:

  compute    = FLOPs_per_device / the peak of the dtype the matmuls run in
  memory     = bytes_per_device / HW.HBM_BW
  collective = collective_wire_bytes_per_device / HW.IB_BW

The compute peak is the dtype's: bf16 on the tensor cores (989 TFLOP/s), or
float32 outside them (67 TFLOP/s: the port's float32 GEMMs, TF32 off). The
reference divides every cell by its bf16 peak, which would flatter a float32
cell 14.8x; the record names the peak it used. Collective bytes come from
the collectives the dry run recorded (kind, output bytes, group size), not
from HLO text, with the reference's wire factors per kind for a ring:

  all-gather          out * (n-1)/n     (each device receives n-1 shards)
  reduce-scatter      out * (n-1)       (out is 1/n of the input)
  all-reduce          2 * out * (n-1)/n (reduce-scatter + all-gather)
  all-to-all          out * (n-1)/n
  collective-permute  out
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, Optional, Tuple

import torch

from repro_torch.launch.mesh import HW

__all__ = ["COLLECTIVES", "collective_bytes", "peak_flops", "roofline_report", "RooflineTerms"]

COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)


def _wire(kind: str, out_bytes: float, n: int) -> float:
    frac = (n - 1) / n
    if kind == "all-gather":
        return out_bytes * frac
    if kind == "reduce-scatter":
        return out_bytes * (n - 1)
    if kind == "all-reduce":
        return 2 * out_bytes * frac
    if kind == "all-to-all":
        return out_bytes * frac
    if kind == "collective-permute":
        return out_bytes
    raise ValueError(f"unknown collective kind {kind!r}; have {COLLECTIVES}")


def collective_bytes(records: Iterable[Tuple[str, float, int]]) -> Dict[str, Any]:
    """Wire bytes per device, per kind, and op counts, of recorded
    collectives: each ``(kind, output bytes on this device, group size)``.
    A collective over a group of one moves nothing and is not counted."""
    per_kind_bytes: Dict[str, float] = {k: 0.0 for k in COLLECTIVES}
    per_kind_count: Dict[str, int] = {k: 0 for k in COLLECTIVES}
    for kind, out_bytes, n in records:
        if n <= 1:
            continue
        per_kind_bytes[kind] += _wire(kind, float(out_bytes), int(n))
        per_kind_count[kind] += 1
    return {
        "total_wire_bytes_per_device": sum(per_kind_bytes.values()),
        "bytes_by_kind": per_kind_bytes,
        "count_by_kind": per_kind_count,
    }


def peak_flops(dtype: torch.dtype) -> Tuple[str, float]:
    """(name, FLOP/s) of the card's peak for matmuls in ``dtype``."""
    if dtype in (torch.bfloat16, torch.float16):
        return "bf16 tensor cores", HW.PEAK_FLOPS_BF16
    if dtype == torch.float32:
        return "float32 outside the tensor cores", HW.PEAK_FLOPS_F32
    raise ValueError(f"no peak for {dtype}")


@dataclasses.dataclass
class RooflineTerms:
    key: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    hlo_flops_total: float  # the traced FLOPs of all devices (the reference's name kept)
    useful_ratio: float
    peak: str = ""
    peak_flops: float = 0.0
    memory_per_device_bytes: Optional[float] = None
    extras: Optional[Dict] = None

    def to_dict(self):
        return dataclasses.asdict(self)


def roofline_report(
    key: str,
    mesh_name: str,
    chips: int,
    cost: Dict[str, float],
    coll: Dict[str, Any],
    model_flops: float,
    dtype: torch.dtype = torch.bfloat16,
    memory_bytes: Optional[float] = None,
    extras: Optional[Dict] = None,
) -> RooflineTerms:
    """The reference's arithmetic on ``cost`` ({"flops", "bytes accessed"}
    per device) and ``coll`` (``collective_bytes``), the compute term at
    ``dtype``'s peak; ``memory_bytes`` is the predicted peak per device."""
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    cw = float(coll["total_wire_bytes_per_device"])
    peak_name, peak = peak_flops(dtype)
    compute_s = flops / peak
    memory_s = byts / HW.HBM_BW
    coll_s = cw / HW.IB_BW
    dominant = max(
        [("compute", compute_s), ("memory", memory_s), ("collective", coll_s)],
        key=lambda kv: kv[1],
    )[0]
    total = flops * chips
    return RooflineTerms(
        key=key,
        mesh=mesh_name,
        chips=chips,
        flops_per_device=flops,
        bytes_per_device=byts,
        collective_bytes_per_device=cw,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=coll_s,
        dominant=dominant,
        model_flops=model_flops,
        hlo_flops_total=total,
        useful_ratio=(model_flops / total) if total else 0.0,
        peak=peak_name,
        peak_flops=peak,
        memory_per_device_bytes=None if memory_bytes is None else float(memory_bytes),
        extras=extras,
    )
