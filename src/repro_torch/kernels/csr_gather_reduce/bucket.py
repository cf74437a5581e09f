"""The one-bucket accumulator over the uncompressed edge arrays.

Counterpart of ``repro.kernels.csr_gather_reduce.kernel.gather_reduce_pallas``:
for one (core, phase) bucket tiled into (R, T, Eb) slots of ``src`` (int32
into the payload), ``dstb`` (int32 row within the row block) and ``valid``
(bool), and for every row block r,

    for each valid slot e:  val = payload[src[e]]   (+ weight, saturating at
                                                     the identity, for 'add')
                            out[r * vb + dstb[e]] = reduce(out[...], val)

from the reduce identity: min over uint32 (held as int32 bits, ``core.u32``)
or float32, sum over float32. ``ops.gather_reduce`` is the entry point (it
adds the level-2 split-row fold or the row-packing undo).

``gather_reduce_bucket`` launches the hand-written Hopper kernel in
``csrc/gather_reduce.cu`` (built by ``nvcc`` at first use) on CUDA tensors
and raises if the build or the launch fails; on CPU tensors it runs
``gather_reduce_bucket_plain``, the plain PyTorch version, which the kernel
is also checked against on the card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.fake import is_fake, nbytes, note, recording
from repro_torch.kernels.csr_gather_reduce.kernel import (
    _mapped, _min_into, identity_word, pointers, tile_ordered_sum, variant_name,
)

__all__ = ["gather_reduce_bucket", "gather_reduce_bucket_plain", "LAUNCHES",
           "reset_launch_counts", "max_rows"]

SOURCE = "gather_reduce.cu"
_KIND_CODES = {"min": 0, "sum": 1}

# kernel launches per variant ('min_u32', 'min_f32', 'min_f32_add',
# 'sum_f32'); incremented only where the CUDA kernel is launched
LAUNCHES: dict = {}


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def max_rows() -> int:
    """The most rows (vb) one block of the CUDA kernel holds on the current
    device (its shared-memory accumulator); needs the card."""
    from repro_torch.kernels.build import load_library

    lib, _ = load_library(SOURCE)
    fn = lib.gather_reduce_max_vb
    fn.argtypes, fn.restype = [], ctypes.c_int
    return fn()


def gather_reduce_bucket_plain(payload, src, dstb, valid, weights=None, *, num_rows, vb,
                               kind="min", edge_op="none", identity=0.0):
    """Plain PyTorch version on the reference kernel's association: min over
    the valid slots per row; sum per tile first, then the tile partials in
    tile order (on the CPU ``index_add_`` adds in index order)."""
    r_blocks, t_tiles, eb = src.shape
    rows = (dstb.long() + vb * torch.arange(r_blocks, device=src.device).view(-1, 1, 1))[valid]
    vals = _mapped(payload, src[valid], weights[valid] if weights is not None else None,
                   edge_op, identity)
    if kind == "min":
        return _min_into(vals, rows, num_rows, identity)
    tile = torch.arange(t_tiles, device=src.device).view(1, -1, 1).expand_as(src)
    return tile_ordered_sum(vals, rows, tile[valid], t_tiles, vb, num_rows, identity)


def _launch(payload, src, dstb, valid, weights, num_rows, vb, kind, edge_op, identity):
    from repro_torch.kernels.build import KernelLaunchError, load_library

    r_blocks, t_tiles, eb = src.shape
    out = torch.empty(num_rows, dtype=payload.dtype, device=payload.device)
    if recording():
        note("gather_reduce", src.numel() * (2 if edge_op == "add" else 1),
             nbytes(payload, src, dstb, valid, weights, out))
    if is_fake(payload):  # the output rule: a dry run's trace
        return out
    lib, _ = load_library(SOURCE)
    fn = lib.gather_reduce_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_uint32, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(payload.device):  # the launch goes to the current device
        err = fn(*pointers(payload, src, dstb, valid, weights, out), r_blocks, t_tiles * eb,
                 vb, _KIND_CODES[kind], int(payload.dtype == torch.float32),
                 int(edge_op == "add"), identity_word(payload.dtype, identity),
                 torch.cuda.current_stream(payload.device).cuda_stream)
    if err != 0:
        raise KernelLaunchError(f"gather_reduce launch failed: CUDA error {err}")
    key = variant_name(payload.dtype, kind, edge_op)
    LAUNCHES[key] = LAUNCHES.get(key, 0) + 1
    return out


def gather_reduce_bucket(
    payload: torch.Tensor,  # (G,) int32 (uint32 bits) or float32
    src: torch.Tensor,  # (R, T, Eb) int32 into payload
    dstb: torch.Tensor,  # (R, T, Eb) int32 row within the block, [0, vb)
    valid: torch.Tensor,  # (R, T, Eb) bool
    weights: torch.Tensor | None = None,  # (R, T, Eb) float32 (edge_op 'add')
    *,
    num_rows: int,  # = R * vb
    vb: int,
    kind: str = "min",
    edge_op: str = "none",
    identity: float = 0.0,
) -> torch.Tensor:
    """One bucket's accumulator -> (num_rows,). CUDA tensors launch the
    Hopper kernel (or raise); CPU tensors run the plain version."""
    if src.dim() != 3:
        raise ValueError(f"src must be (R, T, Eb), got {tuple(src.shape)}")
    if src.shape[0] * vb != num_rows:
        raise ValueError(f"R * vb = {src.shape[0]} * {vb} != num_rows = {num_rows}")
    if kind not in _KIND_CODES:
        raise ValueError(f"kind must be 'min' or 'sum', got {kind!r}")
    if edge_op not in ("none", "add"):
        raise ValueError(f"edge_op must be 'none' or 'add', got {edge_op!r}")
    if payload.dim() != 1 or payload.dtype not in (torch.int32, torch.float32):
        raise ValueError(f"payload must be (G,) int32 or float32, got "
                         f"{tuple(payload.shape)} {payload.dtype}")
    if payload.dtype == torch.int32 and (kind != "min" or edge_op != "none"):
        raise ValueError("uint32 payloads support kind='min', edge_op='none' only")
    for name, t, dt in (("src", src, torch.int32), ("dstb", dstb, torch.int32),
                        ("valid", valid, torch.bool), ("weights", weights, torch.float32)):
        if t is None:
            continue
        if t.dtype != dt or t.shape != src.shape:
            raise ValueError(f"{name} must be {tuple(src.shape)} {dt}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != payload.device:
            raise ValueError(f"{name} is on {t.device}, payload on {payload.device}")
    if payload.device.type == "cuda" or is_fake(payload):  # a fake: the output rule
        return _launch(payload, src, dstb, valid, weights, num_rows, vb, kind, edge_op,
                       identity)
    if payload.device.type != "cpu":
        raise ValueError(f"unsupported device {payload.device}")
    return gather_reduce_bucket_plain(payload, src, dstb, valid, weights, num_rows=num_rows,
                                      vb=vb, kind=kind, edge_op=edge_op, identity=identity)
