"""The segment softmax over a row-block tile layout, on the card.

Counterpart of ``repro.kernels.segment_softmax.kernel.segment_softmax_pallas``
under ``jax.vmap`` over heads: scores (H, R, T, Eb) float32 in tile order,
with ``dstb`` (R, T, Eb) int32 (the row within block r) and ``valid`` (R,
T, Eb) bool shared by all heads, give per slot

    w = exp(s - m[row]) / max(l[row], 1e-30),   0 on invalid slots,

where ``m`` and ``l`` are a row's running max and sum of exponentials over
its valid slots, from the identity m = -1e30, l = 0 (a row no valid slot
reaches keeps them and is never read).

``segment_softmax_tiles`` launches the hand-written Hopper kernel in
``csrc/segment_softmax.cu`` (built by ``nvcc`` at first use) on CUDA
tensors and raises if the build or the launch fails; on CPU tensors it runs
``segment_softmax_tiles_plain``, the plain PyTorch version, which the
kernel is also checked against on the card.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["segment_softmax_tiles", "segment_softmax_tiles_plain", "LAUNCHES",
           "reset_launch_counts", "MAX_VB"]

SOURCE = "segment_softmax.cu"
MAX_VB = 8192  # rows of one block: m and l for them stay in 64 KiB of shared memory
_NEG = -1e30

# kernel launches per variant ('f32'); incremented only where the CUDA kernel
# is launched
LAUNCHES: dict = {}


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def segment_softmax_tiles_plain(scores: torch.Tensor, dstb: torch.Tensor,
                                valid: torch.Tensor, *, vb: int) -> torch.Tensor:
    """Plain PyTorch version on the same tile schedule: each row's max over
    its valid slots, then its sum of exponentials taken per tile and the
    tile partials added in tile order (on the CPU ``index_add_`` adds in
    index order), then the normalized weights."""
    h, r_blocks, t_tiles, eb = scores.shape
    rows = (dstb.long() + vb * torch.arange(r_blocks, device=dstb.device).view(-1, 1, 1))
    rows = rows.expand(h, -1, -1, -1)
    heads = torch.arange(h, device=dstb.device).view(-1, 1, 1, 1) * (r_blocks * vb)
    live = valid.expand(h, -1, -1, -1)
    at = (rows + heads)[live]  # flat (head, row) of each valid slot
    s = scores[live]
    m = torch.full((h * r_blocks * vb,), _NEG, dtype=scores.dtype, device=scores.device)
    m = m.scatter_reduce(0, at, s, "amax", include_self=True)
    e = torch.exp(s - m[at])
    tile = torch.arange(t_tiles, device=dstb.device).view(1, 1, -1, 1).expand_as(scores)[live]
    key = at * t_tiles + tile  # (head, row, tile): tile partials, then their fold
    uniq, inv = torch.unique(key, return_inverse=True)
    part = torch.zeros(uniq.shape[0], dtype=scores.dtype, device=scores.device)
    part.index_add_(0, inv, e)
    l = torch.zeros_like(m).index_add_(0, uniq // t_tiles, part)
    out = torch.zeros_like(scores)
    out[live] = e / torch.clamp(l[at], min=1e-30)
    return out


def _launch(scores, dstb, valid, vb):
    from repro_torch.kernels.build import load_library

    lib, _ = load_library(SOURCE)
    h, r_blocks, t_tiles, eb = scores.shape
    out = torch.empty_like(scores)
    fn = lib.segment_softmax_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(scores.device):  # the launch goes to the current device
        err = fn(scores.data_ptr(), dstb.data_ptr(), valid.data_ptr(), out.data_ptr(),
                 h, r_blocks, t_tiles * eb, vb,
                 torch.cuda.current_stream(scores.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"segment_softmax launch failed: CUDA error {err}")
    LAUNCHES["f32"] = LAUNCHES.get("f32", 0) + 1
    return out


def segment_softmax_tiles(scores: torch.Tensor, dstb: torch.Tensor, valid: torch.Tensor,
                          *, vb: int) -> torch.Tensor:
    """(H, R, T, Eb) or (R, T, Eb) float32 scores in tile order -> weights of
    the same shape. CUDA tensors launch the kernel (or raise); CPU tensors
    run the plain version."""
    squeeze = scores.dim() == 3
    if squeeze:
        scores = scores.unsqueeze(0)
    if scores.dim() != 4 or scores.dtype != torch.float32:
        raise ValueError(f"scores must be (H, R, T, Eb) float32, got "
                         f"{tuple(scores.shape)} {scores.dtype}")
    if tuple(dstb.shape) != tuple(scores.shape[1:]) or dstb.dtype != torch.int32:
        raise ValueError(f"dstb must be {tuple(scores.shape[1:])} int32, got "
                         f"{tuple(dstb.shape)} {dstb.dtype}")
    if tuple(valid.shape) != tuple(scores.shape[1:]) or valid.dtype != torch.bool:
        raise ValueError(f"valid must be {tuple(scores.shape[1:])} bool, got "
                         f"{tuple(valid.shape)} {valid.dtype}")
    if not 1 <= vb <= MAX_VB:
        raise ValueError(f"vb={vb} rows do not fit one block (at most {MAX_VB})")
    for name, t in (("dstb", dstb), ("valid", valid)):
        if t.device != scores.device:
            raise ValueError(f"{name} is on {t.device}, scores on {scores.device}")
    if scores.device.type == "cuda":
        if not (scores.is_contiguous() and dstb.is_contiguous() and valid.is_contiguous()):
            raise ValueError("kernel operands must be contiguous")
        out = _launch(scores, dstb, valid, vb)
    elif scores.device.type == "cpu":
        out = segment_softmax_tiles_plain(scores, dstb, valid, vb=vb)
    else:
        raise ValueError(f"unsupported device {scores.device}")
    return out[0] if squeeze else out
