"""Causal grouped-query flash attention (forward) on the card.

Counterpart of ``repro.kernels.flash_attention.kernel.flash_attention_pallas``:
q (B, Hq, S, D), k and v (B, Hkv, S, D), float32 or bfloat16 -> (B, Hq,
S, D) in q's type. Per query row, an online softmax over KV blocks of
``block_k`` keys in order, in float32 whatever the input type:

    s = (q . k) * scale  (-1e30 where kpos > qpos when causal)
    m' = max(m, max s); alpha = exp(m - m'); p = exp(s - m')
    l = l * alpha + sum p; acc = acc * alpha + p . v; m = m'

from m = -1e30, l = 0, acc = 0, and out = acc / max(l, 1e-30). Query head h
reads kv head ``h // (Hq // Hkv)``; K and V are never repeated. Query blocks
of ``block_q`` rows skip the KV blocks wholly above the diagonal (``ki * bk
> qi * bq + bq - 1``). Unlike the TPU kernel, any S >= 1 runs: the last
blocks may be partial.

``flash_attention_tiles`` launches the hand-written Hopper kernel in
``csrc/flash_attention.cu`` (built by ``nvcc`` at first use) on CUDA tensors
and raises if the build or the launch fails; on CPU tensors it runs
``flash_attention_tiles_plain``, the plain PyTorch version on the same block
schedule, which the kernel is also checked against on the card.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["flash_attention_tiles", "flash_attention_tiles_plain", "LAUNCHES",
           "reset_launch_counts", "MAX_D", "threads_per_row", "shared_bytes"]

SOURCE = "flash_attention.cu"
MAX_D = 128  # four threads of 32 head dims a row
MAX_THREADS = 512
MAX_SHARED = 232448  # bytes of shared memory a block can have on sm_90
_NEG = -1e30
_DTYPES = {torch.float32: (0, "f32"), torch.bfloat16: (1, "bf16")}

# kernel launches per input type ('f32', 'bf16'); incremented only where the
# CUDA kernel is launched
LAUNCHES: dict = {}


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def threads_per_row(d: int) -> int:
    """Threads the kernel gives a query row: one per 32 head dims, rounded
    up to a power of two."""
    return 1 if d <= 32 else 2 if d <= 64 else 4


def shared_bytes(d: int, block_q: int, block_k: int) -> int:
    """The kernel's shared memory: K and V tiles of block_k rows (head dims
    padded to 32 a thread) and a block_q x (block_k + 1) score tile, float32."""
    dp = 32 * threads_per_row(d)
    return (2 * block_k * dp + block_q * (block_k + 1)) * 4


def flash_attention_tiles_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                                causal: bool, scale: float, block_q: int,
                                block_k: int) -> torch.Tensor:
    """Plain PyTorch version on the kernel's schedule: KV blocks in order,
    each applied to the query blocks that run it (from ``(k0 // block_q) *
    block_q`` on, when causal), all their rows at once. A row of such a
    block that sees none of its keys keeps m, l and acc bit for bit (p = 0,
    alpha = 1), as the kernel, which skips it, does."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    group = hq // hkv
    qg = q.float().reshape(b, hkv, group, s, d)
    kf, vf = k.float(), v.float()
    m = torch.full((b, hkv, group, s), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, group, s, d), dtype=torch.float32, device=q.device)
    pos = torch.arange(s, device=q.device)
    for k0 in range(0, s, block_k):
        k1 = min(s, k0 + block_k)
        r0 = (k0 // block_q) * block_q if causal else 0
        sc = torch.einsum("bkgqd,bkcd->bkgqc", qg[:, :, :, r0:], kf[:, :, k0:k1]) * scale
        if causal:
            sc = torch.where(pos[r0:, None] >= pos[None, k0:k1], sc, _NEG)
        m_old = m[..., r0:]
        m_new = torch.maximum(m_old, sc.amax(dim=-1))
        alpha = torch.exp(m_old - m_new)
        p = torch.exp(sc - m_new[..., None])
        l[..., r0:] = l[..., r0:] * alpha + p.sum(dim=-1)
        acc[..., r0:, :] = acc[..., r0:, :] * alpha[..., None] + torch.einsum(
            "bkgqc,bkcd->bkgqd", p, vf[:, :, k0:k1])
        m[..., r0:] = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, hq, s, d).to(q.dtype)


def _launch(q, k, v, causal, scale, block_q, block_k):
    from repro_torch.kernels.build import load_library

    lib, _ = load_library(SOURCE)
    b, hq, s, d = q.shape
    code, name = _DTYPES[q.dtype]
    out = torch.empty_like(q)
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):  # the launch goes to the current device
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), code, b, hq,
                 k.shape[1], s, d, block_q, block_k, int(causal), scale,
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    LAUNCHES[name] = LAUNCHES.get(name, 0) + 1
    return out


def flash_attention_tiles(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, scale: float | None = None,
                          block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """(B, Hq, S, D) queries over (B, Hkv, S, D) keys and values -> (B, Hq,
    S, D) in q's type. CUDA tensors launch the kernel (or raise); CPU
    tensors run the plain version."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B, Hq, S, D) and k, v (B, Hkv, S, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if k.shape[0] != b or k.shape[2] != s or k.shape[3] != d or hkv < 1 or hq % hkv:
        raise ValueError(f"k, v {tuple(k.shape)} do not fit q {tuple(q.shape)} "
                         "(same B, S and D; Hq a multiple of Hkv)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must all be float32 or all bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if s < 1 or not 1 <= d <= MAX_D:
        raise ValueError(f"S={s} must be at least 1 and D={d} within 1..{MAX_D}")
    if block_q < 1 or block_k < 1:
        raise ValueError(f"block_q={block_q}, block_k={block_k} must be positive")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    scale = (d ** -0.5) if scale is None else float(scale)
    if q.device.type == "cuda":
        if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
            raise ValueError("kernel operands must be contiguous")
        if block_q * threads_per_row(d) > MAX_THREADS:
            raise ValueError(f"block_q={block_q} at D={d} needs more than {MAX_THREADS} "
                             "threads a block")
        if shared_bytes(d, block_q, block_k) > MAX_SHARED:
            raise ValueError(f"block_q={block_q}, block_k={block_k} at D={d} need "
                             f"{shared_bytes(d, block_q, block_k)} B of shared memory")
        if b * hq > 65535:
            raise ValueError(f"B * Hq = {b * hq} exceeds the grid's 65535 blocks")
        return _launch(q, k, v, causal, scale, block_q, block_k)
    if q.device.type == "cpu":
        return flash_attention_tiles_plain(q, k, v, causal=causal, scale=scale,
                                           block_q=block_q, block_k=block_k)
    raise ValueError(f"unsupported device {q.device}")
