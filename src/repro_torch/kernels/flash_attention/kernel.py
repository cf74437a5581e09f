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

The source holds one kernel per input type. float32 runs on the FMA units,
1-4 threads a query row (``threads_per_row``), any ``block_q`` up to 512
threads a block. bfloat16 runs both products on the tensor cores
(``wgmma``, float32 accumulation) on tiles that TMA brings to shared
memory, a warpgroup of 128 threads per 64 query rows, with P split into
three bf16 parts that sum to the float32 p within one ulp, so that the
output stays within one bf16 ulp of this plain version; its ``block_q``
and ``block_k`` must be multiples of 16 up to 128 (``block_q`` is rounded
up to 64 rows of work).
``check_launchable`` says whether the kernel takes a (type, D, tile, B * Hq)
before a launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.fake import is_fake, nbytes, note, recording

__all__ = ["flash_attention_tiles", "flash_attention_tiles_plain", "LAUNCHES",
           "reset_launch_counts", "MAX_D", "threads_per_row", "shared_bytes",
           "check_launchable"]

SOURCE = "flash_attention.cu"
MAX_D = 128
MAX_THREADS = 512  # the float32 kernel's threads a block
MAX_SHARED = 232448  # bytes of shared memory a block can have on sm_90
MAX_GRID_Y = 65535  # B * Hq
BF16_TILE = 16  # the bf16 kernel's tile unit (a wgmma k-step) ...
BF16_MAX_TILE = 128  # ... and its largest block_q, block_k
BF16_ROWS = 64  # query rows a warpgroup (128 threads) computes
BF16_STAGES = 2  # K/V tiles in flight
_NEG = -1e30
_DTYPES = {torch.float32: (0, "f32"), torch.bfloat16: (1, "bf16")}

# kernel launches per input type ('f32', 'bf16'); incremented only where the
# CUDA kernel is launched
LAUNCHES: dict = {}


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def threads_per_row(d: int, dtype: torch.dtype = torch.float32) -> int:
    """Threads the kernel gives a query row: float32, one per 32 head dims,
    rounded up to a power of two; bf16, a warpgroup per 64 rows."""
    if dtype == torch.bfloat16:
        return 128 // BF16_ROWS
    return 1 if d <= 32 else 2 if d <= 64 else 4


def _bf16_warpgroups(block_q: int) -> int:
    return -(-block_q // BF16_ROWS)


def shared_bytes(d: int, block_q: int, block_k: int, dtype: torch.dtype = torch.float32) -> int:
    """The kernel's shared memory. float32: K and V tiles of block_k rows
    (head dims padded to 32 a thread) and a block_q x (block_k + 1) score
    tile; bf16: a 64-row Q tile a warpgroup and a ring of BF16_STAGES K and
    V tiles of block_k rows, head dims padded to 64 or 128, 1 KB to align
    them to 1024 bytes, and a TMA barrier a stage."""
    if dtype == torch.bfloat16:
        dp = 64 if d <= 64 else 128
        rows = _bf16_warpgroups(block_q) * BF16_ROWS + 2 * BF16_STAGES * block_k
        return 1024 + rows * dp * 2 + 8 * BF16_STAGES
    dp = 32 * threads_per_row(d)
    return (2 * block_k * dp + block_q * (block_k + 1)) * 4


def check_launchable(dtype: torch.dtype, d: int, block_q: int, block_k: int, bh: int) -> None:
    """Raise ValueError unless the kernel for ``dtype`` launches at head dim
    ``d``, tile ``block_q`` x ``block_k`` and ``bh`` = B * Hq (the launcher's
    own checks, made before the call)."""
    if dtype == torch.bfloat16 and not all(
            x % BF16_TILE == 0 and BF16_TILE <= x <= BF16_MAX_TILE for x in (block_q, block_k)):
        raise ValueError(f"bf16 tiles must be multiples of {BF16_TILE} up to {BF16_MAX_TILE}, "
                         f"got block_q={block_q}, block_k={block_k}")
    threads = (128 * _bf16_warpgroups(block_q) if dtype == torch.bfloat16
               else block_q * threads_per_row(d))
    if threads > MAX_THREADS:
        raise ValueError(f"block_q={block_q} at D={d} needs {threads} threads a block, more "
                         f"than {MAX_THREADS}")
    smem = shared_bytes(d, block_q, block_k, dtype)
    if smem > MAX_SHARED:
        raise ValueError(f"block_q={block_q}, block_k={block_k} at D={d} need {smem} B of "
                         "shared memory")
    if bh > MAX_GRID_Y:
        raise ValueError(f"B * Hq = {bh} exceeds the grid's {MAX_GRID_Y} blocks")


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
    from repro_torch.kernels.build import KernelLaunchError, load_library

    b, hq, s, d = q.shape
    code, name = _DTYPES[q.dtype]
    out = torch.empty_like(q)
    # QK^T and PV over the (query, key) pairs the causal mask keeps
    pairs = s * (s + 1) // 2 if causal else s * s
    if recording():
        note("flash_attention", 4 * b * hq * d * pairs, nbytes(q, k, v, out))
    if is_fake(q):  # the output rule: a dry run's trace
        return out
    lib, _ = load_library(SOURCE)
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):  # the launch goes to the current device
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), code, b, hq,
                 k.shape[1], s, d, block_q, block_k, int(causal), scale,
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise KernelLaunchError(f"flash_attention launch failed: CUDA error {err}")
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
    if q.device.type == "cuda" or is_fake(q):  # a fake: the output rule
        if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
            raise ValueError("kernel operands must be contiguous")
        check_launchable(q.dtype, d, block_q, block_k, b * hq)
        return _launch(q, k, v, causal, scale, block_q, block_k)
    if q.device.type == "cpu":
        return flash_attention_tiles_plain(q, k, v, causal=causal, scale=scale,
                                           block_q=block_q, block_k=block_k)
    raise ValueError(f"unsupported device {q.device}")
