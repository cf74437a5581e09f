"""The graph-core accumulator over the compressed edge stream.

Counterpart of ``repro.kernels.csr_gather_reduce.kernel.gather_reduce_cores_pallas``.
``gather_reduce_cores`` computes, for every core ``c`` and row block ``r``
of one phase, the reduce (min or sum) of the mapped payloads of the block's
edges into ``vb`` output rows that start at the reduce identity:

  for each tile t that runs and slot e of word[c, r, t]:
      16-bit regime: src = w & 0xFFFF, dstb = (w >> 16) & 0x7FFF, valid = w < 0
      32-bit regime: src = w, dstb = hi & 0x7FFFFFFF, valid = hi < 0
      val = payload[src]          (+ weight, saturating at the identity, for 'add')
      out[c, r * vb + dstb] = reduce(out[...], val)      for valid slots

A tile runs iff ``t < counts[c, r]`` (the static schedule) or, given the
dynamic fetch map of the frontier-aware tile skip, iff ``fetch[c, r, t] ==
t`` (``core.frontier_words.active_fetch_map``).

On a CUDA tensor it launches the hand-written Hopper kernel in
``csrc/gather_reduce_cores.cu`` (built by ``nvcc`` at first use) or raises;
on a CPU tensor it runs ``gather_reduce_cores_plain``, the plain PyTorch
version of the same function, which is also what the kernel is checked
against on the card. An int32 payload holds uint32 bit patterns
(``core.u32``) and reduces with the unsigned min.

A trailing lane axis and the 'or' reduce come with multi-query lanes.
"""
from __future__ import annotations

import ctypes
import struct

import torch

from repro_torch.core import u32

__all__ = [
    "gather_reduce_cores",
    "gather_reduce_cores_plain",
    "LAUNCHES",
    "reset_launch_counts",
    "variant_name",
    "smem_limit_rows",
]

SOURCE = "gather_reduce_cores.cu"
SMEM_LIMIT = 232448  # bytes of shared memory one Hopper block can use
_THREADS = 256  # must match kThreads in the .cu file

# kernel launches per variant (see ``variant_name``); incremented only where
# the CUDA kernel is launched
LAUNCHES: dict = {}


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def variant_name(payload_dtype: torch.dtype, kind: str, edge_op: str) -> str:
    """'min_u32' (BFS/WCC), 'min_f32_add' (SSSP), 'sum_f32' (PageRank), ..."""
    ty = "u32" if payload_dtype == torch.int32 else "f32"
    return f"{kind}_{ty}" + ("_add" if edge_op == "add" else "")


def smem_limit_rows() -> int:
    """Largest vb whose accumulator (plus the sum staging and the active-tile
    list) fits one block."""
    return SMEM_LIMIT // 4 - 4 * _THREADS - _THREADS // 32


def _decode(word, word_hi, src_bits):
    if src_bits == 16:
        return word & 0xFFFF, (word >> 16) & 0x7FFF, word < 0
    return word, word_hi & 0x7FFFFFFF, word_hi < 0


def tiles_that_run(counts, fetch, t_tiles: int) -> torch.Tensor:
    """(p, R, T) bool: the tiles a launch reads, from the static counts or,
    when given, the dynamic fetch map."""
    t_idx = torch.arange(t_tiles, device=counts.device, dtype=torch.int32)
    if fetch is not None:
        return fetch == t_idx
    return t_idx < counts.unsqueeze(-1)


def _mapped(payload, src, weights, edge_op, identity):
    """Gather the source payloads of the live slots and apply the map UDF."""
    vals = payload[src.long()]
    if edge_op == "add":  # saturating min-plus; no weights = unit weights
        step = weights if weights is not None else 1.0
        vals = torch.where(vals >= identity, torch.full_like(vals, identity), vals + step)
    return vals


def _min_into(vals, rows, size, identity):
    """Min-reduce ``vals`` at ``rows`` into ``size`` slots holding the
    identity; int32 values are uint32 bits (unsigned min in int64)."""
    if vals.dtype == torch.int32:
        out = torch.full((size,), int(identity) & u32.U32_MAX, dtype=torch.int64,
                         device=vals.device)
        out.scatter_reduce_(0, rows.long(), u32.widen(vals), "amin")
        return u32.narrow(out)
    out = torch.full((size,), identity, dtype=vals.dtype, device=vals.device)
    out.scatter_reduce_(0, rows.long(), vals, "amin")
    return out


def gather_reduce_cores_plain(
    payload, word, counts, word_hi=None, weights=None, fetch=None, *,
    num_rows, vb, src_bits=16, kind="min", edge_op="none", identity=0.0,
):
    """Plain PyTorch version: decode every slot, mask invalid slots and the
    tiles that do not run, gather, map, and scatter-reduce into (p, R*vb)."""
    p, r_blocks, t_tiles, eb = word.shape
    src, dstb, valid = _decode(word, word_hi, src_bits)
    live = valid & tiles_that_run(counts, fetch, t_tiles).unsqueeze(-1)
    rows = (
        dstb
        + vb * torch.arange(r_blocks, device=word.device).view(1, r_blocks, 1, 1)
        + num_rows * torch.arange(p, device=word.device).view(p, 1, 1, 1)
    )[live]
    vals = _mapped(payload, src[live], weights[live] if weights is not None else None,
                   edge_op, identity)
    if kind == "min":
        return _min_into(vals, rows, p * num_rows, identity).view(p, num_rows)
    # sum with the reference kernel's association: each tile's slots are
    # summed per row first, then the tile partials are added in tile order
    # (on the CPU index_add_ runs in index order)
    out = torch.full((p * num_rows,), identity, dtype=payload.dtype, device=word.device)
    t_idx = torch.arange(t_tiles, device=word.device).view(1, 1, t_tiles, 1)
    t_of = t_idx.expand_as(word)[live]
    key = ((rows // vb) * t_tiles + t_of) * vb + rows % vb
    uniq, inv = torch.unique(key, return_inverse=True)
    part = torch.zeros(uniq.shape[0], dtype=vals.dtype, device=word.device)
    part.index_add_(0, inv, vals)
    out.index_add_(0, (uniq // (t_tiles * vb)) * vb + uniq % vb, part)
    return out.view(p, num_rows)


def check_stream(payload, word, counts, word_hi, weights, fetch, src_bits, kind, edge_op):
    """Shape, type and device checks shared by the gather and scatter
    wrappers: what their kernels take, and nothing else."""
    if word.dim() != 4:
        raise ValueError(f"word must be (p, blocks, tiles, Eb), got {tuple(word.shape)}")
    p, n_blocks, t_tiles, _ = word.shape
    if tuple(counts.shape) != (p, n_blocks):
        raise ValueError(f"counts must be {(p, n_blocks)}, got {tuple(counts.shape)}")
    if fetch is not None and tuple(fetch.shape) != (p, n_blocks, t_tiles):
        raise ValueError(f"fetch must be {(p, n_blocks, t_tiles)}, got {tuple(fetch.shape)}")
    if src_bits not in (16, 32) or (word_hi is not None) != (src_bits == 32):
        raise ValueError(f"src_bits={src_bits} needs word_hi exactly in the 32-bit regime")
    if edge_op not in ("none", "add"):
        raise ValueError(f"edge_op must be 'none' or 'add', got {edge_op!r}")
    if payload.dim() != 1:
        raise ValueError("a lane axis on the payload is not ported yet")
    if payload.dtype not in (torch.int32, torch.float32):
        raise ValueError(f"payload must be int32 (uint32 bits) or float32, got {payload.dtype}")
    if payload.dtype == torch.int32 and (kind != "min" or edge_op != "none"):
        raise ValueError("uint32 payloads support kind='min', edge_op='none' only")
    for name, t, dt in (("word", word, torch.int32), ("counts", counts, torch.int32),
                        ("word_hi", word_hi, torch.int32), ("weights", weights, torch.float32),
                        ("fetch", fetch, torch.int32)):
        if t is None:
            continue
        if t.dtype != dt:
            raise ValueError(f"{name} must be {dt}, got {t.dtype}")
        if t.device != payload.device:
            raise ValueError(f"{name} is on {t.device}, payload on {payload.device}")
        if name in ("word_hi", "weights") and t.shape != word.shape:
            raise ValueError(f"{name} must match word's shape {tuple(word.shape)}")
    if payload.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {payload.device}")


def identity_word(payload_dtype: torch.dtype, identity: float) -> int:
    """The reduce identity as the 32-bit word the kernels compare."""
    if payload_dtype == torch.float32:
        return struct.unpack("<I", struct.pack("<f", identity))[0]
    return int(identity) & u32.U32_MAX


def pointers(*tensors):
    """Device pointers for a C launcher (None for an absent operand)."""
    for t in tensors:
        if t is not None and not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
    return [t.data_ptr() if t is not None else None for t in tensors]


def _launch(payload, word, counts, word_hi, weights, fetch, num_rows, vb, kind, edge_op,
            identity):
    from repro_torch.kernels.build import load_library

    lib, _ = load_library(SOURCE)
    fn = lib.gather_reduce_cores_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_uint32, ctypes.c_void_p]
    p, r_blocks, t_tiles, eb = word.shape
    out = torch.empty((p, num_rows), dtype=payload.dtype, device=payload.device)
    with torch.cuda.device(payload.device):  # the launch goes to the current device
        err = fn(
            *pointers(payload, word, word_hi, weights, counts, fetch, out),
            p, r_blocks, t_tiles, eb, vb,
            0 if kind == "min" else 1, int(payload.dtype == torch.float32),
            int(edge_op == "add"), identity_word(payload.dtype, identity),
            torch.cuda.current_stream(payload.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"gather_reduce_cores launch failed: CUDA error {err}")
    key = variant_name(payload.dtype, kind, edge_op)
    LAUNCHES[key] = LAUNCHES.get(key, 0) + 1
    return out


def gather_reduce_cores(
    payload: torch.Tensor,  # (G,) phase-gathered block; int32 = uint32 bits
    word: torch.Tensor,  # (p, R, T, Eb) int32 packed edge words
    counts: torch.Tensor,  # (p, R) int32 real edge tiles per (core, row block)
    word_hi: torch.Tensor | None = None,  # (p, R, T, Eb) int32, src_bits=32 only
    weights: torch.Tensor | None = None,  # (p, R, T, Eb) f32 (edge_op == 'add')
    fetch: torch.Tensor | None = None,  # (p, R, T) int32 dynamic fetch map
    *,
    num_rows: int,  # packed rows per core (= R * vb)
    vb: int,
    src_bits: int = 16,
    kind: str = "min",
    edge_op: str = "none",
    identity: float = 0.0,
) -> torch.Tensor:
    """All-cores accumulator over the compressed stream -> (p, num_rows).

    CUDA tensors launch the Hopper kernel (or raise); CPU tensors run the
    plain version. Mirrors the reference's signature: ``fetch`` replaces
    ``counts`` as the schedule when given."""
    check_stream(payload, word, counts, word_hi, weights, fetch, src_bits, kind, edge_op)
    if kind not in ("min", "sum"):
        raise ValueError(f"kind must be 'min' or 'sum' in this slice, got {kind!r}")
    if word.shape[1] * vb != num_rows:
        raise ValueError(f"R * vb = {word.shape[1]} * {vb} != num_rows = {num_rows}")
    if vb > smem_limit_rows():
        # the kernel keeps a block's vb-row accumulator in shared memory; the
        # same limit holds on every device so a partition runs everywhere
        raise ValueError(
            f"vb={vb} rows do not fit one block's shared memory "
            f"(at most {smem_limit_rows()}); partition with a smaller tile_vb"
        )
    if payload.device.type == "cuda":
        return _launch(payload, word, counts, word_hi, weights, fetch, num_rows, vb,
                       kind, edge_op, identity)
    return gather_reduce_cores_plain(
        payload, word, counts, word_hi, weights, fetch, num_rows=num_rows, vb=vb,
        src_bits=src_bits, kind=kind, edge_op=edge_op, identity=identity,
    )
