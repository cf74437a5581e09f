"""The graph-core accumulator over the compressed edge stream.

Counterpart of ``repro.kernels.csr_gather_reduce.kernel.gather_reduce_cores_pallas``.
``gather_reduce_cores`` computes, for every core ``c`` and row block ``r``
of one phase, the reduce (min, sum or word OR) of the mapped payloads of the
block's edges into ``vb`` output rows that start at the reduce identity:

  for each tile t that runs and slot e of word[c, r, t]:
      16-bit regime: src = w & 0xFFFF, dstb = (w >> 16) & 0x7FFF, valid = w < 0
      32-bit regime: src = w, dstb = hi & 0x7FFFFFFF, valid = hi < 0
      val = payload[src]          (+ weight, saturating at the identity, for 'add')
      out[c, r * vb + dstb] = reduce(out[...], val)      for valid slots

A tile runs iff ``t < counts[c, r]`` (the static schedule) or, given the
dynamic fetch map of the frontier-aware tile skip, iff ``fetch[c, r, t] ==
t`` (``core.frontier_words.active_fetch_map``).

A payload with a trailing lane axis (G, L) is a multi-query batch and gives
an output (p, num_rows, L): L vector lanes reduced independently by min or
sum (SSSP/PPR batches; the SSSP add puts a slot's one weight on every lane),
or L packed reach words reduced by bitwise OR (``kind='or'``, multi-source
BFS; identity 0). A slot is decoded once for all its lanes.

On a CUDA tensor it launches the hand-written Hopper kernel in
``csrc/gather_reduce_cores.cu`` (built by ``nvcc`` at first use) or raises;
on a CPU tensor it runs ``gather_reduce_cores_plain``, the plain PyTorch
version of the same function, which is also what the kernel is checked
against on the card. An int32 payload holds uint32 bit patterns
(``core.u32``) and reduces with the unsigned min or the word OR.
"""
from __future__ import annotations

import ctypes
import struct

import torch

from repro_torch.core import u32
from repro_torch.kernels.fake import is_fake, nbytes, note, recording

__all__ = [
    "gather_reduce_cores",
    "gather_reduce_cores_plain",
    "LAUNCHES",
    "reset_launch_counts",
    "variant_name",
    "smem_limit_rows",
    "lane_chunk",
]

SOURCE = "gather_reduce_cores.cu"
SMEM_LIMIT = 232448  # bytes of shared memory one Hopper block can use
_STAGING_WORDS = 296  # the one-lane kernel's shared words beside its rows

# kernel launches per variant (see ``variant_name``); incremented only where
# the CUDA kernel is launched
LAUNCHES: dict = {}


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def variant_name(payload_dtype: torch.dtype, kind: str, edge_op: str,
                 lanes: bool = False) -> str:
    """'min_u32' (BFS/WCC), 'min_f32_add' (SSSP), 'sum_f32' (PageRank), and
    with a lane axis 'or_u32_lanes' (BFS batches), 'min_f32_add_lanes' (SSSP
    batches), 'sum_f32_lanes' (PPR batches), ..."""
    ty = "u32" if payload_dtype == torch.int32 else "f32"
    return f"{kind}_{ty}" + ("_add" if edge_op == "add" else "") + ("_lanes" if lanes else "")


def smem_limit_rows() -> int:
    """Largest vb the wrapper admits on every device, so that a partition
    runs everywhere (on the CPU too, where no kernel is built): the
    one-lane kernel's vb-row accumulator and its ``_STAGING_WORDS`` of
    staging (``one_lane_smem_bytes`` in the .cu file) fit one block. The
    launcher itself refuses a vb that does not fit."""
    return SMEM_LIMIT // 4 - _STAGING_WORDS


def lane_chunk(vb: int, lanes: int, kind: str) -> int:
    """Lanes one block of the kernel accumulates on the current CUDA device,
    as its launcher picks them from the lane kernel's shared-memory layout
    (the vb x Lc accumulator, rows an odd stride apart where Lc is no
    multiple of 8, and for 'sum' two staged run pieces a thread group): all
    ``lanes`` when they fit one block (at
    most 64 lanes, 16 when ``lanes % 4 != 0``), else the even split into the
    fewest chunks that fit, a multiple of 4 lanes when ``lanes % 4 == 0``
    (each chunk re-reads its tiles' words). Needs the built kernel, so a
    CUDA device."""
    from repro_torch.kernels.build import load_library

    fn = load_library(SOURCE)[0].gather_reduce_cores_lane_chunk
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    chunk = fn(vb, lanes, _KIND_CODES[kind])
    if chunk < 1:
        raise ValueError(f"vb={vb} rows of one lane do not fit one block's shared memory")
    return chunk


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
    """Gather the source payloads (rows of L lanes, if any) of the live
    slots and apply the map UDF; a slot's weight applies to all its lanes."""
    vals = payload[src.long()]
    if edge_op == "add":  # saturating min-plus; no weights = unit weights
        step = 1.0
        if weights is not None:
            step = weights.view(-1, *([1] * (vals.dim() - 1)))
        vals = torch.where(vals >= identity, torch.full_like(vals, identity), vals + step)
    return vals


def _at_rows(rows, vals):
    """The scatter index of ``vals`` (n[, L]): its row, on every lane."""
    return rows.long().view(-1, *([1] * (vals.dim() - 1))).expand_as(vals)


def _min_into(vals, rows, size, identity):
    """Min-reduce ``vals`` (n[, L]) at ``rows`` into ``size`` rows holding the
    identity; int32 values are uint32 bits (unsigned min in int64)."""
    shape = (size,) + tuple(vals.shape[1:])
    idx = _at_rows(rows, vals)
    if vals.dtype == torch.int32:
        out = torch.full(shape, int(identity) & u32.U32_MAX, dtype=torch.int64,
                         device=vals.device)
        out.scatter_reduce_(0, idx, u32.widen(vals), "amin")
        return u32.narrow(out)
    out = torch.full(shape, identity, dtype=vals.dtype, device=vals.device)
    out.scatter_reduce_(0, idx, vals, "amin")
    return out


def _or_into(vals, rows, size):
    """Word-OR ``vals`` (int32 bits, (n[, L])) at ``rows`` into ``size`` rows
    holding 0. torch has no OR reduce: each bit plane is a 0/1 max, as the
    reference's oracle does it."""
    idx = _at_rows(rows, vals)
    wide = u32.widen(vals)
    out = torch.zeros((size,) + tuple(vals.shape[1:]), dtype=torch.int64, device=vals.device)
    for b in range(32):
        plane = torch.zeros_like(out).scatter_reduce_(0, idx, (wide >> b) & 1, "amax")
        out |= plane << b
    return u32.narrow(out)


def tile_ordered_sum(vals, rows, tile_of, t_tiles, vb, size, identity):
    """Sum ``vals`` (n[, L]) at ``rows`` (global rows, vb to a row block)
    into ``size`` rows holding the identity, with the reference kernel's
    association: each tile's slots are summed per row first, then the tile
    partials are added in tile order (on the CPU ``index_add_`` runs in
    index order); lanes sum independently."""
    lane_shape = tuple(vals.shape[1:])
    key = ((rows // vb) * t_tiles + tile_of) * vb + rows % vb
    uniq, inv = torch.unique(key, return_inverse=True)
    part = torch.zeros((uniq.shape[0],) + lane_shape, dtype=vals.dtype, device=vals.device)
    part.index_add_(0, inv, vals)
    out = torch.full((size,) + lane_shape, identity, dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, (uniq // (t_tiles * vb)) * vb + uniq % vb, part)


def gather_reduce_cores_plain(
    payload, word, counts, word_hi=None, weights=None, fetch=None, *,
    num_rows, vb, src_bits=16, kind="min", edge_op="none", identity=0.0,
):
    """Plain PyTorch version: decode every slot, mask invalid slots and the
    tiles that do not run, gather, map, and scatter-reduce into (p, R*vb[,
    L])."""
    p, r_blocks, t_tiles, eb = word.shape
    lane_shape = tuple(payload.shape[1:])
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
        return _min_into(vals, rows, p * num_rows, identity).view(p, num_rows, *lane_shape)
    if kind == "or":
        return _or_into(vals, rows, p * num_rows).view(p, num_rows, *lane_shape)
    t_of = torch.arange(t_tiles, device=word.device).view(1, 1, t_tiles, 1).expand_as(word)
    return tile_ordered_sum(vals, rows, t_of[live], t_tiles, vb, p * num_rows,
                            identity).view(p, num_rows, *lane_shape)


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
    if payload.dim() not in (1, 2) or (payload.dim() == 2 and payload.shape[1] == 0):
        raise ValueError(f"payload must be (G,) or (G, lanes >= 1), got {tuple(payload.shape)}")
    if payload.dtype not in (torch.int32, torch.float32):
        raise ValueError(f"payload must be int32 (uint32 bits) or float32, got {payload.dtype}")
    if payload.dtype == torch.int32 and (kind not in ("min", "or") or edge_op != "none"):
        raise ValueError("uint32 payloads support kind='min' or 'or', edge_op='none' only")
    if kind == "or" and (payload.dtype != torch.int32 or payload.dim() != 2):
        # the reference asserts a packed lane-word axis for 'or'
        raise ValueError("kind='or' reduces packed uint32 reach words (G, W); "
                         "float32 payloads take kind='min'")
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


_KIND_CODES = {"min": 0, "sum": 1, "or": 2}  # kMin, kSum, kOr in the .cu file


def _launch(payload, word, counts, word_hi, weights, fetch, num_rows, vb, kind, edge_op,
            identity):
    from repro_torch.kernels.build import KernelLaunchError, load_library

    p, r_blocks, t_tiles, eb = word.shape
    lanes = payload.shape[1] if payload.dim() == 2 else 1  # (G,) is (G, 1) in memory
    out = torch.empty((p, num_rows) + tuple(payload.shape[1:]), dtype=payload.dtype,
                      device=payload.device)
    # a slot a lane: the edge op (weights) and the reduce
    if recording():
        note("gather_reduce_cores", word.numel() * lanes * (2 if edge_op == "add" else 1),
             nbytes(payload, word, word_hi, weights, counts, fetch, out))
    if is_fake(payload):  # the output rule: a dry run's trace
        return out
    lib, _ = load_library(SOURCE)
    if lanes % 4 == 0 and payload.data_ptr() % 16:  # the lane kernel's 16-B loads
        payload = payload.clone()
    fn = lib.gather_reduce_cores_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_uint32, ctypes.c_void_p]
    args = [*pointers(payload, word, word_hi, weights, counts, fetch, out),
            p, r_blocks, t_tiles, eb, vb, lanes, _KIND_CODES[kind],
            int(payload.dtype == torch.float32), int(edge_op == "add"),
            identity_word(payload.dtype, identity)]
    fn.restype = ctypes.c_int
    with torch.cuda.device(payload.device):  # the launch goes to the current device
        err = fn(*args, torch.cuda.current_stream(payload.device).cuda_stream)
    if err != 0:
        raise KernelLaunchError(f"gather_reduce_cores launch failed: CUDA error {err}")
    key = variant_name(payload.dtype, kind, edge_op, lanes=payload.dim() == 2)
    LAUNCHES[key] = LAUNCHES.get(key, 0) + 1
    return out


def gather_reduce_cores(
    payload: torch.Tensor,  # (G[, L]) phase-gathered block; int32 = uint32 bits
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
    """All-cores accumulator over the compressed stream -> (p, num_rows[, L]).

    CUDA tensors launch the Hopper kernel (or raise); CPU tensors run the
    plain version. Mirrors the reference's signature: ``fetch`` replaces
    ``counts`` as the schedule when given."""
    check_stream(payload, word, counts, word_hi, weights, fetch, src_bits, kind, edge_op)
    if kind not in _KIND_CODES:
        raise ValueError(f"kind must be 'min', 'sum' or 'or', got {kind!r}")
    if word.shape[1] * vb != num_rows:
        raise ValueError(f"R * vb = {word.shape[1]} * {vb} != num_rows = {num_rows}")
    if vb > smem_limit_rows():
        # the kernel keeps a block's vb-row accumulator in shared memory; the
        # same limit holds on every device so a partition runs everywhere
        raise ValueError(
            f"vb={vb} rows do not fit one block's shared memory "
            f"(at most {smem_limit_rows()}); partition with a smaller tile_vb"
        )
    if payload.device.type == "cuda" or is_fake(payload):  # a fake: the output rule
        return _launch(payload, word, counts, word_hi, weights, fetch, num_rows, vb,
                       kind, edge_op, identity)
    return gather_reduce_cores_plain(
        payload, word, counts, word_hi, weights, fetch, num_rows=num_rows, vb=vb,
        src_bits=src_bits, kind=kind, edge_op=edge_op, identity=identity,
    )
