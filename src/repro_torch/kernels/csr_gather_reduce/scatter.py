"""The push (scatter) accumulator over the source-binned edge stream.

Counterpart of ``repro.kernels.csr_gather_reduce.kernel.scatter_reduce_cores_pallas``.
``scatter_reduce_cores`` min- or OR-reduces, for every core ``c``, the
mapped payloads of one phase's push stream into the core's whole label row:

  for each tile t of source block b that runs, and slot e of word[c, b, t]:
      decode (src, dst, valid) as the pull stream does; dst is the FULL row
      val = payload[src]          (+ weight, saturating at the identity, for 'add')
      out[c, dst] = min(out[c, dst], val)                for valid slots
                    (or out[c, dst] | val for kind='or')

A tile runs iff ``t < counts[c, b]`` or, given the fetch map of the push
stream's own coverage words, iff ``fetch[c, b, t] == t``. Only min and OR
are admitted: scatter order across blocks is arbitrary and skipped blocks
rely on their contributions being merged already, which holds for an
idempotent monotone reduce and not for a sum. A payload with a trailing lane
axis (G, L) gives (p, num_rows, L): vector min over query lanes (SSSP
batches) or the word OR of packed reach words (``kind='or'``, multi-source
BFS batches).

On a CUDA tensor it launches the hand-written Hopper kernel in
``csrc/scatter_reduce_cores.cu`` (built by ``nvcc`` at first use) or raises;
on a CPU tensor it runs ``scatter_reduce_cores_plain``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.fake import is_fake, nbytes, note, recording
from repro_torch.kernels.csr_gather_reduce.kernel import (
    _decode, _mapped, _min_into, _or_into, check_stream, identity_word, pointers,
    tiles_that_run, variant_name,
)

__all__ = [
    "scatter_reduce_cores",
    "scatter_reduce_cores_plain",
    "LAUNCHES",
    "reset_launch_counts",
]

SOURCE = "scatter_reduce_cores.cu"

# kernel launches per variant (``kernel.variant_name``); incremented only
# where the CUDA kernel is launched
LAUNCHES: dict = {}


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def scatter_reduce_cores_plain(
    payload, word, counts, word_hi=None, weights=None, fetch=None, *,
    num_rows, src_bits=16, kind="min", edge_op="none", identity=0.0,
):
    """Plain PyTorch version: decode every slot, mask invalid slots and the
    tiles that do not run, gather, map, and scatter-min (or -OR) into (p,
    num_rows[, L])."""
    p, _, t_tiles, _ = word.shape
    src, dst, valid = _decode(word, word_hi, src_bits)
    live = valid & tiles_that_run(counts, fetch, t_tiles).unsqueeze(-1)
    rows = (dst + num_rows * torch.arange(p, device=word.device).view(p, 1, 1, 1))[live]
    vals = _mapped(payload, src[live], weights[live] if weights is not None else None,
                   edge_op, identity)
    lane_shape = tuple(payload.shape[1:])
    if kind == "or":
        return _or_into(vals, rows, p * num_rows).view(p, num_rows, *lane_shape)
    return _min_into(vals, rows, p * num_rows, identity).view(p, num_rows, *lane_shape)


def _launch(payload, word, counts, word_hi, weights, fetch, num_rows, kind, edge_op,
            identity):
    from repro_torch.kernels.build import KernelLaunchError, load_library

    p, b_blocks, t_tiles, eb = word.shape
    lanes = payload.shape[1] if payload.dim() == 2 else 1  # (G,) is (G, 1) in memory
    out = torch.empty((p, num_rows) + tuple(payload.shape[1:]), dtype=payload.dtype,
                      device=payload.device)
    if recording():
        note("scatter_reduce_cores", word.numel() * lanes * (2 if edge_op == "add" else 1),
             nbytes(payload, word, word_hi, weights, counts, fetch, out))
    if is_fake(payload):  # the output rule: a dry run's trace
        return out
    lib, _ = load_library(SOURCE)
    if lanes % 4 == 0 and payload.data_ptr() % 16:  # the kernel's 16-B payload loads
        payload = payload.clone()
    fn = lib.scatter_reduce_cores_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_uint32, ctypes.c_void_p]
    args = [*pointers(payload, word, word_hi, weights, counts, fetch, out),
            p, b_blocks, t_tiles, eb, num_rows, lanes, int(kind == "or"),
            int(payload.dtype == torch.float32), int(edge_op == "add"),
            identity_word(payload.dtype, identity)]
    fn.restype = ctypes.c_int
    with torch.cuda.device(payload.device):  # the launch goes to the current device
        err = fn(*args, torch.cuda.current_stream(payload.device).cuda_stream)
    if err != 0:
        raise KernelLaunchError(f"scatter_reduce_cores launch failed: CUDA error {err}")
    key = variant_name(payload.dtype, kind, edge_op, lanes=payload.dim() == 2)
    LAUNCHES[key] = LAUNCHES.get(key, 0) + 1
    return out


def scatter_reduce_cores(
    payload: torch.Tensor,  # (G[, L]) phase-gathered block; int32 = uint32 bits
    word: torch.Tensor,  # (p, B, Tp, Eb) int32 packed push edge words
    counts: torch.Tensor,  # (p, B) int32 real edge tiles per (core, source block)
    word_hi: torch.Tensor | None = None,  # (p, B, Tp, Eb) int32, src_bits=32 only
    weights: torch.Tensor | None = None,  # (p, B, Tp, Eb) f32 (edge_op == 'add')
    fetch: torch.Tensor | None = None,  # (p, B, Tp) int32 dynamic fetch map
    *,
    num_rows: int,  # rows per core (= vertices_per_core)
    src_bits: int = 16,
    kind: str = "min",
    edge_op: str = "none",
    identity: float = 0.0,
) -> torch.Tensor:
    """Push accumulator over the source-binned stream -> (p, num_rows[, L]).

    CUDA tensors launch the Hopper kernel (or raise); CPU tensors run the
    plain version. Mirrors the reference's signature."""
    if kind not in ("min", "or"):
        raise ValueError(f"the push scatter requires kind='min' or 'or', got {kind!r}")
    check_stream(payload, word, counts, word_hi, weights, fetch, src_bits, kind, edge_op)
    if src_bits == 16 and num_rows > 1 << 15:
        raise ValueError(f"num_rows={num_rows} does not fit the 16-bit regime's dst field")
    if payload.device.type == "cuda" or is_fake(payload):  # a fake: the output rule
        return _launch(payload, word, counts, word_hi, weights, fetch, num_rows, kind,
                       edge_op, identity)
    return scatter_reduce_cores_plain(
        payload, word, counts, word_hi, weights, fetch, num_rows=num_rows,
        src_bits=src_bits, kind=kind, edge_op=edge_op, identity=identity,
    )
