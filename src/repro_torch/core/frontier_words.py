"""Frontier bitmaps as packed words, on torch.

Counterpart of ``repro.core.frontier_words``. A **frontier word** is one
32-bit word whose bit ``b`` says "source vertex ``w * 32 + b`` of this
sub-interval changed", the same 32-sources-per-word granularity as the
partition-time coverage words (``PartitionedGraph.tile_coverage``), so the
activity test of a tile is a bitwise AND. Frontier state is ``(..., l, Ws)``
with ``Ws = ceil(sub_size / 32)``: per core, per phase. Phase ``m``'s
gathered frontier words are the cores' ``[:, m, :]`` slices in core order,
the layout of the phase's gathered block, so coverage bit ``j`` and frontier
word ``j`` describe the same 32 sources.

The reference keeps these words as uint32. Here they are int32 tensors
holding the same bits (``core.u32``): the functions below only test words
against zero, AND them and count their bits, which need no unsigned order.
These are tensor ops, not kernels; they run on whatever device their inputs
are on.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import u32

__all__ = [
    "WORD_BITS",
    "words_per_sub",
    "coverage_word_count",
    "pack_bits",
    "frontier_words_from_labels",
    "full_frontier_words",
    "frontier_popcount",
    "lane_popcounts",
    "frontier_active_tiles",
    "active_fetch_map",
]

WORD_BITS = 32


def words_per_sub(sub_size: int) -> int:
    """Frontier words per (core, phase) sub-interval: ceil(sub_size / 32)."""
    return -(-sub_size // WORD_BITS)


def coverage_word_count(p: int, sub_size: int) -> int:
    """Coverage words per tile: the phase's gathered block holds
    ``p * words_per_sub`` frontier-word slots, one coverage *bit* each."""
    return -(-(p * words_per_sub(sub_size)) // WORD_BITS)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., W*32) bool -> (..., W) int32 bits; bit ``b`` of word ``w`` is
    element ``w*32 + b`` (little-endian, as every consumer reads it)."""
    *lead, nb = bits.shape
    if nb % WORD_BITS:
        raise ValueError(f"need a multiple of {WORD_BITS} bits, got {nb}")
    b = bits.reshape(*lead, nb // WORD_BITS, WORD_BITS).to(torch.int64)
    weights = torch.ones((), dtype=torch.int64, device=bits.device) << torch.arange(
        WORD_BITS, dtype=torch.int64, device=bits.device
    )
    return u32.narrow((b * weights).sum(dim=-1))


def frontier_words_from_labels(
    old: torch.Tensor, new: torch.Tensor, l: int, sub_size: int, *, lanes: bool = False
) -> torch.Tensor:
    """Label diff -> frontier words: (..., Vl) pair -> (..., l, Ws) int32.

    The run is converged iff every word is zero. ``lanes=True`` (multi-query
    batches): the labels carry a trailing lane axis (..., Vl, L), K vector
    lanes or packed reach words, and a vertex is in the frontier iff ANY of
    its lanes changed. The words are the UNION of the per-lane frontiers: a
    tile streams while any live query needs it, and a converged lane adds
    nothing."""
    changed = old != new
    if lanes:
        changed = changed.any(dim=-1)
    *lead, vl = changed.shape
    if vl != l * sub_size:
        raise ValueError(f"labels hold {vl} rows, expected l * sub_size = {l * sub_size}")
    changed = changed.reshape(*lead, l, sub_size)
    pad = words_per_sub(sub_size) * WORD_BITS - sub_size
    if pad:
        changed = torch.nn.functional.pad(changed, (0, pad))
    return pack_bits(changed)


def full_frontier_words(l: int, sub_size: int, lead=(), device="cpu") -> torch.Tensor:
    """The all-active frontier (every real source set, the tail bits of the
    last word of a sub-interval clear): the iteration-0 state."""
    ws = words_per_sub(sub_size)
    bits = np.zeros(ws * WORD_BITS, dtype=bool)
    bits[:sub_size] = True
    words = pack_bits(torch.from_numpy(bits)).to(device)
    return words.expand(*lead, l, ws).contiguous()


def _popcount32(words: torch.Tensor) -> torch.Tensor:
    """Per-word set bits of int32 storage (SWAR in int64: torch has no
    popcount op)."""
    x = u32.widen(words)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def frontier_popcount(frontier: torch.Tensor) -> torch.Tensor:
    """Total set bits (int64 scalar tensor on the frontier's device): the
    density switch, the direction switch and the convergence test read it."""
    return _popcount32(frontier).sum()


def lane_popcounts(changed_lanes: torch.Tensor) -> torch.Tensor:
    """Per-lane frontier sizes: (..., K) bool change mask -> (K,) int64
    changed-vertex counts summed over all leading axes (multi-query
    observability; ``problem.not_converged_lanes`` is its boolean form)."""
    k = changed_lanes.shape[-1]
    return changed_lanes.reshape(-1, k).sum(dim=0)


def frontier_active_tiles(
    coverage_m: torch.Tensor,  # (n, R, T, Wc) int32 phase coverage words
    gathered_words: torch.Tensor,  # (Wg,) int32 phase frontier, gathered order
    counts_m: torch.Tensor,  # (n, R) int32 static real-tile counts
    use_dense: bool | None = None,  # host bool: the wide-frontier fallback
) -> torch.Tensor:
    """The dynamic tile scheduler: (n, R, T) bool active mask for one phase.

    A tile is active iff it is real (``t < counts``) AND its coverage words
    intersect the set of nonzero frontier words. ``use_dense`` True returns
    the static all-real mask (the frontier is wide and the AND would save
    nothing); None or False computes the dynamic mask. The test is
    conservative at word granularity, never lossy."""
    n, r_blocks, t_tiles, wc = coverage_m.shape
    t_idx = torch.arange(t_tiles, device=coverage_m.device, dtype=torch.int32)
    real = t_idx.view(1, 1, t_tiles) < counts_m.view(n, r_blocks, 1)
    if use_dense:
        return real
    nz = gathered_words != 0
    pad = wc * WORD_BITS - nz.shape[0]
    if pad:
        nz = torch.nn.functional.pad(nz, (0, pad))
    packed = pack_bits(nz)  # (Wc,)
    hit = ((coverage_m & packed) != 0).any(dim=-1)
    return real & hit


def active_fetch_map(active: torch.Tensor) -> torch.Tensor:
    """Active mask -> the kernels' fetch map: ``fetch[..., t]`` is the index
    of the last active tile at or before ``t`` (-1 before the first). A
    kernel runs tile ``t`` iff ``fetch[..., t] == t``."""
    t_idx = torch.arange(active.shape[-1], device=active.device, dtype=torch.int32)
    marked = torch.where(active, t_idx, torch.full_like(t_idx, -1))
    return torch.cummax(marked, dim=-1).values
