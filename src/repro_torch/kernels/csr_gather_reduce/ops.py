"""Host-side tile preparation (numpy), the level-2 split-row fold (torch),
and the one-bucket entry point ``gather_reduce``.

Counterpart of ``repro.kernels.csr_gather_reduce.ops``. The host half is a
numpy copy of the reference, so a default ``PartitionConfig`` gives
byte-identical arrays; the one change is ``_balance_row_blocks``, whose
per-row ``argmin`` scan over all blocks became a heap with the same choices.

``prepare_tiles`` bins a (dst-sorted) edge bucket into (R, T, Eb) row-block
tiles at partition time. With ``split_threshold`` set it also SPLITS hub rows
whose edge count exceeds the threshold into multiple *virtual rows* (even
chunks) before LPT packing; the kernel reduces each virtual row on its own
(level 1) and ``combine_split_rows`` folds the virtual-row partials back into
natural rows with the problem's reduce op (level 2). ``pack_edge_words``
bit-packs the (src, dstb, valid) index triple of each edge slot into the
compressed word stream the kernel reads (see ``kernel.py`` for the word
format and ``choose_src_bits`` for the 16/32-bit regime rule).
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np
import torch

from repro_torch.core import u32

__all__ = [
    "segment_reduce_rows",
    "TileLayout",
    "TilePlan",
    "PushTileLayout",
    "plan_tiles",
    "plan_push_tiles",
    "push_block_edges",
    "auto_push_block",
    "prepare_tiles",
    "prepare_push_tiles",
    "choose_src_bits",
    "pack_edge_words",
    "stack_packed_tiles",
    "stack_push_tiles",
    "tile_coverage_words",
    "split_map_from_row_orig",
    "gather_reduce",
    "layout_to",
    "combine_split_rows",
]

# packed-word field bounds (see kernel.py "Compressed edge stream" docstring)
SRC16_LIMIT = 1 << 16  # gathered-block offsets that fit the 16-bit src field
DSTB16_LIMIT = 1 << 15  # row-block offsets that fit next to a 16-bit src


def choose_src_bits(gathered_size: int, vb: int) -> int:
    """Packed-word regime rule: 16-bit src iff every gathered-block offset fits
    16 bits AND the row-block offset fits the remaining 15 bits (bit 31 is the
    valid flag). Otherwise fall back to a two-word (32-bit src) stream."""
    return 16 if gathered_size <= SRC16_LIMIT and vb <= DSTB16_LIMIT else 32


def pack_edge_words(
    src: np.ndarray,  # (...,) int, gathered-block offsets in [0, G)
    dstb: np.ndarray,  # (...,) int, row offsets WITHIN the row block [0, vb)
    valid: np.ndarray,  # (...,) bool
    *,
    src_bits: int,
) -> tuple[np.ndarray, np.ndarray | None]:
    """Bit-pack edge-slot index triples into the compressed stream (numpy,
    partition time). Returns ``(word, word_hi)`` int32 arrays of ``src.shape``;
    ``word_hi`` is None in the 16-bit regime.

      src_bits=16: word    = valid<<31 | dstb<<16 | src          (4 B/edge)
      src_bits=32: word    = src                                  (8 B/edge)
                   word_hi = valid<<31 | dstb

    Padding slots (valid=False) pack to words with bit 31 clear, so the
    in-kernel validity test is simply ``word < 0`` (resp. ``word_hi < 0``).
    """
    src64 = np.asarray(src, dtype=np.int64)
    dstb64 = np.asarray(dstb, dtype=np.int64)
    # 32-bit bounds are the int32-REPRESENTABLE ranges: the kernel reads the
    # words back as int32, so src in [2^31, 2^32) would gather at a negative
    # index and dstb's bit 31 is the valid flag.
    src_limit = SRC16_LIMIT if src_bits == 16 else 1 << 31
    dstb_limit = DSTB16_LIMIT if src_bits == 16 else 1 << 31
    if src_bits not in (16, 32):
        raise ValueError(f"src_bits must be 16 or 32, got {src_bits}")
    if src64.size and not (0 <= int(src64.min()) and int(src64.max()) < src_limit):
        raise ValueError(
            f"src offsets [{int(src64.min())}, {int(src64.max())}] do not fit "
            f"the {src_bits}-bit field"
            + ("; use src_bits=32" if src_bits == 16 else "")
        )
    if dstb64.size and not (0 <= int(dstb64.min()) and int(dstb64.max()) < dstb_limit):
        raise ValueError(
            f"dstb offsets [{int(dstb64.min())}, {int(dstb64.max())}] do not fit "
            f"the {15 if src_bits == 16 else 31}-bit field"
            + ("; use src_bits=32" if src_bits == 16 else "")
        )
    src_u = src64.astype(np.uint32)
    dstb_u = dstb64.astype(np.uint32)
    vbit = np.asarray(valid, dtype=np.uint32) << 31
    if src_bits == 16:
        return (vbit | (dstb_u << 16) | src_u).view(np.int32), None
    return src_u.view(np.int32), (vbit | dstb_u).view(np.int32)


def stack_packed_tiles(
    layouts: list[TileLayout], *, src_bits: int
) -> tuple[np.ndarray, np.ndarray | None, np.ndarray, np.ndarray | None]:
    """Pack each layout's (src, dstb, valid) triple and stack to one
    uniform-(R, T) compressed stream: ``(word, word_hi, counts, weights)``
    with shapes (n, R_max, T_max, Eb) / (n, R_max). Layouts shorter than
    R_max / T_max are padded with all-invalid words that ``counts`` (0 for
    padded row blocks) tells the kernel to skip. The
    single source of truth for the stream layout the engine, benchmarks, and
    tests consume."""
    n = len(layouts)
    eb = layouts[0].src.shape[2]
    # hub-row splitting can grow R per bucket; pad both R and T to the max
    # (extra blocks have counts 0, so the kernel's early-out skips them).
    r_max = max(t.src.shape[0] for t in layouts)
    t_max = max(t.src.shape[1] for t in layouts)
    word = np.zeros((n, r_max, t_max, eb), np.int32)
    word_hi = np.zeros((n, r_max, t_max, eb), np.int32) if src_bits == 32 else None
    counts = np.zeros((n, r_max), np.int32)
    any_w = any(t.weights is not None for t in layouts)
    weights = np.zeros((n, r_max, t_max, eb), np.float32) if any_w else None
    for i, t in enumerate(layouts):
        rr, tt = t.src.shape[:2]
        w0, w1 = pack_edge_words(t.src, t.dstb, t.valid, src_bits=src_bits)
        word[i, :rr, :tt] = w0
        if word_hi is not None:
            word_hi[i, :rr, :tt] = w1
        counts[i, :rr] = t.tile_counts
        if weights is not None and t.weights is not None:
            weights[i, :rr, :tt] = t.weights
    return word, word_hi, counts, weights


def tile_coverage_words(
    word: np.ndarray,  # (..., Eb) int32 packed edge words (one tile per row)
    word_hi: np.ndarray | None,  # (..., Eb) int32 in the 32-bit regime
    *,
    src_bits: int,
    p: int,
    sub_size: int,
) -> np.ndarray:
    """Per-tile source-coverage bitmaps for frontier-aware dynamic skipping.

    Decodes each tile's packed words (numpy, partition time — the ONLY place
    the compressed stream is ever unpacked outside the kernel) and records, at
    frontier-WORD granularity, which 32-source groups of the phase's gathered
    block the tile reads: coverage bit ``j`` is set iff some valid edge's
    gathered src index lands in frontier word ``j`` (``j = src_core * Ws +
    (src mod sub_size) // 32`` with ``Ws = ceil(sub_size / 32)`` — the layout
    contract shared with ``core.frontier_words``). Returns (..., Wc) uint32
    with ``Wc = ceil(p * Ws / 32)``: 32x smaller than per-source bitmaps, and
    conservative only — a tile whose coverage misses every live frontier word
    provably reads no changed source. All-invalid (padding) tiles get
    all-zero coverage, so they stay dead under any frontier.
    """
    word = np.asarray(word)
    ws = -(-sub_size // 32)
    wc = -(-(p * ws) // 32)
    if src_bits == 16:
        valid = word < 0
        src = (word.view(np.uint32) & np.uint32(0xFFFF)).astype(np.int64)
    else:
        valid = np.asarray(word_hi) < 0
        src = word.view(np.uint32).astype(np.int64)
    # gathered index -> frontier-word slot in the phase's gathered block
    widx = (src // sub_size) * ws + (src % sub_size) // 32
    lead = word.shape[:-1]
    cov = np.zeros(lead + (wc,), dtype=np.uint32)
    flat = cov.reshape(-1, wc)
    tile_of_slot = np.repeat(np.arange(flat.shape[0]), word.shape[-1])
    keep = valid.reshape(-1)
    ti, wsel = tile_of_slot[keep], widx.reshape(-1)[keep]
    np.bitwise_or.at(
        flat,
        (ti, wsel // 32),
        np.left_shift(np.uint32(1), (wsel % 32).astype(np.uint32)),
    )
    return cov


@dataclasses.dataclass(frozen=True)
class PushTileLayout:
    """One bucket's CSC-style push (scatter) tiles, binned by SOURCE block.

    The pull layout bins edges by destination row block so the kernel's
    accumulator is a pure function of the grid; the push layout bins the SAME
    edge set by source block ``b = gidx // block_sources`` so a NARROW
    frontier maps to few tiles: every out-edge of the 32-aligned source group
    ``[b * bs, (b+1) * bs)`` lives in block b's tiles, and a frontier that
    touches no source of a block never streams it. ``dst`` carries the FULL
    local destination index in [0, num_rows) — the scatter kernel's output is
    the whole per-core label row, so there is no row-block offset to strip.
    """

    src: np.ndarray  # (B, Tp, Eb) int32 gathered-block offsets
    dst: np.ndarray  # (B, Tp, Eb) int32 FULL local dst in [0, num_rows)
    valid: np.ndarray  # (B, Tp, Eb) bool
    weights: np.ndarray | None  # (B, Tp, Eb) f32
    tile_counts: np.ndarray  # (B,) int32 real edge tiles per source block
    block_sources: int
    num_rows: int


def prepare_push_tiles(
    src_gidx: np.ndarray,  # (E,) int32 gathered-block offsets
    dst_lidx: np.ndarray,  # (E,) int32 local dst in [0, num_rows)
    valid: np.ndarray,  # (E,) bool
    *,
    gathered_size: int,
    block_sources: int,
    num_rows: int,
    eb: int,
    weights: np.ndarray | None = None,
) -> PushTileLayout:
    """Bin one (core, phase) bucket's edges by source block for the push
    (scatter) stream. ``block_sources`` must be a multiple of 32 so every
    block covers whole frontier words and the coverage-word activity test
    (``tile_coverage_words`` on the push stream) is exact at block
    granularity. Edges inside a block are ordered (src, dst) — the order is
    irrelevant for the min/or reduces the push path admits (associative,
    commutative, idempotent), but a deterministic layout keeps partitions
    reproducible."""
    assert block_sources % 32 == 0, block_sources
    keep = np.asarray(valid)
    src = np.asarray(src_gidx)[keep].astype(np.int64)
    dst = np.asarray(dst_lidx)[keep].astype(np.int64)
    w = np.asarray(weights)[keep] if weights is not None else None
    n_blocks = max(1, -(-gathered_size // block_sources))
    blk = src // block_sources
    order = np.lexsort((dst, src))  # blk is src // bs, so this is block-major
    src, dst, blk = src[order], dst[order], blk[order]
    if w is not None:
        w = w[order]
    counts = np.bincount(blk, minlength=n_blocks)
    t_tiles = max(1, int(-(-counts.max() // eb))) if counts.size else 1
    src_t = np.zeros((n_blocks, t_tiles, eb), dtype=np.int32)
    dst_t = np.zeros((n_blocks, t_tiles, eb), dtype=np.int32)
    val_t = np.zeros((n_blocks, t_tiles, eb), dtype=bool)
    w_t = (
        np.zeros((n_blocks, t_tiles, eb), dtype=np.float32)
        if w is not None
        else None
    )
    starts = np.zeros(n_blocks + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    for b in range(n_blocks):
        s, e = int(starts[b]), int(starts[b + 1])
        n = e - s
        src_t[b].reshape(-1)[:n] = src[s:e]
        dst_t[b].reshape(-1)[:n] = dst[s:e]
        val_t[b].reshape(-1)[:n] = True
        if w_t is not None:
            w_t[b].reshape(-1)[:n] = w[s:e]
    return PushTileLayout(
        src=src_t, dst=dst_t, valid=val_t, weights=w_t,
        tile_counts=(-(-counts // eb)).astype(np.int32),
        block_sources=block_sources, num_rows=num_rows,
    )


def stack_push_tiles(
    layouts: list[PushTileLayout], *, src_bits: int
) -> tuple[np.ndarray, np.ndarray | None, np.ndarray, np.ndarray | None]:
    """Pack + stack per-bucket push layouts to one uniform (n, B, Tp, Eb)
    compressed scatter stream: ``(word, word_hi, counts, weights)``. Every
    bucket shares B (the gathered block size is phase-invariant); Tp is
    padded to the max, and ``counts`` tells the kernel which tiles are real —
    the exact mirror of ``stack_packed_tiles`` for the pull stream. The
    packed ``dstb`` field holds the FULL local destination row, so the
    16-bit regime additionally requires ``num_rows <= 2^15`` (the caller
    picks ``src_bits`` via ``choose_src_bits(gathered_size, num_rows)``)."""
    n = len(layouts)
    eb = layouts[0].src.shape[2]
    b_max = max(t.src.shape[0] for t in layouts)
    t_max = max(t.src.shape[1] for t in layouts)
    word = np.zeros((n, b_max, t_max, eb), np.int32)
    word_hi = np.zeros((n, b_max, t_max, eb), np.int32) if src_bits == 32 else None
    counts = np.zeros((n, b_max), np.int32)
    any_w = any(t.weights is not None for t in layouts)
    weights = np.zeros((n, b_max, t_max, eb), np.float32) if any_w else None
    for i, t in enumerate(layouts):
        bb, tt = t.src.shape[:2]
        w0, w1 = pack_edge_words(t.src, t.dst, t.valid, src_bits=src_bits)
        word[i, :bb, :tt] = w0
        if word_hi is not None:
            word_hi[i, :bb, :tt] = w1
        counts[i, :bb] = t.tile_counts
        if weights is not None and t.weights is not None:
            weights[i, :bb, :tt] = t.weights
    return word, word_hi, counts, weights


@dataclasses.dataclass(frozen=True)
class TileLayout:
    """(R, T, Eb) row-block binned edges; padding slots have valid=False.

    With hub-row splitting engaged (``row_orig`` set) the R*vb kernel-output
    positions hold VIRTUAL rows: a natural row above the split threshold owns
    several of them, each reduced independently by the kernel, and R may
    exceed ``num_rows / vb``. ``row_orig`` maps every packed position back to
    its natural row (-1 = spare slot, holds the reduce identity); the
    second-level combine (``combine_split_rows``) folds the partials together.
    ``row_pos`` and ``row_orig`` are mutually exclusive.
    """

    src: np.ndarray  # (R, T, Eb) int32
    dstb: np.ndarray  # (R, T, Eb) int32 in [0, vb)
    valid: np.ndarray  # (R, T, Eb) bool
    weights: np.ndarray | None  # (R, T, Eb) f32
    vb: int
    num_rows: int  # NATURAL rows (combine output size); packed rows = R * vb
    # slot -> index into the ORIGINAL (pre-binning) edge arrays, 0 on padding.
    # Lets runtime-traced per-edge values (e.g. GAT scores) be laid out into
    # tile order with one static gather.
    gather_idx: np.ndarray | None = None  # (R, T, Eb) int64
    # degree-aware packing: natural row i's reduction lives at kernel-output
    # position row_pos[i] (None = identity layout). Undo with out[row_pos].
    row_pos: np.ndarray | None = None  # (num_rows,) int32
    # real edge tiles per row block: ceil(real_edges[r] / Eb). Tiles with
    # t >= tile_counts[r] are all-padding; the fused kernel skips them.
    tile_counts: np.ndarray | None = None  # (R,) int32
    # hub-row splitting (level-2 reduce): packed position -> natural row
    # (-1 = spare slot carrying the reduce identity). None = no row was split.
    row_orig: np.ndarray | None = None  # (R * vb,) int32
    num_split_rows: int = 0  # natural rows split into > 1 virtual rows
    # T this bucket would have needed WITHOUT splitting (== own T when no row
    # was split) — the denominator of the t_max_reduction metric.
    t_tiles_unsplit: int = 0

    @property
    def tile_padding_ratio(self) -> float:
        total = self.valid.size
        return 1.0 - float(self.valid.sum()) / max(total, 1)


def _balance_row_blocks(row_counts: np.ndarray, r_blocks: int, vb: int) -> np.ndarray:
    """LPT row->block assignment: rows sorted by in-degree, each placed in the
    least-loaded block with a free slot (ties to the lowest block index).
    Minimizes the max per-block edge count so one hub row no longer inflates
    T for EVERY row block. Returns row_pos (natural row -> packed output
    position).

    The reference scans all blocks with ``argmin`` once per row (cost
    ``rows * blocks``). Here a heap of ``(load, block)`` gives the same
    choice: its minimum is the least load with the lowest index on ties, and
    a block leaves the heap when its ``vb`` slots are full, so the output is
    byte-identical. Once only zero-count rows remain, a block's load stops
    changing, so the heap hands each block out until it is full, in
    ``(load, block)`` order; that tail is filled with array ops.
    """
    order = np.argsort(-row_counts, kind="stable")
    n = int(row_counts.shape[0])
    row_pos = np.empty(n, dtype=np.int32)
    cnt_sorted = np.asarray(row_counts)[order]
    n_live = int(np.count_nonzero(cnt_sorted))  # rows sorted by -count
    heap = [(0, b) for b in range(r_blocks)]  # sorted list == valid heap
    slots = [0] * r_blocks
    pos_live = np.empty(n_live, dtype=np.int64)
    for i, cnt in enumerate(cnt_sorted[:n_live].tolist()):
        load, b = heap[0]
        s = slots[b]
        pos_live[i] = b * vb + s
        slots[b] = s + 1
        if s + 1 < vb:
            heapq.heapreplace(heap, (load + cnt, b))
        else:
            heapq.heappop(heap)
    row_pos[order[:n_live]] = pos_live
    if n_live < n:
        tail = [
            np.arange(b * vb + slots[b], (b + 1) * vb, dtype=np.int64)
            for _, b in sorted(heap)
        ]
        row_pos[order[n_live:]] = np.concatenate(tail)[: n - n_live]
    return row_pos


def _lpt_max_load(row_counts: np.ndarray, r_blocks: int, vb: int) -> int:
    """Max per-block edge load the LPT packer achieves WITHOUT splitting."""
    if r_blocks <= 1:
        return int(row_counts.sum())
    pos = _balance_row_blocks(row_counts, r_blocks, vb)
    loads = np.bincount(pos // vb, weights=row_counts.astype(np.float64),
                        minlength=r_blocks)
    return int(loads.max())


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """Shape + row-map decisions of one bucket's tile layout, computed from
    the per-row edge counts ALONE — no edge data needed.

    This is the single source of truth for everything about a bucket's layout
    that does not depend on which concrete edges fill the slots: the
    out-of-core streaming partitioner (``partition_2d_streaming``) calls
    ``plan_tiles`` during its counting pass to pre-size the stacked packed
    buffers before any edge is placed, and ``prepare_tiles`` consumes the
    same plan to place edges — so the two paths cannot disagree on shapes,
    split chunking, or row placement. A natural row with ``count`` edges and
    ``k = n_chunks[row]`` virtual rows splits into even chunks whose sizes
    are fully determined by (count, k): chunk ``c`` holds the edges ``j``
    with ``j * k // count == c``, i.e. ``ceil((c+1)*count/k) -
    ceil(c*count/k)`` edges — what ``virt_counts`` records.
    """

    r_blocks: int  # row blocks (>= num_rows/vb when virtual rows need room)
    t_tiles: int  # max real edge tiles over the row blocks
    t_tiles_unsplit: int  # T without splitting (== t_tiles when no split)
    num_split_rows: int  # natural rows split into > 1 virtual rows
    s_max: int  # split-map width: max virtual rows per natural row (>= 1)
    # exactly one of row_pos / row_orig is set when the layout is non-trivial:
    row_pos: np.ndarray | None  # (num_rows,) natural row -> packed position
    row_orig: np.ndarray | None  # (r_blocks * vb,) packed position -> row
    # split-mode edge-placement inputs (None when no row split):
    n_chunks: np.ndarray | None  # (num_rows,) virtual rows per natural row
    virt_base: np.ndarray | None  # (num_rows,) first virtual-row id per row
    virt_pos: np.ndarray | None  # (num_virtual,) virtual row -> packed pos


def plan_tiles(
    row_counts: np.ndarray,  # (num_rows,) real edges per natural row
    *,
    num_rows: int,
    vb: int,
    eb: int,
    balance_rows: bool = False,
    split_threshold: int | None = None,
) -> TilePlan:
    """Decide one bucket's tile-layout shape from row counts alone.

    Mirrors (and is consumed by) ``prepare_tiles``: the split decision, even
    chunking, LPT placement, and the resulting (R, T) are pure functions of
    the per-row counts, so a streaming builder can size its output buffers in
    a counting pass and the edge-placement pass is guaranteed to fit."""
    assert num_rows % vb == 0, (num_rows, vb)
    r_base = num_rows // vb
    row_counts = np.asarray(row_counts, dtype=np.int64)
    thr = max(int(split_threshold), 1) if split_threshold is not None else None
    do_split = (
        balance_rows and thr is not None and bool((row_counts > thr).any())
    )
    if do_split:
        n_chunks = np.maximum(1, -(-row_counts // thr)).astype(np.int64)
        num_split_rows = int((n_chunks > 1).sum())
        num_virtual = int(n_chunks.sum())
        r_blocks = max(r_base, -(-num_virtual // vb))
        t_unsplit = max(1, -(-_lpt_max_load(row_counts, r_base, vb) // eb))
        virt_base = np.cumsum(n_chunks) - n_chunks
        virt_orig = np.repeat(np.arange(num_rows, dtype=np.int64), n_chunks)
        # even-chunk sizes from (count, k) alone: chunk c of a row with count
        # edges and k chunks holds ceil((c+1)*count/k) - ceil(c*count/k).
        vidx = np.arange(num_virtual, dtype=np.int64) - virt_base[virt_orig]
        cnt, k = row_counts[virt_orig], n_chunks[virt_orig]
        virt_counts = (-(-((vidx + 1) * cnt) // k)) - (-(-(vidx * cnt) // k))
        pos_v = _balance_row_blocks(virt_counts, r_blocks, vb)
        row_orig = np.full(r_blocks * vb, -1, dtype=np.int32)
        row_orig[pos_v] = virt_orig
        loads = np.bincount(
            pos_v // vb, weights=virt_counts.astype(np.float64),
            minlength=r_blocks,
        )
        t_tiles = max(1, int(-(-int(loads.max()) // eb)))
        return TilePlan(
            r_blocks=r_blocks, t_tiles=t_tiles, t_tiles_unsplit=t_unsplit,
            num_split_rows=num_split_rows, s_max=int(n_chunks.max()),
            row_pos=None, row_orig=row_orig, n_chunks=n_chunks,
            virt_base=virt_base, virt_pos=pos_v,
        )
    if balance_rows and r_base > 1:
        row_pos = _balance_row_blocks(row_counts, r_base, vb)
        loads = np.bincount(
            row_pos // vb, weights=row_counts.astype(np.float64),
            minlength=r_base,
        )
        t_tiles = max(1, int(-(-int(loads.max()) // eb)))
    else:
        row_pos = None
        loads = row_counts.reshape(r_base, vb).sum(axis=1)
        t_tiles = max(1, int(-(-int(loads.max()) // eb))) if loads.size else 1
    return TilePlan(
        r_blocks=r_base, t_tiles=t_tiles, t_tiles_unsplit=t_tiles,
        num_split_rows=0, s_max=1, row_pos=row_pos, row_orig=None,
        n_chunks=None, virt_base=None, virt_pos=None,
    )


def plan_push_tiles(
    src_counts: np.ndarray,  # (gathered_size,) real edges per gathered source
    *,
    gathered_size: int,
    block_sources: int,
    eb: int,
) -> tuple[int, int]:
    """Push-stream shape from per-source counts alone: ``(B, Tp)`` matching
    what ``prepare_push_tiles`` will produce for the same bucket."""
    counts = push_block_edges(src_counts, gathered_size=gathered_size,
                              block_sources=block_sources)
    return counts.shape[-1], max(1, int(-(-int(counts.max()) // eb)))


def push_block_edges(
    src_counts: np.ndarray, *, gathered_size: int, block_sources: int
) -> np.ndarray:
    """Real edges per source block of ``block_sources`` gathered sources,
    from per-source counts on the last axis (``(..., gathered_size)`` ->
    ``(..., B)``), the last block zero-padded."""
    n_blocks = max(1, -(-gathered_size // block_sources))
    src_counts = np.asarray(src_counts, dtype=np.int64)
    pad = n_blocks * block_sources - src_counts.shape[-1]
    if pad:
        src_counts = np.concatenate(
            [src_counts, np.zeros(src_counts.shape[:-1] + (pad,), np.int64)], axis=-1
        )
    return src_counts.reshape(src_counts.shape[:-1] + (n_blocks, block_sources)).sum(axis=-1)


def auto_push_block(total_edges: int, p: int, l: int, gathered: int, peb: int) -> int:
    """The partitioner's ``push_block=None`` rule: about two full push tiles
    of the average bucket degree per block, 32-aligned, at most one gathered
    block."""
    avg_deg = total_edges / max(p * l, 1) / max(gathered, 1)
    want = 2.0 * peb / max(avg_deg, 1e-9)
    block = 32 * max(1, int(round(want / 32.0)))
    return min(block, 32 * ((gathered + 31) // 32))


def prepare_tiles(
    src_gidx: np.ndarray,  # (E,) int32
    dst_lidx: np.ndarray,  # (E,) int32, sorted ascending
    valid: np.ndarray,  # (E,) bool
    num_rows: int,
    vb: int,
    eb: int,
    weights: np.ndarray | None = None,
    *,
    balance_rows: bool = False,
    split_threshold: int | None = None,
    plan: TilePlan | None = None,
) -> TileLayout:
    """Bin one (dst-sorted) edge bucket into (R, T, Eb) row-block tiles.

    ``split_threshold`` (requires ``balance_rows``: virtual rows only help
    when the LPT packer can spread them) caps the edge count of any single
    kernel-output row: a natural row with more edges is split into
    ``ceil(count / threshold)`` even chunks, each a virtual row the packer
    places independently — R grows past ``num_rows / vb`` when the virtual
    rows need the slots. The returned layout then carries ``row_orig`` and
    the caller must apply the second-level combine (``combine_split_rows``).
    When no row exceeds the threshold the output is byte-for-byte identical
    to the unsplit layout.

    ``plan``: a ``TilePlan`` previously computed by ``plan_tiles`` for THIS
    bucket's row counts under the same (vb, eb, balance_rows,
    split_threshold) — skips the redundant re-plan (the LPT pass is the
    expensive part at large vpc). The caller owns the consistency; the
    t_tiles assertion below catches a mismatched plan.
    """
    assert num_rows % vb == 0, (num_rows, vb)
    src_gidx = np.asarray(src_gidx)
    dst_lidx = np.asarray(dst_lidx)
    valid = np.asarray(valid)

    keep = valid
    orig_idx = np.nonzero(keep)[0]
    src_r = src_gidx[keep]
    dst_r = dst_lidx[keep]
    w_r = weights[keep] if weights is not None else None
    row_counts = np.bincount(dst_r, minlength=num_rows)
    if plan is None:
        plan = plan_tiles(
            row_counts, num_rows=num_rows, vb=vb, eb=eb,
            balance_rows=balance_rows, split_threshold=split_threshold,
        )
    r_blocks = plan.r_blocks
    if plan.row_orig is not None:
        # level-1 layout over VIRTUAL rows: chunk c of natural row v holds
        # the edges j with j * n_chunks[v] // count[v] == c (even split, so
        # chunk sizes differ by at most 1 and never exceed the threshold).
        row_starts = np.cumsum(row_counts) - row_counts
        pos_in_row = np.arange(dst_r.shape[0], dtype=np.int64) - row_starts[dst_r]
        chunk = pos_in_row * plan.n_chunks[dst_r] // np.maximum(row_counts[dst_r], 1)
        vrow = plan.virt_base[dst_r] + chunk
        pdst = plan.virt_pos[vrow]
        order = np.argsort(pdst // vb, kind="stable")
        src_r, pdst, orig_idx = src_r[order], pdst[order], orig_idx[order]
        if w_r is not None:
            w_r = w_r[order]
    elif plan.row_pos is not None:
        pdst = plan.row_pos[dst_r]
        # packed positions are not sorted; regroup by block, keeping the
        # original (dst-sorted) edge order inside each block (stable).
        order = np.argsort(pdst // vb, kind="stable")
        src_r, pdst, orig_idx = src_r[order], pdst[order], orig_idx[order]
        if w_r is not None:
            w_r = w_r[order]
    else:
        pdst = dst_r
    block = pdst // vb
    counts = np.bincount(block, minlength=r_blocks)
    t_tiles = max(1, int(-(-counts.max() // eb))) if counts.size else 1
    assert t_tiles == plan.t_tiles, (t_tiles, plan.t_tiles)
    src_t = np.zeros((r_blocks, t_tiles, eb), dtype=np.int32)
    dst_t = np.zeros((r_blocks, t_tiles, eb), dtype=np.int32)
    val_t = np.zeros((r_blocks, t_tiles, eb), dtype=bool)
    gat_t = np.zeros((r_blocks, t_tiles, eb), dtype=np.int64)
    w_t = np.zeros((r_blocks, t_tiles, eb), dtype=np.float32) if w_r is not None else None
    starts = np.zeros(r_blocks + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    for r in range(r_blocks):
        s, e = int(starts[r]), int(starts[r + 1])
        n = e - s
        src_t[r].reshape(-1)[:n] = src_r[s:e]
        dst_t[r].reshape(-1)[:n] = pdst[s:e] - r * vb
        val_t[r].reshape(-1)[:n] = True
        gat_t[r].reshape(-1)[:n] = orig_idx[s:e]
        if w_t is not None:
            w_t[r].reshape(-1)[:n] = w_r[s:e]
    return TileLayout(
        src=src_t, dstb=dst_t, valid=val_t, weights=w_t, vb=vb,
        num_rows=num_rows, gather_idx=gat_t, row_pos=plan.row_pos,
        tile_counts=(-(-counts // eb)).astype(np.int32),
        row_orig=plan.row_orig, num_split_rows=plan.num_split_rows,
        t_tiles_unsplit=plan.t_tiles_unsplit,
    )


def split_map_from_row_orig(row_orig: np.ndarray, num_rows: int) -> np.ndarray:
    """Invert a packed-position -> natural-row map into the gather form the
    second-level combine consumes: ``(num_rows, S_max)`` packed positions per
    natural row, padded with -1. Every natural row owns at least one virtual
    row (empty rows get one whose kernel output is the reduce identity), so
    column 0 is always a real position."""
    row_orig = np.asarray(row_orig)
    pos = np.nonzero(row_orig >= 0)[0]
    orig = row_orig[pos].astype(np.int64)
    order = np.argsort(orig, kind="stable")
    orig_s, pos_s = orig[order], pos[order]
    counts = np.bincount(orig_s, minlength=num_rows)
    assert counts.min() >= 1, "every natural row must own >= 1 virtual row"
    s_max = int(counts.max())
    starts = np.cumsum(counts) - counts
    rank = np.arange(pos_s.shape[0], dtype=np.int64) - starts[orig_s]
    out = np.full((num_rows, s_max), -1, dtype=np.int32)
    out[orig_s, rank] = pos_s
    return out


def combine_split_rows(
    reduced: torch.Tensor,  # (..., P[, L]) level-1 kernel output, packed rows
    split_map: torch.Tensor,  # (..., num_rows, S) int64 packed positions, -1 = pad
    *,
    kind: str,  # 'min' | 'sum' | 'or' — the problem's reduce UDF
    identity: float,  # the SAME problem's identity (INF for min, 0 for sum/or)
) -> torch.Tensor:
    """Level-2 reduce: fold virtual-row partials into natural rows.

    Must use the problem's own reduce op and identity: padding entries (-1)
    contribute ``identity``, so a min problem sees INF (never 0) and a sum
    problem sees exactly 0.0. Gather-based, so min problems stay
    bit-identical to the oracle: min over partial mins == total min. An
    int32 ``reduced`` holds uint32 bit patterns (``core.u32``) and is folded
    with the unsigned min or the word OR.

    A lane-batched ``reduced`` (..., P, L) has one more axis than
    ``split_map``: the fold is over the packed-row axis, and one gather of
    the row index serves all L lanes.
    """
    *lead, v, s = split_map.shape
    lanes = reduced.dim() == split_map.dim()
    idx = split_map.clamp(min=0).reshape(*lead, v * s)
    pad = split_map >= 0
    if lanes:
        k = reduced.shape[-1]
        idx = idx.unsqueeze(-1).expand(*lead, v * s, k)
        vals = torch.gather(reduced, -2, idx).reshape(*lead, v, s, k)
        pad = pad.unsqueeze(-1)
    else:
        vals = torch.gather(reduced, -1, idx).reshape(split_map.shape)
    fold = -2 if lanes else -1
    if reduced.dtype == torch.int32:
        if kind == "or":
            out = torch.zeros_like(vals.select(fold, 0))
            for j in range(s):  # S_max is small: an unrolled word-OR fold
                out = out | torch.where(pad.select(fold, j), vals.select(fold, j), 0)
            return out
        if kind != "min":
            raise ValueError(f"uint32 payloads reduce with 'min' or 'or', got {kind!r}")
        ident = int(identity) & u32.U32_MAX
        wide = torch.where(pad, u32.widen(vals), ident)
        return u32.narrow(wide.amin(dim=fold))
    vals = torch.where(pad, vals, identity)
    if kind == "min":
        return vals.amin(dim=fold)
    return vals.sum(dim=fold)


def layout_to(tiles: TileLayout, device) -> TileLayout:
    """The layout with what ``gather_reduce`` reads (src, dstb, valid,
    weights, row_pos) as tensors on ``device``, so that repeated calls
    upload nothing; ``row_orig`` stays on the host."""
    def on(a, dtype=None):
        if a is None:
            return None
        t = torch.as_tensor(np.ascontiguousarray(a) if isinstance(a, np.ndarray) else a,
                            device=device)
        return t.to(dtype) if dtype is not None else t

    return dataclasses.replace(
        tiles, src=on(tiles.src, torch.int32), dstb=on(tiles.dstb, torch.int32),
        valid=on(tiles.valid, torch.bool), weights=on(tiles.weights, torch.float32),
        row_pos=on(tiles.row_pos, torch.int64),
    )


def gather_reduce(
    payload: torch.Tensor,  # (G,) gathered block; int32 = uint32 bits
    tiles: TileLayout,
    *,
    kind: str = "min",
    edge_op: str = "none",
    identity: float = 0.0,
    use_reference: bool = False,
) -> torch.Tensor:
    """Run the accumulator over one (core, phase) bucket -> (num_rows,).

    The kernel (``bucket.gather_reduce_bucket``: the Hopper kernel on the
    card, its plain version on the CPU) reduces PACKED rows, R * vb of them,
    which with hub-row splitting may be more than the natural ``num_rows``;
    the level-2 fold (``combine_split_rows``) or the row-packing undo brings
    them back. ``use_reference`` runs the plain segment form instead."""
    from repro_torch.kernels.csr_gather_reduce.bucket import gather_reduce_bucket
    from repro_torch.kernels.csr_gather_reduce.ref import gather_reduce_reference

    t = layout_to(tiles, payload.device)
    r_blocks = t.src.shape[0]
    packed_rows = r_blocks * t.vb
    weights = t.weights
    if edge_op == "add" and weights is None:
        # the kernel treats missing weights as unit weights; the reference
        # skips the add when weights is None, so make units explicit
        weights = torch.ones(t.src.shape, dtype=torch.float32, device=payload.device)
    if use_reference:
        base = torch.arange(r_blocks, device=payload.device).view(-1, 1, 1) * t.vb
        out = gather_reduce_reference(
            payload, t.src.reshape(-1), (t.dstb + base).reshape(-1), t.valid.reshape(-1),
            packed_rows, kind=kind, identity=identity,
            weights=weights.reshape(-1) if edge_op == "add" else None,
        )
    else:
        out = gather_reduce_bucket(
            payload, t.src, t.dstb, t.valid, weights if edge_op == "add" else None,
            num_rows=packed_rows, vb=t.vb, kind=kind, edge_op=edge_op, identity=identity,
        )
    if t.row_orig is not None:  # level-2 reduce over virtual-row partials
        sm = split_map_from_row_orig(np.asarray(t.row_orig), t.num_rows)
        return combine_split_rows(out, torch.from_numpy(sm).to(payload.device, torch.int64),
                                  kind=kind, identity=identity)
    if t.row_pos is not None:  # undo degree-aware row packing
        return out[t.row_pos]
    return out


def segment_reduce_rows(
    contrib: torch.Tensor,  # (p, E) pre-mapped contributions (identity-padded)
    dst: torch.Tensor,  # (p, E) sorted local rows
    *,
    num_rows: int,
    kind: str,
    identity: float,
) -> torch.Tensor:
    """Reduce-only helper for already-materialized contributions: per core,
    the segment min or sum of ``contrib`` over ``dst`` into ``num_rows``
    rows -> (p, num_rows). The reference's public helper for model code
    (the engine routes through the fused kernel instead); plain torch, as
    the reference's has no Pallas kernel. Rows outside [0, num_rows) are
    dropped; an empty row of a min holds the dtype's largest value (+inf for
    floats), as ``jax.ops.segment_min`` gives, and of a sum 0. The sum adds
    in index order (``index_add``), ``jax.ops.segment_sum``'s order on the
    CPU. ``identity`` is kept for the reference's signature."""
    del identity
    if kind not in ("min", "sum"):
        raise ValueError(f"kind must be 'min' or 'sum', got {kind!r}")
    if contrib.shape != dst.shape or contrib.dim() != 2:
        raise ValueError(f"contrib {tuple(contrib.shape)} and dst {tuple(dst.shape)} must "
                         "be the same (p, E)")
    dt = contrib.dtype
    wide = dt == torch.uint32  # uint32 has no min or index_add on the CPU
    vals = contrib.to(torch.int64) if wide else contrib
    idx = dst.to(torch.int64)
    keep = (idx >= 0) & (idx < num_rows)
    rows = []
    for c in range(contrib.shape[0]):
        v, d = vals[c][keep[c]], idx[c][keep[c]]
        if kind == "sum":
            out = torch.zeros(num_rows, dtype=vals.dtype, device=vals.device).index_add_(0, d, v)
        else:
            top = (float("inf") if dt.is_floating_point else 0xFFFFFFFF if wide
                   else torch.iinfo(dt).max)
            out = torch.full((num_rows,), top, dtype=vals.dtype, device=vals.device)
            out = out.scatter_reduce(0, d, v, "amin", include_self=True)
        rows.append(out)
    out = torch.stack(rows)
    return out.to(torch.uint32) if wide else out
