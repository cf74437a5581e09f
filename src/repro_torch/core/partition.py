"""Two-dimensional graph partitioning (paper §III-C) + stride mapping.

Counterpart of ``repro.core.partition``: the in-memory build, the
out-of-core streaming build (``partition_2d_streaming``: two passes over a
replayable chunk stream, optionally into ``np.memmap`` files) and the delta
ingest of streamed edge insertions (``apply_edge_deltas``, which re-tiles
only the dirty (core, phase) buckets). Host numpy, a copy of the reference,
so every array is byte-identical to ``repro``'s for the same graph, config
and insertions. ``partition_edge_centric`` lays out the edge list of the
synchronous edge-centric baseline (``core.edge_centric``).

Dimension 1: the (padded) vertex set is split into ``p`` equal intervals
``I_q`` — one per graph core; core ``q`` owns all edges whose *destination*
lies in ``I_q`` (pull-based horizontal partitioning of the inverse edge set).

Dimension 2: each interval is split into ``l`` equal sub-intervals ``J`` of
``sub_size`` vertices — sized so a sub-interval's labels fit the label
scratch pad. Sub-partition ``S[i, m]`` holds edges with dst ∈ I_i and
src ∈ ∪_q J[q, m]; the ``p`` sub-intervals active at phase ``m`` form
meta-partition M_m.

Neighbor indices are rewritten at partition time so that a source vertex id
becomes a direct offset into the phase's gathered label block:
``gathered_idx = src_core * sub_size + (src mod sub_size)``.

On top of the (p, l, E_pad) bucket layout, ``partition_2d`` precomputes the
COMPRESSED edge stream the kernel consumes: every (core, phase) bucket is
binned into (R, T, Eb) row-block edge tiles (``prepare_tiles``) with
degree-aware LPT row packing and hub-row splitting, each slot's (src, dstb,
valid) triple is bit-packed into one int32 word (``pack_edge_words``), and
the words are stacked into one (p, l, R, T, Eb) array so one kernel launch
per phase runs all cores. Packed word format:

  src_bits=16 (when p * sub_size <= 2^16 and vb <= 2^15 — the common case):
      tile_word    = valid<<31 | dstb<<16 | src           4 index B/edge
  src_bits=32 (fallback for larger gathered blocks):
      tile_word    = src
      tile_word_hi = valid<<31 | dstb                     8 index B/edge

``tile_counts`` holds the per-(core, phase, row-block) count of REAL edge
tiles so the kernel never touches all-padding tiles.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core.graph import COOGraph

__all__ = [
    "PartitionConfig",
    "PartitionedGraph",
    "stride_permutation",
    "apply_permutation",
    "partition_2d",
    "coo_edge_chunks",
    "count_edge_stream",
    "partition_2d_streaming",
    "DeltaFlushReport",
    "bucket_coords",
    "apply_edge_deltas",
    "EdgeCentricPartition",
    "partition_edge_centric",
]


@dataclasses.dataclass(frozen=True)
class PartitionConfig:
    p: int  # graph cores == memory channels == mesh devices
    l: int  # sub-intervals per interval (scratch-pad phases)
    lane: int = 8  # sub_size alignment (TPU lane quantum; 128 on real HW)
    edge_pad: int = 8  # per-bucket edge-count alignment
    stride: Optional[int] = None  # stride mapping (paper uses 100); None = off
    scratch_size: Optional[int] = None  # if set, l is derived: labels per core phase
    # fused-kernel tile layout (consumed by EngineOptions(backend='kernel')):
    build_tiles: bool = True  # False skips the host-side binning (xla-only use)
    tile_vb: Optional[int] = None  # row-block height; None = sub_size (R = l)
    tile_eb: int = 128  # edge-tile width (lane quantum on real HW)
    degree_aware_tiles: bool = True  # LPT row packing (see prepare_tiles)
    pack_src_bits: Optional[int] = None  # force 16/32-bit regime; None = auto
    # hub-row splitting (two-level reduce): the max edge count of one kernel
    # row. 'auto' = per bucket max(tile_eb, ceil(E_bucket / R)) — no virtual
    # row exceeds the mean row-block load, floored at one tile width. An int
    # fixes the cap for every bucket. None disables splitting entirely (the
    # pre-split layout is preserved byte-for-byte). Requires
    # degree_aware_tiles: virtual rows only pay off when the LPT packer can
    # spread them across row blocks.
    split_threshold: Union[str, int, None] = "auto"  # 'auto' | int | None
    # push (scatter) direction: a second CSC-style stream of the SAME edges
    # binned by source block so a narrow frontier streams only its own
    # out-edges (Beamer direction-optimizing traversal, docs/tile_layout.md
    # §9). push_block must be a multiple of 32 (frontier-word alignment).
    # None auto-sizes a block to hold ~2 full edge tiles of the bucket's
    # average degree: fewer, denser blocks mean a smaller (B, Tp) scatter
    # grid and less cross-block T padding, while frontier selectivity is
    # preserved by the per-TILE coverage words (edges are source-sorted
    # within a block, so each tile covers a narrow source range).
    build_push: bool = True  # False skips the push stream (pull-only layout)
    push_block: Optional[int] = None  # gathered sources per push block
    # push edge-tile width; None = tile_eb. The scatter accumulator is the
    # whole per-core row (no row blocking), so wider push tiles shrink the
    # (B, Tp) grid without the load-balance concerns the pull layout's
    # row-blocked tiles have — on a narrow frontier the grid-step count,
    # not the per-tile edge work, is what the direction switch is buying.
    push_eb: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class PartitionedGraph:
    """Static-shape 2-D partitioned inverse-CSR-equivalent edge layout.

    Edge arrays are laid out (p, l, E_pad): bucket [i, m] is sub-partition
    S[i, m] sorted by local destination. ``src_gidx`` indexes the phase-m
    gathered block (size p * sub_size); ``dst_lidx`` indexes core i's local
    label shard (size l * sub_size).
    """

    p: int
    l: int
    sub_size: int
    num_vertices: int  # real V
    num_edges: int  # real E
    src_gidx: np.ndarray  # (p, l, E_pad) int32
    dst_lidx: np.ndarray  # (p, l, E_pad) int32
    valid: np.ndarray  # (p, l, E_pad) bool
    weights: Optional[np.ndarray]  # (p, l, E_pad) float32 or None
    perm: Optional[np.ndarray]  # old -> new vertex id (stride mapping), or None
    inv_perm: Optional[np.ndarray]
    bucket_sizes: np.ndarray  # (p, l) int64 — real edges per sub-partition
    # stacked fused-kernel COMPRESSED edge stream (one TileLayout per bucket,
    # bit-packed, uniform (R, T) so all p cores of a phase launch as one
    # kernel launch — see module docstring for the word format):
    tile_word: Optional[np.ndarray] = None  # (p, l, R, T, Eb) int32 packed
    tile_word_hi: Optional[np.ndarray] = None  # (p, l, R, T, Eb) int32 (32-bit regime)
    tile_counts: Optional[np.ndarray] = None  # (p, l, R) int32 real tiles per block
    tile_weights: Optional[np.ndarray] = None  # (p, l, R, T, Eb) f32 or None
    tile_row_pos: Optional[np.ndarray] = None  # (p, l, Vl) int32 or None
    # per-tile source-coverage bitmaps (frontier-aware dynamic skipping):
    # bit j of tile (i, m, r, t)'s word set iff the tile reads a source in
    # frontier word j of phase m's gathered block. Wc = ceil(p * Ws / 32)
    # with Ws = ceil(sub_size / 32) — see core/frontier_words.py and
    # docs/tile_layout.md §7 for the shared layout contract.
    tile_coverage: Optional[np.ndarray] = None  # (p, l, R, T, Wc) uint32
    tile_vb: int = 0  # row-block height (0 = tiles not built)
    src_bits: int = 0  # packed-word regime: 16 or 32 (0 = tiles not built)
    # hub-row splitting (two-level reduce). When any bucket split a row,
    # tile_row_pos is None and these take over; R may exceed Vl / vb:
    # packed kernel-output position -> natural row (-1 = spare, identity):
    tile_row_orig: Optional[np.ndarray] = None  # (p, l, R * vb) int32
    # gather form of the same map, what the engine's level-2 combine reads:
    tile_split_map: Optional[np.ndarray] = None  # (p, l, Vl, S_max) int32, -1 pad
    split_rows: int = 0  # natural (bucket, row) pairs split into > 1 virtual rows
    t_max_unsplit: int = 0  # T the stacked stream would need without splitting
    # push (scatter) stream: the SAME edge set, re-binned by SOURCE block
    # (B = ceil(gathered_size / push_block) blocks of push_block gathered
    # sources each) so a narrow frontier activates only the blocks that
    # contain frontier sources. Same bit-packed word format, but the dstb
    # field carries the FULL local destination row in [0, Vl) — the scatter
    # kernel's accumulator is the whole per-core label row. push_coverage is
    # tile_coverage_words over the push stream; ANDed against the frontier
    # it IS the push-mode tile scheduler (docs/tile_layout.md §9).
    push_word: Optional[np.ndarray] = None  # (p, l, B, Tp, Eb) int32 packed
    push_word_hi: Optional[np.ndarray] = None  # (p, l, B, Tp, Eb) | None
    push_counts: Optional[np.ndarray] = None  # (p, l, B) int32 real tiles
    push_weights: Optional[np.ndarray] = None  # (p, l, B, Tp, Eb) f32 | None
    push_coverage: Optional[np.ndarray] = None  # (p, l, B, Tp, Wc) uint32
    push_src_bits: int = 0  # push packed-word regime (0 = push not built)
    push_block: int = 0  # gathered sources per push block (0 = not built)
    # the config that built this layout — carried so delta ingestion
    # (``apply_edge_deltas``) can re-tile dirty buckets under the exact same
    # layout rules (thresholds, tile widths, push sizing) without the caller
    # re-supplying them. None on hand-built partitions: delta ingest refuses.
    config: Optional[PartitionConfig] = None
    # device copies of the arrays above, filled on first use by
    # ``device_array`` and shared by every engine run on this graph
    # (not an init field: every new object, ``dataclasses.replace`` included,
    # starts with an empty cache, so a delta-flushed partition never sees the
    # device copies of the arrays it replaced)
    device_cache: dict = dataclasses.field(
        default_factory=dict, init=False, compare=False, repr=False
    )

    @classmethod
    def from_numpy(cls, fields: dict) -> "PartitionedGraph":
        """State carry-over: build the port's graph from the fields of a
        reference ``repro.core.partition.PartitionedGraph`` (numpy arrays and
        ints, keyed by field name), so both engines run on the very same
        arrays. ``config`` may be any dataclass or dict with the
        ``PartitionConfig`` fields."""
        names = {f.name for f in dataclasses.fields(cls)} - {"device_cache"}
        unknown = set(fields) - names
        if unknown:
            raise ValueError(f"unknown PartitionedGraph fields: {sorted(unknown)}")
        kw = {
            k: (np.asarray(v) if hasattr(v, "__array__") else v)
            for k, v in fields.items()
        }
        cfg = kw.get("config")
        if cfg is not None and not isinstance(cfg, PartitionConfig):
            cfg = cfg if isinstance(cfg, dict) else dataclasses.asdict(cfg)
            kw["config"] = PartitionConfig(**cfg)
        return cls(**kw)

    def device_array(self, name: str, device, *, dtype=None, phase_major=False, core=None):
        """Field ``name`` as a torch tensor on ``device`` (None stays None),
        uploaded once and cached. ``phase_major`` moves the phase axis (axis
        1) to the front, so the slice a phase launch reads is contiguous;
        ``dtype`` converts first (index arrays become int64 for torch).
        ``core`` keeps only that core's slice ``[core:core+1]`` of the core
        axis (one rank of the multi-channel engine; only the slice is read,
        so a memory-mapped field stays on disk). uint32 fields (the coverage
        words) arrive as int32 tensors holding the same bits (``core.u32``)."""
        arr = getattr(self, name)
        if arr is None:
            return None
        key = (name, str(torch.device(device)), dtype, phase_major, core)
        hit = self.device_cache.get(key)
        if hit is None:
            if core is not None:
                arr = arr[core : core + 1]
            # a read-only (memory-mapped) field is copied: torch needs a writable array
            arr = np.ascontiguousarray(arr) if arr.flags.writeable else np.array(arr)
            t = torch.from_numpy(arr.view(np.int32) if arr.dtype == np.uint32 else arr)
            if phase_major:
                t = t.transpose(0, 1)
            hit = t.to(device=device, dtype=dtype).contiguous()
            self.device_cache[key] = hit
        return hit

    @property
    def vertices_per_core(self) -> int:
        return self.l * self.sub_size

    @property
    def padded_vertices(self) -> int:
        return self.p * self.l * self.sub_size

    @property
    def gathered_size(self) -> int:
        return self.p * self.sub_size

    @property
    def edge_pad(self) -> int:
        return int(self.src_gidx.shape[-1])

    @property
    def padding_ratio(self) -> float:
        """Padded-slot fraction — the TPU cost of load imbalance (paper §IV-A:
        'imbalanced partitions lead to a lot of idle time')."""
        total_slots = self.p * self.l * self.edge_pad
        return 1.0 - float(self.bucket_sizes.sum()) / max(total_slots, 1)

    @property
    def imbalance(self) -> float:
        """max/mean real edges over buckets (1.0 = perfectly balanced)."""
        mean = self.bucket_sizes.mean()
        return float(self.bucket_sizes.max() / mean) if mean > 0 else 1.0

    @property
    def tile_padding_ratio(self) -> float:
        """Padded-slot fraction of the fused-kernel tile layout — what
        degree-aware row packing minimizes (hub rows no longer set T for
        every row block). Every real edge occupies exactly one tile slot, so
        this no longer needs a materialized valid array."""
        if self.tile_word is None:
            return 0.0
        return 1.0 - float(self.bucket_sizes.sum()) / max(self.tile_word.size, 1)

    @property
    def stream_bytes_per_edge(self) -> float:
        """Index-stream bytes per PULL edge slot of the compressed layout: 4
        in the 16-bit packed regime (8 in the 32-bit fallback) vs 9
        uncompressed (int32 src + int32 dstb + bool valid). When the push
        (scatter) stream is built it stores the same edges a second time, so
        its packed words are charged here too — amortized over the pull
        slots so records stay comparable across layouts. Payload weights,
        when present, add 4 more on both layouts and are excluded here."""
        if self.tile_word is None:
            return 0.0
        pull = 4.0 * (1 if self.tile_word_hi is None else 2)
        if self.push_word is None:
            return pull
        push = 4.0 * (1 if self.push_word_hi is None else 2)
        return pull + push * self.push_word.size / max(self.tile_word.size, 1)

    @property
    def skipped_tile_fraction(self) -> float:
        """Fraction of (core, phase, row-block) edge tiles the kernel's
        scalar-prefetched tile-count early-out never streams or decodes."""
        if self.tile_counts is None or self.tile_word is None:
            return 0.0
        t_max = self.tile_word.shape[3]
        total = self.tile_counts.size * t_max
        return 1.0 - float(self.tile_counts.sum()) / max(total, 1)

    @property
    def packed_rows_per_core(self) -> int:
        """Kernel-output rows per core: R * vb. Equals vertices_per_core
        unless hub-row splitting grew R to make room for virtual rows."""
        if self.tile_word is None:
            return self.vertices_per_core
        return int(self.tile_word.shape[2]) * self.tile_vb

    @property
    def split_row_fraction(self) -> float:
        """Fraction of natural (core, phase, row) slots hub-row splitting
        broke into > 1 virtual rows (0.0 when splitting is off or no row
        crossed the threshold)."""
        total = self.p * self.l * self.vertices_per_core
        return self.split_rows / max(total, 1)

    def channel_arrays(self, problem=None) -> dict:
        """The per-channel COMPRESSED edge stream, keyed for the engines.

        Every array's leading axis is the core axis — one graph core == one
        memory channel == one mesh device (docs/distributed.md) — and
        ``stack_packed_tiles`` already padded the per-bucket ragged (R, T)
        to the max over ALL (core, phase) buckets, so slice ``[q]`` is core
        q's complete, uniformly-shaped channel shard: the distributed engine
        ``NamedSharding``-places these over the ``graph`` mesh axis and each
        device streams exactly its own packed words + tile counts (never the
        flat (l, E_pad) src/dst/valid arrays). Keys match the engine's packed
        edge-constant dict (``word``/``word_hi``/``counts``/``w``/
        ``row_pos``/``split_map``; absent components are None).

        ``problem``: when given, the weight stream is dropped unless the
        problem's map UDF consumes it (``edge_op == 'add'``) — the kernel
        then adds unit weight in registers. This is THE weight-streaming
        rule; both engines get it from here so they cannot drift. The
        coverage bitmaps follow the same rule: they are dropped unless the
        problem's reduce is ``min`` — frontier skipping is only sound for
        monotone min problems (a skipped tile's sources re-contribute values
        already merged into the labels), while a sum reduce needs EVERY
        contribution every iteration, so PageRank streams dense.
        """
        if self.tile_word is None:
            raise ValueError(
                "packed edge stream not built; re-partition with "
                "PartitionConfig(build_tiles=True)"
            )
        arrs = {
            "word": self.tile_word,  # (p, l, R, T, Eb) int32 packed
            "word_hi": self.tile_word_hi,  # (p, l, R, T, Eb) | None
            "counts": self.tile_counts,  # (p, l, R)
            "w": self.tile_weights,  # (p, l, R, T, Eb) f32 | None
            "row_pos": self.tile_row_pos,  # (p, l, Vl) | None
            "split_map": self.tile_split_map,  # (p, l, Vl, S_max) | None
            "coverage": self.tile_coverage,  # (p, l, R, T, Wc) u32 | None
            "push_word": self.push_word,  # (p, l, B, Tp, Eb) | None
            "push_word_hi": self.push_word_hi,  # (p, l, B, Tp, Eb) | None
            "push_counts": self.push_counts,  # (p, l, B) | None
            "push_w": self.push_weights,  # (p, l, B, Tp, Eb) | None
            "push_coverage": self.push_coverage,  # (p, l, B, Tp, Wc) | None
        }
        if problem is not None and problem.edge_op != "add":
            arrs["w"] = None
            arrs["push_w"] = None
        # frontier coverage is only sound for monotone reduces: min and the
        # packed multi-source-BFS word OR. Sum problems must stay dense.
        # The entire push stream follows the same rule — scattering only the
        # frontier blocks' out-edges relies on skipped contributions being
        # already merged, which only holds for idempotent monotone reduces
        # (sum needs every contribution every iteration: push stays off).
        if problem is not None and problem.reduce_kind not in ("min", "or"):
            arrs["coverage"] = None
            for k in (
                "push_word", "push_word_hi", "push_counts",
                "push_w", "push_coverage",
            ):
                arrs[k] = None
        return arrs

    @property
    def coverage_bytes_per_edge(self) -> float:
        """Index-stream overhead of the coverage metadata, amortized per edge
        slot: Wc words per (Eb-slot) tile — e.g. 1/32 B/edge at Eb=128,
        Wc=1 — vs the 4-8 B/edge packed words it lets the engine skip. Push
        coverage words, when built, are counted too (same denominator)."""
        if self.tile_coverage is None or self.tile_word is None:
            return 0.0
        cov = self.tile_coverage.size
        if self.push_coverage is not None:
            cov += self.push_coverage.size
        return 4.0 * cov / max(self.tile_word.size, 1)

    @property
    def t_max_reduction(self) -> float:
        """Stacked-stream T_max as a fraction of what the UNSPLIT layout
        would need (the single fattest row block): 1.0 = splitting off or
        no effect; the acceptance target on star-like graphs is <= 0.5."""
        if self.tile_word is None or self.t_max_unsplit <= 0:
            return 1.0
        return float(self.tile_word.shape[3]) / float(self.t_max_unsplit)

    def in_neighbors(self, v: int) -> np.ndarray:
        """Decode vertex ``v``'s in-neighbors straight from the resident flat
        bucket layout (host-side, no engine run) — the serving router's
        "neighbors-of" path. All of v's in-edges live in core ``v // vpc``
        (dim-1 ownership), one slice per phase; the gathered index is
        inverted back to a global source id and the stride permutation is
        undone. Order is the bucket stream order (phase-major, then the
        bucket's dst-sorted order), which is deterministic for a given
        partition — and bit-identical between an incrementally flushed
        partition and a cold repartition of the same final edge list."""
        if not 0 <= int(v) < self.num_vertices:
            raise ValueError(f"vertex {v} out of range [0, {self.num_vertices})")
        vv = int(self.perm[int(v)]) if self.perm is not None else int(v)
        vpc, sub = self.vertices_per_core, self.sub_size
        i, lidx = vv // vpc, vv % vpc
        out = []
        for m in range(self.l):
            sel = self.valid[i, m] & (self.dst_lidx[i, m] == lidx)
            g = self.src_gidx[i, m][sel].astype(np.int64)
            out.append((g // sub) * vpc + m * sub + (g % sub))
        srcs = np.concatenate(out) if out else np.zeros(0, np.int64)
        if self.inv_perm is not None:
            srcs = self.inv_perm[srcs]
        return srcs.astype(np.int64)

    def memory_report(self) -> dict:
        """Byte accounting of the resident layout, field by field.

        ``device`` covers the arrays the engines ship to the accelerator (the
        packed edge/coverage streams plus counts and row maps); ``host_flat``
        covers the flat (p, l, E_pad) bucket arrays that stay host-side for
        delta ingestion and serving. ``device_bytes_per_edge`` is the
        footprint metric the bounded-memory acceptance checks compare peak
        build RSS against (the packed stream IS the final partition
        footprint; the flat arrays are reported separately because a
        memmap-backed build keeps them on disk)."""
        device_fields = (
            "tile_word", "tile_word_hi", "tile_counts", "tile_weights",
            "tile_coverage", "tile_row_pos", "tile_row_orig",
            "tile_split_map", "push_word", "push_word_hi", "push_counts",
            "push_weights", "push_coverage",
        )
        flat_fields = ("src_gidx", "dst_lidx", "valid", "weights")
        device = {
            name: int(getattr(self, name).nbytes)
            for name in device_fields
            if getattr(self, name) is not None
        }
        host_flat = {
            name: int(getattr(self, name).nbytes)
            for name in flat_fields
            if getattr(self, name) is not None
        }
        device_total = sum(device.values())
        flat_total = sum(host_flat.values())
        e = max(self.num_edges, 1)
        return {
            "device": device,
            "host_flat": host_flat,
            "device_total_bytes": device_total,
            "host_flat_total_bytes": flat_total,
            "total_bytes": device_total + flat_total,
            "device_bytes_per_edge": device_total / e,
            "bytes_per_edge": (device_total + flat_total) / e,
        }


def stride_permutation(num_vertices: int, stride: int = 100) -> np.ndarray:
    """Paper §III-C stride mapping: new order v0, v100, v200, ..., v1, v101, ...

    Returns ``perm`` with ``perm[old_id] = new_id``.
    """
    order = np.lexsort(
        (np.arange(num_vertices) // stride, np.arange(num_vertices) % stride)
    )
    # order[k] = old id at new position k  ->  invert
    perm = np.empty(num_vertices, dtype=np.int64)
    perm[order] = np.arange(num_vertices, dtype=np.int64)
    return perm


def apply_permutation(g: COOGraph, perm: np.ndarray) -> COOGraph:
    return COOGraph(
        src=perm[g.src].astype(np.uint32),
        dst=perm[g.dst].astype(np.uint32),
        num_vertices=g.num_vertices,
        weights=g.weights,
    )


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _resolve_dims(num_vertices: int, cfg: PartitionConfig) -> tuple[int, int, int, int]:
    """Resolve (p, l, sub_size, vpc) under cfg's scratch/lane rules.

    (l derivation from scratch capacity, lane rounding of sub_size)."""
    p, l = cfg.p, cfg.l
    if cfg.scratch_size is not None:
        # derive l from scratch capacity (paper: sub-interval fits scratch pad)
        per_core = _round_up(-(-num_vertices // p), cfg.lane)
        l = max(1, -(-per_core // cfg.scratch_size))
    sub_size = _round_up(-(-num_vertices // (p * l)), cfg.lane)
    return p, l, sub_size, l * sub_size


def partition_2d(g: COOGraph, cfg: PartitionConfig) -> PartitionedGraph:
    """Partition the *processing* edge set (u -> v means "v pulls from u").

    ``g`` must already be the edge set in pull orientation (for BFS/WCC/SSSP/PR
    on directed input, pass the original COO: dst pulls from src along inverse
    edges, which is exactly iterating (src, dst) grouped by dst).
    """
    perm = inv = None
    if cfg.stride is not None and cfg.stride > 1:
        perm = stride_permutation(g.num_vertices, cfg.stride)
        inv = np.argsort(perm)
        g = apply_permutation(g, perm)

    p, l, sub_size, vpc = _resolve_dims(g.num_vertices, cfg)

    src = g.src.astype(np.int64)
    dst = g.dst.astype(np.int64)
    core = dst // vpc  # dim-1: destination interval owns the edge
    phase = (src % vpc) // sub_size  # dim-2: source sub-interval index
    src_core = src // vpc
    gidx = src_core * sub_size + (src % sub_size)  # crossbar routing rewrite
    lidx = dst % vpc

    # bucket sort by (core, phase), then by local dst inside each bucket
    key = (core * l + phase) * (vpc + 1) + lidx
    order = np.argsort(key, kind="stable")
    core, phase, gidx, lidx = core[order], phase[order], gidx[order], lidx[order]
    w = g.weights[order] if g.weights is not None else None

    bucket_id = core * l + phase
    sizes = np.bincount(bucket_id, minlength=p * l).reshape(p, l)
    e_pad = max(_round_up(int(sizes.max()), cfg.edge_pad), cfg.edge_pad)

    src_gidx = np.zeros((p, l, e_pad), dtype=np.int32)
    # padding edges point at the LAST local row so per-bucket dst stays sorted
    # (segment reduces use indices_are_sorted=True); they carry the reduce
    # identity so the row's value is unaffected.
    dst_lidx = np.full((p, l, e_pad), vpc - 1, dtype=np.int32)
    valid = np.zeros((p, l, e_pad), dtype=bool)
    weights = np.zeros((p, l, e_pad), dtype=np.float32) if w is not None else None

    starts = np.zeros(p * l + 1, dtype=np.int64)
    np.cumsum(sizes.ravel(), out=starts[1:])
    for i in range(p):
        for m in range(l):
            b = i * l + m
            s, e = starts[b], starts[b + 1]
            n = int(e - s)
            src_gidx[i, m, :n] = gidx[s:e]
            dst_lidx[i, m, :n] = lidx[s:e]
            valid[i, m, :n] = True
            if weights is not None:
                weights[i, m, :n] = w[s:e]

    tiles = (
        _build_tile_layouts(
            p, l, vpc, src_gidx, dst_lidx, valid, weights, cfg, sub_size
        )
        if cfg.build_tiles
        else {}
    )

    return PartitionedGraph(
        p=p,
        l=l,
        sub_size=sub_size,
        num_vertices=g.num_vertices,
        num_edges=g.num_edges,
        src_gidx=src_gidx,
        dst_lidx=dst_lidx,
        valid=valid,
        weights=weights,
        perm=perm,
        inv_perm=inv,
        bucket_sizes=sizes,
        config=cfg,
        **tiles,
    )


def _bucket_split_threshold(cfg: PartitionConfig, bucket_edges: int, r_blocks: int):
    """Resolve cfg.split_threshold for one bucket (None = splitting off)."""
    if cfg.split_threshold is None or not cfg.degree_aware_tiles:
        return None
    if cfg.split_threshold == "auto":
        # cap every kernel row at the bucket's MEAN row-block load (a row at
        # the mean cannot raise T above it) but never below one tile width —
        # sub-tile chunks cost R without shrinking T.
        return max(cfg.tile_eb, -(-int(bucket_edges) // max(r_blocks, 1)))
    return int(cfg.split_threshold)


def _build_tile_layouts(p, l, vpc, src_gidx, dst_lidx, valid, weights, cfg, sub_size):
    """Bin every (core, phase) bucket into (R, T, Eb) row-block tiles, bit-pack
    each slot's index triple into the compressed word stream, and stack to
    (p, l, R, T, Eb) with uniform (R, T) (max over buckets; padded tiles are
    recorded in ``tile_counts`` so the kernel skips them) so the engine
    launches all cores of a phase in one kernel launch. Hub rows above the
    split threshold become virtual rows (see prepare_tiles); when any bucket
    split, ``tile_row_orig``/``tile_split_map`` replace ``tile_row_pos`` and
    the engine runs the two-level reduce."""
    from repro_torch.kernels.csr_gather_reduce.ops import (
        auto_push_block,
        choose_src_bits,
        prepare_push_tiles,
        prepare_tiles,
        split_map_from_row_orig,
        stack_packed_tiles,
        stack_push_tiles,
        tile_coverage_words,
    )

    vb = cfg.tile_vb if cfg.tile_vb is not None else sub_size
    assert vpc % vb == 0, (vpc, vb)
    eb = cfg.tile_eb
    src_bits = (
        cfg.pack_src_bits
        if cfg.pack_src_bits is not None
        else choose_src_bits(p * sub_size, vb)
    )
    layouts = [
        [
            prepare_tiles(
                src_gidx[i, m], dst_lidx[i, m], valid[i, m],
                num_rows=vpc, vb=vb, eb=eb,
                weights=weights[i, m] if weights is not None else None,
                balance_rows=cfg.degree_aware_tiles,
                split_threshold=_bucket_split_threshold(
                    cfg, int(valid[i, m].sum()), vpc // vb
                ),
            )
            for m in range(l)
        ]
        for i in range(p)
    ]
    flat = [layouts[i][m] for i in range(p) for m in range(l)]
    word, word_hi, counts, wts = stack_packed_tiles(flat, src_bits=src_bits)
    r_blocks, t_max = word.shape[1], word.shape[2]
    tile_word = word.reshape(p, l, r_blocks, t_max, eb)
    tile_word_hi = (
        word_hi.reshape(p, l, r_blocks, t_max, eb) if word_hi is not None else None
    )
    tile_counts = counts.reshape(p, l, r_blocks)
    tile_weights = (
        wts.reshape(p, l, r_blocks, t_max, eb) if wts is not None else None
    )
    tile_coverage = tile_coverage_words(
        tile_word, tile_word_hi, src_bits=src_bits, p=p, sub_size=sub_size
    )
    any_split = any(t.row_orig is not None for row in layouts for t in row)
    tile_row_pos = tile_row_orig = tile_split_map = None
    split_rows = 0
    t_max_unsplit = max(t.t_tiles_unsplit for t in flat)
    if any_split:
        # every bucket needs a row_orig map (split or not) so one uniform
        # (p, l, Vl, S_max) gather drives the engine's level-2 combine.
        packed_rows = r_blocks * vb
        tile_row_orig = np.full((p, l, packed_rows), -1, dtype=np.int32)
        maps = []
        for i in range(p):
            for m in range(l):
                t = layouts[i][m]
                if t.row_orig is not None:
                    ro = t.row_orig
                elif t.row_pos is not None:
                    ro = np.full(vpc, -1, dtype=np.int32)
                    ro[t.row_pos] = np.arange(vpc, dtype=np.int32)
                else:
                    ro = np.arange(vpc, dtype=np.int32)
                tile_row_orig[i, m, : ro.shape[0]] = ro
                maps.append(split_map_from_row_orig(tile_row_orig[i, m], vpc))
                split_rows += t.num_split_rows
        s_max = max(sm.shape[1] for sm in maps)
        tile_split_map = np.full((p, l, vpc, s_max), -1, dtype=np.int32)
        for b, sm in enumerate(maps):
            tile_split_map[b // l, b % l, :, : sm.shape[1]] = sm
    else:
        any_packed = any(t.row_pos is not None for row in layouts for t in row)
        tile_row_pos = (
            np.tile(np.arange(vpc, dtype=np.int32), (p, l, 1)) if any_packed else None
        )
        if tile_row_pos is not None:
            for i in range(p):
                for m in range(l):
                    t = layouts[i][m]
                    if t.row_pos is not None:
                        tile_row_pos[i, m] = t.row_pos
    push = {}
    if cfg.build_push:
        # push (scatter) stream: same edges, binned by SOURCE block. The
        # packed dstb field holds the FULL local destination row [0, vpc),
        # so the 16-bit regime additionally needs vpc <= 2^15; an explicit
        # pack_src_bits=32 forces both streams into the wide regime.
        push_src_bits = (
            cfg.pack_src_bits
            if cfg.pack_src_bits is not None
            else choose_src_bits(p * sub_size, vpc)
        )
        gathered = p * sub_size
        peb = cfg.push_eb if cfg.push_eb is not None else eb
        push_block = cfg.push_block
        if push_block is None:
            push_block = auto_push_block(
                int(np.asarray(valid).sum()), p, l, gathered, peb
            )
        push_layouts = [
            prepare_push_tiles(
                src_gidx[i, m], dst_lidx[i, m], valid[i, m],
                gathered_size=gathered,
                block_sources=push_block,
                num_rows=vpc, eb=peb,
                weights=weights[i, m] if weights is not None else None,
            )
            for i in range(p)
            for m in range(l)
        ]
        pw, pw_hi, pcnt, pwts = stack_push_tiles(
            push_layouts, src_bits=push_src_bits
        )
        b_blocks, tp_max = pw.shape[1], pw.shape[2]
        push_word = pw.reshape(p, l, b_blocks, tp_max, peb)
        push_word_hi = (
            pw_hi.reshape(p, l, b_blocks, tp_max, peb)
            if pw_hi is not None
            else None
        )
        push = dict(
            push_word=push_word,
            push_word_hi=push_word_hi,
            push_counts=pcnt.reshape(p, l, b_blocks),
            push_weights=(
                pwts.reshape(p, l, b_blocks, tp_max, peb)
                if pwts is not None
                else None
            ),
            push_coverage=tile_coverage_words(
                push_word, push_word_hi,
                src_bits=push_src_bits, p=p, sub_size=sub_size,
            ),
            push_src_bits=push_src_bits,
            push_block=push_block,
        )
    return dict(
        tile_word=tile_word,
        tile_word_hi=tile_word_hi,
        tile_counts=tile_counts,
        tile_weights=tile_weights,
        tile_row_pos=tile_row_pos,
        tile_coverage=tile_coverage,
        tile_vb=vb,
        src_bits=src_bits,
        tile_row_orig=tile_row_orig,
        tile_split_map=tile_split_map,
        split_rows=split_rows,
        t_max_unsplit=t_max_unsplit,
        **push,
    )


# ---------------------------------------------------------------------------
# Out-of-core streaming build: chunked COO ingestion, two passes, bounded RSS.
# ---------------------------------------------------------------------------


def coo_edge_chunks(g: COOGraph, chunk_edges: int = 1 << 18):
    """Re-iterable chunk factory over a resident COOGraph — the adapter that
    lets ``partition_2d_streaming`` consume a graph the in-memory path builds
    from, which is how the bit-identity tests compare the two. Each chunk is
    ``(src, dst)`` or ``(src, dst, weights)`` slices of ``chunk_edges`` edges
    (views, no copies). A zero-edge graph still yields one empty chunk so the
    weighted/unweighted signature survives the trip."""
    if chunk_edges <= 0:
        raise ValueError(f"chunk_edges must be positive, got {chunk_edges}")

    def factory():
        n = int(g.num_edges)
        for s in range(0, n, chunk_edges) or (0,):
            e = min(s + chunk_edges, n)
            if g.weights is not None:
                yield g.src[s:e], g.dst[s:e], g.weights[s:e]
            else:
                yield g.src[s:e], g.dst[s:e]

    return factory


def _chunk_iter(chunks):
    """Open one pass over the chunk stream. The builder reads the stream
    TWICE (count pass + placement pass), so a one-shot generator is rejected
    up front instead of silently producing an empty second pass."""
    if callable(chunks):
        return iter(chunks())
    if isinstance(chunks, (list, tuple)):
        return iter(chunks)
    raise TypeError(
        "chunks must be a callable chunk factory or a list/tuple of chunks; "
        "a bare generator cannot be replayed for the placement pass "
        "(wrap it: chunks=lambda: make_gen())"
    )


def _as_chunk(chunk):
    """Normalize one chunk to (src, dst, weights|None) int64/float32 1-D."""
    if not isinstance(chunk, (tuple, list)) or len(chunk) not in (2, 3):
        raise TypeError(
            "each chunk must be a (src, dst) or (src, dst, weights) tuple"
        )
    s = np.asarray(chunk[0]).astype(np.int64, copy=False)
    d = np.asarray(chunk[1]).astype(np.int64, copy=False)
    if s.ndim != 1 or s.shape != d.shape:
        raise ValueError(
            f"chunk src/dst must be equal-length 1-D: {s.shape} vs {d.shape}"
        )
    w = None
    if len(chunk) == 3:
        w = np.asarray(chunk[2], dtype=np.float32)
        if w.shape != s.shape:
            raise ValueError(
                f"chunk weights shape {w.shape} != edge shape {s.shape}"
            )
    return s, d, w


@dataclasses.dataclass
class StreamCounts:
    """What one counting pass over a chunk stream learns (the streaming
    build's pass 1): edges a (core, phase) bucket ``sizes`` (p, l), a bucket's
    destination row ``row_counts`` (p, l, vpc) and a bucket's gathered source
    ``src_counts`` (p, l, gathered), each None unless asked for; ``total``
    edges and whether the chunks carry ``weighted`` edges."""

    sizes: np.ndarray
    row_counts: Optional[np.ndarray]
    src_counts: Optional[np.ndarray]
    total: int
    weighted: bool


def count_edge_stream(
    chunks, num_vertices: int, cfg: PartitionConfig, *, rows: bool, sources: bool
) -> StreamCounts:
    """One pass over ``chunks`` (see ``partition_2d_streaming``), binning
    each edge to its bucket as ``partition_2d`` does (after the stride
    permutation when ``cfg.stride`` is set): bucket sizes always, the
    per-row counts when ``rows`` and the per-source counts when ``sources``.
    No edge is kept."""
    p, l, sub_size, vpc = _resolve_dims(num_vertices, cfg)
    gathered = p * sub_size
    perm = None
    if cfg.stride is not None and cfg.stride > 1:
        perm = stride_permutation(num_vertices, cfg.stride)
    sizes = np.zeros((p, l), dtype=np.int64)
    row_counts = np.zeros((p, l, vpc), dtype=np.int64) if rows else None
    src_counts = np.zeros((p, l, gathered), dtype=np.int64) if sources else None
    total = 0
    weighted = None
    for chunk in _chunk_iter(chunks):
        s, d, w = _as_chunk(chunk)
        if weighted is None:
            weighted = w is not None
        elif weighted != (w is not None):
            raise ValueError("all chunks must agree on carrying weights")
        if s.size == 0:
            continue
        lo = min(int(s.min()), int(d.min()))
        hi = max(int(s.max()), int(d.max()))
        if lo < 0 or hi >= num_vertices:
            raise ValueError(
                f"edge endpoints out of range [0, {num_vertices}): "
                f"chunk range [{lo}, {hi}]"
            )
        if perm is not None:
            s, d = perm[s], perm[d]
        b = (d // vpc) * l + (s % vpc) // sub_size
        sizes += np.bincount(b, minlength=p * l).reshape(p, l)
        if row_counts is not None:
            row_counts += np.bincount(
                b * vpc + d % vpc, minlength=p * l * vpc
            ).reshape(p, l, vpc)
        if src_counts is not None:
            gx = (s // vpc) * sub_size + (s % sub_size)
            src_counts += np.bincount(
                b * gathered + gx, minlength=p * l * gathered
            ).reshape(p, l, gathered)
        total += int(s.size)
    return StreamCounts(sizes, row_counts, src_counts, total, bool(weighted))


def partition_2d_streaming(
    chunks,
    num_vertices: int,
    cfg: PartitionConfig,
    *,
    memmap_dir: Optional[str] = None,
) -> PartitionedGraph:
    """Out-of-core ``partition_2d``: same output, bounded host memory.

    ``chunks`` is a callable returning an iterator of ``(src, dst[, weights])``
    edge chunks (or a re-iterable list/tuple of such chunks); the stream must
    replay DETERMINISTICALLY because the builder reads it twice:

      pass 1 (count): per-(core, phase) bucket sizes, per-row edge counts and
        per-source counts are accumulated chunk by chunk — O(p·l·Vl) state,
        independent of E. From the counts alone, ``plan_tiles`` /
        ``plan_push_tiles`` fix every layout decision (src_bits regime,
        per-bucket 'auto' split thresholds, hub-row chunking, LPT placement,
        stacked R/T/B/Tp, row-map mode) and the full output buffers are
        preallocated — optionally ``np.memmap``-backed under ``memmap_dir``.

      pass 2 (place): each chunk is binned straight into the preallocated
        flat bucket arrays at per-bucket cursors; buckets are then finalized
        one at a time (stable lidx sort, tile binning, word packing,
        coverage), so peak transient RAM is O(chunk + largest bucket), never
        O(E).

    Output is bit-identical to ``partition_2d`` on the same edge list: the
    global stable sort by (bucket, lidx) the in-memory path does decomposes
    into chunk-order bucket insertion (stream order within a bucket ==
    global input order) followed by a per-bucket stable sort on lidx, and
    every shape/placement decision comes from the same count-only planners
    (see docs/tile_layout.md §11 for the full invariants).

    ``memmap_dir``: when given, the large outputs (flat bucket arrays and
    packed word/weight/coverage streams) are ``np.memmap`` files under that
    directory (mode='w+'); small metadata (counts, row maps) stays in RAM.
    The returned arrays remain valid only while the files exist — the caller
    owns the directory's lifetime. Memmapped partitions feed the engines and
    ``apply_edge_deltas`` unchanged (a delta flush returns plain in-RAM
    arrays; the files are then garbage)."""
    p, l, sub_size, vpc = _resolve_dims(num_vertices, cfg)
    gathered = p * sub_size
    perm = inv = None
    if cfg.stride is not None and cfg.stride > 1:
        perm = stride_permutation(num_vertices, cfg.stride)
        inv = np.argsort(perm)

    # ---- pass 1: count. O(p*l*vpc + p*gathered) accumulators, no edge kept.
    counts = count_edge_stream(
        chunks, num_vertices, cfg, rows=True,
        sources=cfg.build_tiles and cfg.build_push,
    )
    sizes, row_counts, src_counts = counts.sizes, counts.row_counts, counts.src_counts
    total, weighted = counts.total, counts.weighted

    # ---- plan: every shape decision from counts alone (plan_tiles mirrors
    # prepare_tiles bit for bit — same thresholds, chunking, LPT placement).
    e_pad = max(_round_up(int(sizes.max()), cfg.edge_pad), cfg.edge_pad)

    if memmap_dir is not None:
        os.makedirs(memmap_dir, exist_ok=True)

    def _alloc(name, shape, dtype):
        if memmap_dir is None:
            return np.zeros(shape, dtype=dtype)
        path = os.path.join(memmap_dir, f"{name}.bin")
        return np.memmap(path, dtype=dtype, mode="w+", shape=shape)

    src_gidx = _alloc("src_gidx", (p, l, e_pad), np.int32)
    dst_lidx = _alloc("dst_lidx", (p, l, e_pad), np.int32)
    valid = _alloc("valid", (p, l, e_pad), bool)
    weights = _alloc("weights", (p, l, e_pad), np.float32) if weighted else None

    tiles: dict = {}
    plans = {}
    if cfg.build_tiles:
        from repro_torch.kernels.csr_gather_reduce.ops import (
            auto_push_block,
            choose_src_bits,
            plan_push_tiles,
            plan_tiles,
        )

        vb = cfg.tile_vb if cfg.tile_vb is not None else sub_size
        assert vpc % vb == 0, (vpc, vb)
        eb = cfg.tile_eb
        src_bits = (
            cfg.pack_src_bits
            if cfg.pack_src_bits is not None
            else choose_src_bits(gathered, vb)
        )
        for i in range(p):
            for m in range(l):
                plans[(i, m)] = plan_tiles(
                    row_counts[i, m], num_rows=vpc, vb=vb, eb=eb,
                    balance_rows=cfg.degree_aware_tiles,
                    split_threshold=_bucket_split_threshold(
                        cfg, int(sizes[i, m]), vpc // vb
                    ),
                )
        r_max = max(pl.r_blocks for pl in plans.values())
        t_max = max(pl.t_tiles for pl in plans.values())
        wc = -(-(p * (-(-sub_size // 32))) // 32)
        tile_word = _alloc("tile_word", (p, l, r_max, t_max, eb), np.int32)
        tile_word_hi = (
            _alloc("tile_word_hi", (p, l, r_max, t_max, eb), np.int32)
            if src_bits == 32
            else None
        )
        tile_counts = np.zeros((p, l, r_max), np.int32)
        tile_weights = (
            _alloc("tile_weights", (p, l, r_max, t_max, eb), np.float32)
            if weighted
            else None
        )
        tile_coverage = _alloc(
            "tile_coverage", (p, l, r_max, t_max, wc), np.uint32
        )
        # row-map mode is a GLOBAL property, decidable from the plans before
        # a single edge is placed (cold-path rule: any split bucket => every
        # bucket runs in row_orig/split-map mode).
        any_split = any(pl.row_orig is not None for pl in plans.values())
        tile_row_pos = tile_row_orig = tile_split_map = None
        if any_split:
            tile_row_orig = np.full((p, l, r_max * vb), -1, dtype=np.int32)
            s_max = max(pl.s_max for pl in plans.values())
            tile_split_map = np.full((p, l, vpc, s_max), -1, dtype=np.int32)
        else:
            any_packed = any(pl.row_pos is not None for pl in plans.values())
            if any_packed:
                tile_row_pos = np.tile(
                    np.arange(vpc, dtype=np.int32), (p, l, 1)
                )
        push_shapes = None
        if cfg.build_push:
            push_src_bits = (
                cfg.pack_src_bits
                if cfg.pack_src_bits is not None
                else choose_src_bits(gathered, vpc)
            )
            peb = cfg.push_eb if cfg.push_eb is not None else eb
            push_block = cfg.push_block
            if push_block is None:
                push_block = auto_push_block(total, p, l, gathered, peb)
            push_shapes = [
                plan_push_tiles(
                    src_counts[i, m], gathered_size=gathered,
                    block_sources=push_block, eb=peb,
                )
                for i in range(p)
                for m in range(l)
            ]
            b_blocks = push_shapes[0][0]
            tp_max = max(t for _, t in push_shapes)
            push_word = _alloc(
                "push_word", (p, l, b_blocks, tp_max, peb), np.int32
            )
            push_word_hi = (
                _alloc("push_word_hi", (p, l, b_blocks, tp_max, peb), np.int32)
                if push_src_bits == 32
                else None
            )
            push_counts = np.zeros((p, l, b_blocks), np.int32)
            push_weights = (
                _alloc(
                    "push_weights", (p, l, b_blocks, tp_max, peb), np.float32
                )
                if weighted
                else None
            )
            push_coverage = _alloc(
                "push_coverage", (p, l, b_blocks, tp_max, wc), np.uint32
            )

    # ---- pass 2: place. Chunks are binned straight into the flat bucket
    # arrays at per-bucket cursors; within a bucket the arrival order is the
    # global input order (per-chunk bucket grouping is a stable sort).
    cursors = np.zeros(p * l, dtype=np.int64)
    seen = 0
    for chunk in _chunk_iter(chunks):
        s, d, w = _as_chunk(chunk)
        if s.size == 0:
            continue
        if perm is not None:
            s, d = perm[s], perm[d]
        b = (d // vpc) * l + (s % vpc) // sub_size
        gx = (s // vpc) * sub_size + (s % sub_size)
        lx = d % vpc
        order = np.argsort(b, kind="stable")
        b_s, g_s, l_s = b[order], gx[order], lx[order]
        w_s = w[order] if w is not None else None
        uniq, starts = np.unique(b_s, return_index=True)
        ends = np.append(starts[1:], b_s.size)
        for bk, ss, ee in zip(uniq, starts, ends):
            i, m = divmod(int(bk), l)
            n = int(ee - ss)
            c = int(cursors[bk])
            src_gidx[i, m, c : c + n] = g_s[ss:ee]
            dst_lidx[i, m, c : c + n] = l_s[ss:ee]
            if weights is not None:
                weights[i, m, c : c + n] = w_s[ss:ee]
            cursors[bk] += n
        seen += int(s.size)
    if seen != total or not np.array_equal(cursors.reshape(p, l), sizes):
        raise ValueError(
            "chunk stream did not replay identically between the count and "
            f"placement passes (counted {total} edges, placed {seen}); the "
            "chunk factory must be deterministic"
        )

    # ---- finalize one bucket at a time: stable lidx sort (reproducing the
    # in-memory path's global (bucket, lidx) stable sort), then tile binning
    # and word packing into the preallocated stacked buffers. Transient RAM
    # here is O(largest bucket).
    if cfg.build_tiles:
        from repro_torch.kernels.csr_gather_reduce.ops import (
            pack_edge_words,
            prepare_push_tiles,
            prepare_tiles,
            split_map_from_row_orig,
            tile_coverage_words,
        )
    split_rows = 0
    for i in range(p):
        for m in range(l):
            n = int(sizes[i, m])
            ga = np.asarray(src_gidx[i, m, :n])
            la = np.asarray(dst_lidx[i, m, :n])
            oo = np.argsort(la, kind="stable")
            src_gidx[i, m, :n] = ga[oo]
            dst_lidx[i, m, :n] = la[oo]
            dst_lidx[i, m, n:] = vpc - 1  # padding keeps dst sorted
            valid[i, m, :n] = True
            if weights is not None:
                weights[i, m, :n] = np.asarray(weights[i, m, :n])[oo]
            if not cfg.build_tiles:
                continue
            plan = plans[(i, m)]
            t = prepare_tiles(
                src_gidx[i, m], dst_lidx[i, m], valid[i, m],
                num_rows=vpc, vb=vb, eb=eb,
                weights=weights[i, m] if weights is not None else None,
                balance_rows=cfg.degree_aware_tiles,
                split_threshold=_bucket_split_threshold(
                    cfg, n, vpc // vb
                ),
                plan=plan,
            )
            rr, tt = t.src.shape[:2]
            assert (rr, tt) == (plan.r_blocks, plan.t_tiles), (
                (rr, tt), (plan.r_blocks, plan.t_tiles)
            )
            w0, w1 = pack_edge_words(t.src, t.dstb, t.valid, src_bits=src_bits)
            tile_word[i, m, :rr, :tt] = w0
            if tile_word_hi is not None:
                tile_word_hi[i, m, :rr, :tt] = w1
            tile_counts[i, m, :rr] = t.tile_counts
            if tile_weights is not None and t.weights is not None:
                tile_weights[i, m, :rr, :tt] = t.weights
            tile_coverage[i, m] = tile_coverage_words(
                np.asarray(tile_word[i, m]),
                np.asarray(tile_word_hi[i, m])
                if tile_word_hi is not None
                else None,
                src_bits=src_bits, p=p, sub_size=sub_size,
            )
            if any_split:
                if t.row_orig is not None:
                    ro = t.row_orig
                elif t.row_pos is not None:
                    ro = np.full(vpc, -1, dtype=np.int32)
                    ro[t.row_pos] = np.arange(vpc, dtype=np.int32)
                else:
                    ro = np.arange(vpc, dtype=np.int32)
                tile_row_orig[i, m, : ro.shape[0]] = ro
                sm = split_map_from_row_orig(tile_row_orig[i, m], vpc)
                tile_split_map[i, m, :, : sm.shape[1]] = sm
                split_rows += t.num_split_rows
            elif tile_row_pos is not None and t.row_pos is not None:
                tile_row_pos[i, m] = t.row_pos
            if cfg.build_push:
                pt = prepare_push_tiles(
                    src_gidx[i, m], dst_lidx[i, m], valid[i, m],
                    gathered_size=gathered, block_sources=push_block,
                    num_rows=vpc, eb=peb,
                    weights=weights[i, m] if weights is not None else None,
                )
                bb, pt_t = pt.src.shape[:2]
                assert bb == b_blocks, (bb, b_blocks)
                pw0, pw1 = pack_edge_words(
                    pt.src, pt.dst, pt.valid, src_bits=push_src_bits
                )
                push_word[i, m, :, :pt_t] = pw0
                if push_word_hi is not None:
                    push_word_hi[i, m, :, :pt_t] = pw1
                push_counts[i, m] = pt.tile_counts
                if push_weights is not None and pt.weights is not None:
                    push_weights[i, m, :, :pt_t] = pt.weights
                push_coverage[i, m] = tile_coverage_words(
                    np.asarray(push_word[i, m]),
                    np.asarray(push_word_hi[i, m])
                    if push_word_hi is not None
                    else None,
                    src_bits=push_src_bits, p=p, sub_size=sub_size,
                )

    if cfg.build_tiles:
        tiles = dict(
            tile_word=tile_word,
            tile_word_hi=tile_word_hi,
            tile_counts=tile_counts,
            tile_weights=tile_weights,
            tile_row_pos=tile_row_pos,
            tile_coverage=tile_coverage,
            tile_vb=vb,
            src_bits=src_bits,
            tile_row_orig=tile_row_orig,
            tile_split_map=tile_split_map,
            split_rows=split_rows,
            t_max_unsplit=max(pl.t_tiles_unsplit for pl in plans.values()),
        )
        if cfg.build_push:
            tiles.update(
                push_word=push_word,
                push_word_hi=push_word_hi,
                push_counts=push_counts,
                push_weights=push_weights,
                push_coverage=push_coverage,
                push_src_bits=push_src_bits,
                push_block=push_block,
            )

    return PartitionedGraph(
        p=p,
        l=l,
        sub_size=sub_size,
        num_vertices=num_vertices,
        num_edges=total,
        src_gidx=src_gidx,
        dst_lidx=dst_lidx,
        valid=valid,
        weights=weights,
        perm=perm,
        inv_perm=inv,
        bucket_sizes=sizes,
        config=cfg,
        **tiles,
    )


# ---------------------------------------------------------------------------
# Delta ingestion: streaming edge insertions re-tile ONLY dirty buckets.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DeltaFlushReport:
    """What one incremental flush actually rebuilt — the O(B) contract.

    ``tile_bytes_repacked`` counts only the packed stream bytes that were
    regenerated from scratch (dirty buckets' edge words + coverage words +
    push words); ``tile_bytes_total`` is the whole partition's packed stream.
    A flush touching B of the p*l buckets must keep the repacked fraction
    ~B / (p*l) — asserted in tests/test_torch_delta_ingest.py."""

    dirty: tuple  # ((core, phase), ...) buckets that received edges, sorted
    buckets_retiled: int
    total_buckets: int
    edges_added: int
    tile_bytes_repacked: int
    tile_bytes_total: int
    grew_edge_pad: bool  # per-bucket flat arrays grew past the old E_pad
    grew_tiles: bool  # stacked R/T/Tp grew (clean slices padded, not rebuilt)
    mode_changed: bool  # row-map mode flipped (row_pos -> split map)

    @property
    def repacked_fraction(self) -> float:
        return self.tile_bytes_repacked / max(self.tile_bytes_total, 1)


def bucket_coords(
    pg: PartitionedGraph, src: np.ndarray, dst: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Bin delta edges exactly the way ``partition_2d`` bins the full edge
    list: apply the stride permutation, then compute (core, phase, gidx,
    lidx) per edge. Endpoints must be existing vertex ids — vertex-set
    growth changes sub_size and with it every bucket, so it is a full
    repartition, not a delta."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if src.size:
        lo = min(int(src.min()), int(dst.min()))
        hi = max(int(src.max()), int(dst.max()))
        if lo < 0 or hi >= pg.num_vertices:
            raise ValueError(
                f"delta edge endpoints must be existing vertex ids in "
                f"[0, {pg.num_vertices}); got range [{lo}, {hi}]"
            )
    if pg.perm is not None:
        src = pg.perm[src]
        dst = pg.perm[dst]
    vpc, sub = pg.vertices_per_core, pg.sub_size
    core = dst // vpc
    phase = (src % vpc) // sub
    gidx = (src // vpc) * sub + (src % sub)
    lidx = dst % vpc
    return core, phase, gidx, lidx


def _tile_bytes_total(pg: PartitionedGraph) -> int:
    """Packed-stream bytes of a partition (edge words + weights + coverage,
    pull and push) — the denominator of the O(B) repack-fraction metric."""
    total = 0
    for a in (
        pg.tile_word, pg.tile_word_hi, pg.tile_weights, pg.tile_coverage,
        pg.push_word, pg.push_word_hi, pg.push_weights, pg.push_coverage,
    ):
        if a is not None:
            total += a.nbytes
    return total


def apply_edge_deltas(
    pg: PartitionedGraph,
    src: np.ndarray,
    dst: np.ndarray,
    weights: Optional[np.ndarray] = None,
) -> tuple[PartitionedGraph, DeltaFlushReport]:
    """Flush streamed edge insertions into a resident partition by re-tiling
    ONLY the dirty (core, phase) buckets.

    The incremental path reproduces ``partition_2d`` output bit-for-bit (see
    docs/serving.md §3 / docs/tile_layout.md §10): a bucket's flat slice is
    its old dst-sorted edges plus the delta edges in insertion order, stably
    re-sorted by local dst — exactly the tie order a cold repartition of
    (original edges ++ inserted edges) produces. Dirty buckets then re-run
    ``prepare_tiles`` / ``pack_edge_words`` / ``tile_coverage_words`` /
    ``prepare_push_tiles`` under the SAME config rules (per-bucket 'auto'
    split threshold recomputed with the new bucket size); clean buckets keep
    their packed arrays untouched — if the stacked R/T/Tp must grow, clean
    slices are only zero-padded (counts stay authoritative; padded tiles are
    dead under the kernel's early-out and carry all-zero coverage).

    Returns ``(new_pg, report)``. A NEW PartitionedGraph object is always
    returned — the engine's jit cache is keyed by object identity with edge
    constants baked into traces, so mutating the resident arrays in place
    would silently serve stale edges. The caller should drop the retired
    object's device copies (``engine.evict_from_cache``)."""
    cfg = pg.config
    if cfg is None:
        raise ValueError(
            "partition carries no PartitionConfig (hand-built?); "
            "delta ingest needs partition_2d provenance to re-tile"
        )
    if (pg.weights is not None) != (weights is not None):
        raise ValueError(
            "delta weights must match the partition: "
            f"partition weighted={pg.weights is not None}, "
            f"delta weighted={weights is not None}"
        )
    src = np.atleast_1d(np.asarray(src))
    dst = np.atleast_1d(np.asarray(dst))
    if src.shape != dst.shape or src.ndim != 1:
        raise ValueError(f"src/dst must be equal-length 1-D: {src.shape} vs {dst.shape}")
    p, l, vpc, sub = pg.p, pg.l, pg.vertices_per_core, pg.sub_size
    n_add = int(src.shape[0])
    if n_add == 0:
        return pg, DeltaFlushReport(
            dirty=(), buckets_retiled=0, total_buckets=p * l, edges_added=0,
            tile_bytes_repacked=0, tile_bytes_total=_tile_bytes_total(pg),
            grew_edge_pad=False, grew_tiles=False, mode_changed=False,
        )
    core, phase, gidx, lidx = bucket_coords(pg, src, dst)
    w = np.asarray(weights, dtype=np.float32) if weights is not None else None

    # group delta edges by bucket, preserving insertion order within a bucket
    # (the stable tie order a cold repartition of the appended edge list sees)
    b_id = core * l + phase
    order = np.argsort(b_id, kind="stable")
    b_s, g_s, l_s = b_id[order], gidx[order], lidx[order]
    w_s = w[order] if w is not None else None
    add = np.bincount(b_s, minlength=p * l).reshape(p, l)
    dirty = sorted((int(b) // l, int(b) % l) for b in np.unique(b_s))
    new_sizes = pg.bucket_sizes + add

    # -- flat (p, l, E_pad) bucket arrays: grow E_pad by the same rounding
    # rule partition_2d uses, then merge each dirty bucket's slice
    e_pad_old = pg.edge_pad
    e_pad = max(_round_up(int(new_sizes.max()), cfg.edge_pad), cfg.edge_pad)
    grew_epad = e_pad > e_pad_old

    def _grow_flat(a, fill):
        out = np.full((p, l, e_pad), fill, dtype=a.dtype)
        out[:, :, :e_pad_old] = a
        return out

    src_gidx = _grow_flat(pg.src_gidx, 0)
    dst_lidx = _grow_flat(pg.dst_lidx, vpc - 1)  # padding keeps dst sorted
    valid = _grow_flat(pg.valid, False)
    wts_flat = _grow_flat(pg.weights, 0.0) if pg.weights is not None else None

    starts = np.zeros(p * l + 1, dtype=np.int64)
    np.cumsum(add.ravel(), out=starts[1:])
    for (i, m) in dirty:
        b = i * l + m
        s, e = int(starts[b]), int(starts[b + 1])
        n_old, n = int(pg.bucket_sizes[i, m]), int(new_sizes[i, m])
        ga = np.concatenate([src_gidx[i, m, :n_old], g_s[s:e].astype(np.int32)])
        la = np.concatenate([dst_lidx[i, m, :n_old], l_s[s:e].astype(np.int32)])
        oo = np.argsort(la, kind="stable")  # old edges first on lidx ties
        src_gidx[i, m, :n] = ga[oo]
        dst_lidx[i, m, :n] = la[oo]
        valid[i, m, :n] = True
        if wts_flat is not None:
            wa = np.concatenate([wts_flat[i, m, :n_old], w_s[s:e]])
            wts_flat[i, m, :n] = wa[oo]

    updates = dict(
        num_edges=pg.num_edges + n_add,
        src_gidx=src_gidx,
        dst_lidx=dst_lidx,
        valid=valid,
        weights=wts_flat,
        bucket_sizes=new_sizes,
    )
    rep_bytes = 0
    grew_tiles = False
    mode_changed = False

    if pg.tile_word is not None:
        from repro_torch.kernels.csr_gather_reduce.ops import (
            _lpt_max_load,
            pack_edge_words,
            prepare_push_tiles,
            prepare_tiles,
            split_map_from_row_orig,
            tile_coverage_words,
        )

        # -- pull stream: re-tile dirty buckets only
        vb = pg.tile_vb
        eb = int(pg.tile_word.shape[4])
        r_old, t_old = int(pg.tile_word.shape[2]), int(pg.tile_word.shape[3])
        r_base = vpc // vb
        layouts = {
            (i, m): prepare_tiles(
                src_gidx[i, m], dst_lidx[i, m], valid[i, m],
                num_rows=vpc, vb=vb, eb=eb,
                weights=wts_flat[i, m] if wts_flat is not None else None,
                balance_rows=cfg.degree_aware_tiles,
                split_threshold=_bucket_split_threshold(
                    cfg, int(new_sizes[i, m]), vpc // vb
                ),
            )
            for (i, m) in dirty
        }
        # Per-bucket layout shape + split metadata. The stacked shape is the
        # GLOBAL max over buckets — it can also SHRINK: a dirty bucket that
        # dictated the old R/T/S_max re-tiles under a larger 'auto' split
        # threshold (it grows with the bucket's edge count) and may need
        # less. Clean buckets' contributions are derived without touching
        # their packed bytes: T from the valid sign bits (a real tile always
        # holds >= 1 valid edge, and tiles fill a row block in order), R and
        # S from the row maps, and the unsplit-T metric from the flat dst
        # column — metadata reads, not stream rebuilds.
        vword = pg.tile_word_hi if pg.tile_word_hi is not None else pg.tile_word
        tile_has_edge = (vword < 0).any(axis=(2, 4))  # (p, l, T)
        r_b = np.full((p, l), r_base, dtype=np.int64)
        t_b = np.ones((p, l), dtype=np.int64)
        s_b = np.ones((p, l), dtype=np.int64)  # split-map width per bucket
        split_b = np.zeros((p, l), dtype=np.int64)  # split natural rows
        tu_b = np.ones((p, l), dtype=np.int64)  # per-bucket unsplit T
        for i in range(p):
            for m in range(l):
                if (i, m) in layouts:
                    continue
                nz = np.nonzero(tile_has_edge[i, m])[0]
                if nz.size:
                    t_b[i, m] = int(nz[-1]) + 1
                if pg.tile_split_map is not None:
                    width = (pg.tile_split_map[i, m] >= 0).sum(axis=1)
                    s_b[i, m] = max(int(width.max()), 1)
                    split_b[i, m] = int((width > 1).sum())
                    pos = np.nonzero(pg.tile_row_orig[i, m] >= 0)[0]
                    if pos.size:
                        r_b[i, m] = max(r_base, int(pos[-1]) // vb + 1)
                n_old = int(pg.bucket_sizes[i, m])
                rc = np.bincount(pg.dst_lidx[i, m, :n_old], minlength=vpc)
                if cfg.degree_aware_tiles:
                    load = _lpt_max_load(rc, r_base, vb)
                else:
                    load = int(rc.reshape(r_base, vb).sum(axis=1).max())
                tu_b[i, m] = max(1, -(-int(load) // eb))
        for (i, m), t in layouts.items():
            r_b[i, m], t_b[i, m] = t.src.shape[0], t.src.shape[1]
            tu_b[i, m] = t.t_tiles_unsplit
            split_b[i, m] = t.num_split_rows
        r_new, t_new = int(r_b.max()), int(t_b.max())
        grew_tiles = (r_new, t_new) != (r_old, t_old)
        ro_n, to_n = min(r_old, r_new), min(t_old, t_new)

        def _restack(a, fill=0):
            out = np.full((p, l, r_new, t_new) + a.shape[4:], fill, dtype=a.dtype)
            out[:, :, :ro_n, :to_n] = a[:, :, :ro_n, :to_n]
            return out

        tile_word = _restack(pg.tile_word)
        tile_word_hi = (
            _restack(pg.tile_word_hi)
            if pg.tile_word_hi is not None else None
        )
        tile_counts = np.zeros((p, l, r_new), np.int32)
        tile_counts[:, :, :ro_n] = pg.tile_counts[:, :, :ro_n]
        tile_weights = (
            _restack(pg.tile_weights)
            if pg.tile_weights is not None else None
        )
        tile_coverage = (
            _restack(pg.tile_coverage)
            if pg.tile_coverage is not None else None
        )
        for (i, m), t in layouts.items():
            rr, tt = t.src.shape[0], t.src.shape[1]
            w0, w1 = pack_edge_words(t.src, t.dstb, t.valid, src_bits=pg.src_bits)
            tile_word[i, m] = 0
            tile_word[i, m, :rr, :tt] = w0
            rep_bytes += w0.nbytes
            if tile_word_hi is not None:
                tile_word_hi[i, m] = 0
                tile_word_hi[i, m, :rr, :tt] = w1
                rep_bytes += w1.nbytes
            tile_counts[i, m] = 0
            tile_counts[i, m, :rr] = t.tile_counts
            if tile_weights is not None:
                tile_weights[i, m] = 0.0
                if t.weights is not None:
                    tile_weights[i, m, :rr, :tt] = t.weights
                    rep_bytes += t.weights.nbytes
            if tile_coverage is not None:
                cov = tile_coverage_words(
                    tile_word[i, m], tile_word_hi[i, m] if tile_word_hi is not None else None,
                    src_bits=pg.src_bits, p=p, sub_size=sub,
                )
                tile_coverage[i, m] = cov
                rep_bytes += cov.nbytes

        # -- row maps: dirty buckets bring fresh maps; clean buckets keep
        # (or mechanically re-derive — metadata, not packed stream) theirs.
        # The MODE is a global property: a partition is in split mode iff ANY
        # bucket still has a split row, so it can flip in either direction —
        # pos->split when a dirty bucket crosses its threshold, split->pos
        # when the only split bucket un-splits under its grown threshold.
        any_split_old = pg.tile_split_map is not None
        any_split_new = bool((split_b > 0).any())
        mode_changed = any_split_old != any_split_new
        tile_row_pos = tile_row_orig = tile_split_map = None
        split_rows = 0
        if not any_split_new:
            # no virtual rows anywhere: R stays Vl / vb in this mode, and the
            # pos map exists iff the LPT packer ran (cold-path rule)
            if cfg.degree_aware_tiles and r_base > 1:
                tile_row_pos = np.tile(np.arange(vpc, dtype=np.int32), (p, l, 1))
                for i in range(p):
                    for m in range(l):
                        if (i, m) in layouts:
                            t = layouts[(i, m)]
                            if t.row_pos is not None:
                                tile_row_pos[i, m] = t.row_pos
                        elif pg.tile_row_pos is not None:
                            tile_row_pos[i, m] = pg.tile_row_pos[i, m]
                        elif pg.tile_row_orig is not None:
                            # split->pos flip: invert the clean bucket's
                            # packed-position map (it has no split rows, so
                            # the inverse is exactly the row_pos the cold
                            # LPT pass reproduces on unchanged row counts)
                            pos = np.nonzero(pg.tile_row_orig[i, m] >= 0)[0]
                            tile_row_pos[
                                i, m, pg.tile_row_orig[i, m, pos]
                            ] = pos.astype(np.int32)
        else:
            packed_old, packed_new = r_old * vb, r_new * vb
            po_n = min(packed_old, packed_new)
            tile_row_orig = np.full((p, l, packed_new), -1, dtype=np.int32)
            if pg.tile_row_orig is not None:
                tile_row_orig[:, :, :po_n] = pg.tile_row_orig[:, :, :po_n]
            elif pg.tile_row_pos is not None:
                for i in range(p):
                    for m in range(l):
                        tile_row_orig[i, m, pg.tile_row_pos[i, m]] = np.arange(
                            vpc, dtype=np.int32
                        )
            else:
                tile_row_orig[:, :, :vpc] = np.arange(vpc, dtype=np.int32)
            for (i, m), t in layouts.items():
                ro = np.full(packed_new, -1, dtype=np.int32)
                if t.row_orig is not None:
                    ro[: t.row_orig.shape[0]] = t.row_orig
                elif t.row_pos is not None:
                    ro[t.row_pos] = np.arange(vpc, dtype=np.int32)
                else:
                    ro[:vpc] = np.arange(vpc, dtype=np.int32)
                tile_row_orig[i, m] = ro
            # gather-form split maps: rebuild dirty buckets (and every bucket
            # on a pos->split mode flip, where no old map exists)
            maps = {}
            for i in range(p):
                for m in range(l):
                    if (i, m) in layouts or not any_split_old:
                        maps[(i, m)] = split_map_from_row_orig(
                            tile_row_orig[i, m], vpc
                        )
                        s_b[i, m] = maps[(i, m)].shape[1]
            s_max = int(s_b.max())
            tile_split_map = np.full((p, l, vpc, s_max), -1, dtype=np.int32)
            if any_split_old:
                so_n = min(pg.tile_split_map.shape[3], s_max)
                tile_split_map[:, :, :, :so_n] = pg.tile_split_map[:, :, :, :so_n]
            for (i, m), sm in maps.items():
                tile_split_map[i, m] = -1
                tile_split_map[i, m, :, : sm.shape[1]] = sm
            split_rows = int(split_b.sum())
        updates.update(
            tile_word=tile_word,
            tile_word_hi=tile_word_hi,
            tile_counts=tile_counts,
            tile_weights=tile_weights,
            tile_coverage=tile_coverage,
            tile_row_pos=tile_row_pos,
            tile_row_orig=tile_row_orig,
            tile_split_map=tile_split_map,
            split_rows=split_rows,
            t_max_unsplit=int(tu_b.max()),
        )

        # -- push (scatter) stream: same dirty buckets, same block sizing
        if pg.push_word is not None:
            peb = int(pg.push_word.shape[4])
            tp_old = int(pg.push_word.shape[3])
            push_layouts = {
                (i, m): prepare_push_tiles(
                    src_gidx[i, m], dst_lidx[i, m], valid[i, m],
                    gathered_size=pg.gathered_size,
                    block_sources=pg.push_block,
                    num_rows=vpc, eb=peb,
                    weights=wts_flat[i, m] if wts_flat is not None else None,
                )
                for (i, m) in dirty
            }
            tp_new = max([tp_old] + [t.src.shape[1] for t in push_layouts.values()])
            grew_tiles = grew_tiles or tp_new > tp_old
            b_blocks = int(pg.push_word.shape[2])

            def _pad_push(a, fill=0):
                out = np.full(
                    (p, l, b_blocks, tp_new) + a.shape[4:], fill, dtype=a.dtype
                )
                out[:, :, :, :tp_old] = a
                return out

            push_word = _pad_push(pg.push_word)
            push_word_hi = (
                _pad_push(pg.push_word_hi) if pg.push_word_hi is not None else None
            )
            push_counts = pg.push_counts.copy()
            push_weights = (
                _pad_push(pg.push_weights) if pg.push_weights is not None else None
            )
            push_coverage = (
                _pad_push(pg.push_coverage) if pg.push_coverage is not None else None
            )
            for (i, m), t in push_layouts.items():
                bb, tt = t.src.shape[0], t.src.shape[1]
                assert bb == b_blocks, (bb, b_blocks)
                w0, w1 = pack_edge_words(
                    t.src, t.dst, t.valid, src_bits=pg.push_src_bits
                )
                push_word[i, m] = 0
                push_word[i, m, :, :tt] = w0
                rep_bytes += w0.nbytes
                if push_word_hi is not None:
                    push_word_hi[i, m] = 0
                    push_word_hi[i, m, :, :tt] = w1
                    rep_bytes += w1.nbytes
                push_counts[i, m] = t.tile_counts
                if push_weights is not None:
                    push_weights[i, m] = 0.0
                    if t.weights is not None:
                        push_weights[i, m, :, :tt] = t.weights
                        rep_bytes += t.weights.nbytes
                if push_coverage is not None:
                    cov = tile_coverage_words(
                        push_word[i, m],
                        push_word_hi[i, m] if push_word_hi is not None else None,
                        src_bits=pg.push_src_bits, p=p, sub_size=sub,
                    )
                    push_coverage[i, m] = cov
                    rep_bytes += cov.nbytes
            updates.update(
                push_word=push_word,
                push_word_hi=push_word_hi,
                push_counts=push_counts,
                push_weights=push_weights,
                push_coverage=push_coverage,
            )

    # a NEW partition: its device_cache is a fresh field (init=False), so
    # no device copy of the old packed arrays can reach the new graph
    new_pg = dataclasses.replace(pg, **updates)
    report = DeltaFlushReport(
        dirty=tuple(dirty),
        buckets_retiled=len(dirty),
        total_buckets=p * l,
        edges_added=n_add,
        tile_bytes_repacked=rep_bytes,
        tile_bytes_total=_tile_bytes_total(new_pg),
        grew_edge_pad=grew_epad,
        grew_tiles=grew_tiles,
        mode_changed=mode_changed,
    )
    return new_pg, report


# ---------------------------------------------------------------------------
# Edge-centric (HitGraph/ThunderGP-style) partitioning for the baseline engine:
# horizontal partitioning of the *edge list* by destination interval, no
# sub-intervals, no compression (src kept as a global vertex id).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EdgeCentricPartition:
    p: int
    num_vertices: int
    num_edges: int
    vertices_per_core: int
    src_vid: np.ndarray  # (p, E_pad) int32 global (padded) src vertex id
    dst_lidx: np.ndarray  # (p, E_pad) int32 local dst id
    valid: np.ndarray  # (p, E_pad) bool
    weights: Optional[np.ndarray]
    bucket_sizes: np.ndarray  # (p,)
    # device copies of the edge arrays, filled on first use by
    # ``core.edge_centric.run_edge_centric`` (not an init field)
    device_cache: dict = dataclasses.field(
        default_factory=dict, init=False, compare=False, repr=False
    )


def partition_edge_centric(
    g: COOGraph, p: int, lane: int = 8, edge_pad: int = 8
) -> EdgeCentricPartition:
    """Bucket the edge list by destination core (dst-sorted within a core),
    each bucket padded to a common ``E_pad``; padding slots point at the
    core's last row so every bucket stays sorted."""
    vpc = _round_up(-(-g.num_vertices // p), lane)
    src = g.src.astype(np.int64)
    dst = g.dst.astype(np.int64)
    core = dst // vpc
    order = np.argsort(core * (g.num_vertices + 1) + dst, kind="stable")
    src, dst, core = src[order], dst[order], core[order]
    w = g.weights[order] if g.weights is not None else None
    sizes = np.bincount(core, minlength=p)
    e_pad = max(_round_up(int(sizes.max()), edge_pad), edge_pad)
    src_vid = np.zeros((p, e_pad), dtype=np.int32)
    dst_lidx = np.full((p, e_pad), vpc - 1, dtype=np.int32)  # keep sorted under padding
    valid = np.zeros((p, e_pad), dtype=bool)
    weights = np.zeros((p, e_pad), dtype=np.float32) if w is not None else None
    starts = np.zeros(p + 1, dtype=np.int64)
    np.cumsum(sizes, out=starts[1:])
    for i in range(p):
        s, e = starts[i], starts[i + 1]
        n = int(e - s)
        src_vid[i, :n] = src[s:e]
        dst_lidx[i, :n] = dst[s:e] - i * vpc
        valid[i, :n] = True
        if weights is not None:
            weights[i, :n] = w[s:e]
    return EdgeCentricPartition(
        p=p,
        num_vertices=g.num_vertices,
        num_edges=g.num_edges,
        vertices_per_core=vpc,
        src_vid=src_vid,
        dst_lidx=dst_lidx,
        valid=valid,
        weights=weights,
        bucket_sizes=sizes,
    )
