"""Streaming edge-insertion staging for the resident partitioned graph.

Counterpart of ``repro.serve.delta`` (host numpy).

The buffer is the serving side of ``core.partition.apply_edge_deltas``:
insertions arrive one edge (or one small batch) at a time, are binned to
their (core, phase) destination bucket immediately — the same arithmetic
``partition_2d`` uses, so the dirty-bucket set is known before the flush —
and buffered until a flush re-tiles ONLY those dirty buckets. The resident
``PartitionedGraph`` is immutable between flushes: queries racing an ingest
see a consistent snapshot, and a partition's device copies stay valid (a
flush yields a NEW partition object with an empty device cache; the
retired one's copies are freed by the service via
``engine.evict_from_cache``).

Binning is layout-stable across flushes: ``apply_edge_deltas`` never changes
p, l, sub_size, or the stride permutation, so the buffer's coordinates stay
valid no matter how many flushes happen while it fills.

Memmap-backed partitions (``partition_2d_streaming(..., memmap_dir=...)``)
flush like any other: ``np.memmap`` is an ndarray subclass, so the re-tile
reads dirty bucket slices straight off disk, and the NEW partition's arrays
come out of ``apply_edge_deltas`` as plain RAM arrays (clean-bucket data is
copied, never aliased), leaving the on-disk build files untouched: safe to
delete once the first flush retires them. Covered by
tests/test_torch_streaming_partition.py.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.partition import (
    PartitionedGraph,
    apply_edge_deltas,
    bucket_coords,
)

__all__ = ["DeltaBuffer"]


class DeltaBuffer:
    """Bounded staging area for streamed edge insertions.

    ``auto_flush_edges``: when set, ``should_flush()`` turns True once that
    many edges are pending — the request loop's flush trigger. The buffer
    never flushes on its own; the owner decides when (and pairs the flush
    with the eviction of the retired device copies and COO bookkeeping).
    """

    def __init__(
        self,
        pg: PartitionedGraph,
        *,
        auto_flush_edges: Optional[int] = None,
    ):
        if pg.config is None:
            raise ValueError(
                "partition carries no PartitionConfig; delta ingest needs "
                "partition_2d provenance"
            )
        self._pg = pg  # layout reference: p/l/sub_size/perm are flush-invariant
        self.auto_flush_edges = auto_flush_edges
        self._src: list = []
        self._dst: list = []
        self._w: list = []
        self._dirty: set = set()

    def stage(self, src, dst, weights=None) -> int:
        """Stage insertions; returns the number of edges staged. Validates
        endpoints and bins to buckets now, so bad edges fail at ingest time
        (not mid-flush) and ``dirty_buckets`` is always current."""
        src = np.atleast_1d(np.asarray(src, dtype=np.int64))
        dst = np.atleast_1d(np.asarray(dst, dtype=np.int64))
        if src.shape != dst.shape or src.ndim != 1:
            raise ValueError(f"src/dst must be equal-length 1-D: {src.shape} vs {dst.shape}")
        if (self._pg.weights is not None) != (weights is not None):
            raise ValueError(
                "delta weights must match the partition: "
                f"partition weighted={self._pg.weights is not None}, "
                f"delta weighted={weights is not None}"
            )
        if src.size == 0:
            return 0
        core, phase, _, _ = bucket_coords(self._pg, src, dst)
        self._dirty.update(zip(core.tolist(), phase.tolist()))
        self._src.append(src)
        self._dst.append(dst)
        if weights is not None:
            w = np.atleast_1d(np.asarray(weights, dtype=np.float32))
            if w.shape != src.shape:
                raise ValueError(f"weights shape {w.shape} != src shape {src.shape}")
            self._w.append(w)
        return int(src.size)

    @property
    def pending_edges(self) -> int:
        return sum(int(a.size) for a in self._src)

    @property
    def dirty_buckets(self) -> frozenset:
        """(core, phase) buckets the next flush will re-tile."""
        return frozenset(self._dirty)

    def should_flush(self) -> bool:
        return (
            self.auto_flush_edges is not None
            and self.pending_edges >= self.auto_flush_edges
        )

    def pending(self):
        """The staged (src, dst, weights-or-None) arrays, without clearing —
        the service reads these before ``flush`` to keep its COO view of the
        graph in sync with the new partition."""
        if not self._src:
            z = np.zeros(0, dtype=np.int64)
            return z, z, (np.zeros(0, np.float32) if self._w or self._pg.weights is not None else None)
        src = np.concatenate(self._src)
        dst = np.concatenate(self._dst)
        w = np.concatenate(self._w) if self._w else None
        return src, dst, w

    def flush(self, pg: PartitionedGraph):
        """Apply all pending insertions to ``pg`` (must be the resident
        partition this buffer was staged against — same layout lineage);
        returns ``(new_pg, DeltaFlushReport)`` and clears the buffer."""
        src, dst, w = self.pending()
        new_pg, report = apply_edge_deltas(pg, src, dst, w)
        self._src, self._dst, self._w = [], [], []
        self._dirty = set()
        self._pg = new_pg
        return new_pg, report
