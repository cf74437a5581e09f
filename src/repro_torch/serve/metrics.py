"""Serving observability: per-query latency percentiles, QPS, amortized
MTEPS, and delta-flush accounting.

Counterpart of ``repro.serve.metrics`` (host numpy, the same records and
summary).

Latency is measured per QUERY (completion wall time minus arrival at the
admission queue), so it includes queueing delay — a query that waits for its
batch to fill or for the deadline pays that wait here. Batch records carry
the engine-side view (wall per lane-batched run, iterations, resident edge
count); the first batch of a (kind, partition generation) is flagged
``cold`` — in the port it pays the upload of the partition's edge tensors
to the device — and excluded from the steady-state stats.

Amortized MTEPS follows the PR 7 serving metric: a K-lane traversal batch
streams the whole edge set once per iteration for all its queries, so
``edges * served / wall`` is the per-query-amortized edge throughput; here
it is aggregated over steady (warm) traversal batches only.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

__all__ = [
    "BatchRecord",
    "FlushRecord",
    "ServingMetrics",
    "latency_summary",
]


def latency_summary(lat_ms) -> dict:
    """p50/p95/p99 + mean/max over a latency sample (ms). Empty-safe."""
    a = np.asarray(list(lat_ms), dtype=np.float64)
    if a.size == 0:
        return {"n": 0, "mean_ms": None, "p50_ms": None, "p95_ms": None,
                "p99_ms": None, "max_ms": None}
    return {
        "n": int(a.size),
        "mean_ms": float(a.mean()),
        "p50_ms": float(np.percentile(a, 50)),
        "p95_ms": float(np.percentile(a, 95)),
        "p99_ms": float(np.percentile(a, 99)),
        "max_ms": float(a.max()),
    }


@dataclasses.dataclass(frozen=True)
class BatchRecord:
    """One executed admission batch (or one host-answered query group)."""

    kind: str
    served: int  # real (non-padding) queries answered
    lanes: int  # batch width K (1 for host-answered kinds)
    wall_s: float
    iterations: int  # engine iterations (0 for non-traversal kinds)
    edges: int  # resident edge count at execution time
    cold: bool  # first batch of its (kind, partition generation): device upload


@dataclasses.dataclass(frozen=True)
class FlushRecord:
    """One delta flush (DeltaFlushReport + wall time)."""

    edges_added: int
    wall_s: float
    buckets_retiled: int
    total_buckets: int
    repacked_fraction: float


class ServingMetrics:
    """Accumulates completions, batch records, and flush records for one
    serving run; ``summary()`` emits the serving record (the reference's
    ``serving`` record of BENCH_engine.json)."""

    def __init__(self):
        self.latencies_ms: dict = {}  # kind -> [per-query latency ms]
        self.batches: list = []
        self.flushes: list = []
        self.rejected = 0
        self._t0: Optional[float] = None
        self._t1: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        self._t1 = time.perf_counter()

    @property
    def wall_s(self) -> float:
        if self._t0 is None:
            return 0.0
        return (self._t1 or time.perf_counter()) - self._t0

    def record_query(self, kind: str, latency_ms: float):
        self.latencies_ms.setdefault(kind, []).append(float(latency_ms))

    def record_batch(self, rec: BatchRecord):
        self.batches.append(rec)

    def record_flush(self, rec: FlushRecord):
        self.flushes.append(rec)

    def record_rejected(self, n: int = 1):
        self.rejected += n

    def steady_batches(self, kind: Optional[str] = None) -> list:
        """Warm batches (compile excluded), optionally for one kind."""
        return [
            b for b in self.batches
            if not b.cold and (kind is None or b.kind == kind)
        ]

    def summary(self) -> dict:
        all_lat = [x for v in self.latencies_ms.values() for x in v]
        served = sum(b.served for b in self.batches)
        wall = self.wall_s
        steady = self.steady_batches()
        steady_walls = [b.wall_s for b in steady]
        per_kind = {
            k: dict(
                latency=latency_summary(v),
                steady_batch_ms=(
                    float(np.median([b.wall_s for b in self.steady_batches(k)]))
                    * 1e3
                    if self.steady_batches(k) else None
                ),
            )
            for k, v in sorted(self.latencies_ms.items())
        }
        # amortized MTEPS over steady traversal batches (iterations > 0):
        # one edge-stream pass per iteration answers `served` queries at once
        trav = [b for b in steady if b.iterations > 0]
        trav_wall = sum(b.wall_s for b in trav)
        amortized_mteps = (
            sum(b.edges * b.served for b in trav) / trav_wall / 1e6
            if trav_wall > 0 else None
        )
        return {
            "queries": served,
            "rejected": self.rejected,
            "wall_s": wall,
            "qps": served / wall if wall > 0 else None,
            "latency": latency_summary(all_lat),
            "per_kind": per_kind,
            "batches": len(self.batches),
            "cold_batches": sum(1 for b in self.batches if b.cold),
            "steady_batch_ms": (
                float(np.median(steady_walls)) * 1e3 if steady_walls else None
            ),
            "amortized_mteps": amortized_mteps,
            "flushes": [dataclasses.asdict(f) for f in self.flushes],
        }
