"""repro_torch.serve — the always-on graph service, on the port's engine.

Counterpart of ``repro.serve``. One resident ``PartitionedGraph`` stays on
the device while mixed-op queries stream in and the graph itself mutates:

  loop.RequestLoop      bounded admission + same-kind K-lane coalescing,
                        deadline-or-full draining, per-query latency
  delta.DeltaBuffer     streamed edge insertions binned to (core, phase)
                        buckets; flush re-tiles ONLY dirty buckets
                        (core.partition.apply_edge_deltas)
  router.GraphService   neighbors-of / distance-to (BFS, SSSP) / PPR /
                        recommend-for routing over the same resident
                        partition (recommend-for: router.RecommendScorer,
                        DIN retrieval scoring)
  metrics               p50/p95/p99 latency, QPS, amortized MTEPS
"""
from repro_torch.serve.delta import DeltaBuffer
from repro_torch.serve.loop import Completion, LoopConfig, RequestLoop
from repro_torch.serve.metrics import BatchRecord, FlushRecord, ServingMetrics, latency_summary
from repro_torch.serve.router import (
    KINDS, TRAVERSAL_KINDS, BatchResult, GraphService, Query, RecommendScorer,
)

__all__ = [
    "BatchRecord",
    "BatchResult",
    "Completion",
    "DeltaBuffer",
    "FlushRecord",
    "GraphService",
    "KINDS",
    "LoopConfig",
    "Query",
    "RecommendScorer",
    "RequestLoop",
    "ServingMetrics",
    "TRAVERSAL_KINDS",
    "latency_summary",
]
