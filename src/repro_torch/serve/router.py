"""Mixed-op routing over ONE resident ``PartitionedGraph``.

Counterpart of ``repro.serve.router``. The traffic classes share the same
resident partition:

  neighbors-of   host-side decode of the flat bucket layout
                 (``PartitionedGraph.in_neighbors``, no engine run)
  distance-to    BFS / SSSP lane batches: K same-kind queries answered by one
                 engine run of ``bfs_multi`` / ``sssp_multi`` on the device,
                 then ``dist[target, lane]`` is read per query. PPR rides the
                 same path (``ppr_multi``), answering the top-k vertices per
                 seed.
  recommend-for  DIN retrieval scoring over a candidate pool of hub vertices,
                 with the user's history read from the SAME partition
                 (in-neighbors), the item-table reads routed through the
                 ``dist.embedding`` crossbar lookup and the profile bag
                 through the embedding-bag kernel.

``GraphService`` owns the resident state: the COO view, the partition, the
engine options, the recommend scorer and the delta buffer. Ingest + flush
swap in a NEW partition (``apply_edge_deltas``), bump the generation (the
next batch per kind is marked cold: it uploads the new partition's edge
tensors to the device), refresh the recommend pool, and free the retired
partition's device copies (``engine.evict_from_cache``).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.registry import get
from repro_torch.core.engine import EngineOptions, evict_from_cache, run
from repro_torch.core.graph import COOGraph, in_degrees
from repro_torch.core.partition import PartitionConfig, PartitionedGraph, partition_2d
from repro_torch.core.problems import INF_U32, bfs_multi, ppr_multi, sssp_multi
from repro_torch.device import resolve_device
from repro_torch.dist.embedding import crossbar_lookup_local, make_crossbar_lookup, make_exchange
from repro_torch.models.recsys import din
from repro_torch.serve.delta import DeltaBuffer
from repro_torch.serve.metrics import FlushRecord

__all__ = ["Query", "BatchResult", "RecommendScorer", "GraphService", "TRAVERSAL_KINDS",
           "KINDS"]

TRAVERSAL_KINDS = ("bfs", "sssp", "ppr")
KINDS = ("neighbors",) + TRAVERSAL_KINDS + ("recommend",)


@dataclasses.dataclass(frozen=True)
class Query:
    """One request. ``target`` is the distance-to endpoint (bfs/sssp only);
    ``qid`` is the caller's correlation id."""

    kind: str
    root: int
    target: int = 0
    qid: int = -1


@dataclasses.dataclass
class BatchResult:
    """One executed same-kind batch: ``answers[i]`` answers ``queries[i]``."""

    kind: str
    answers: list
    served: int
    lanes: int
    wall_s: float
    iterations: int
    cold: bool


def _table_sharded_lookup(group, dropped: list, capacity_factor: float = 2.0):
    """The reference's ``make_crossbar_lookup(mesh, "table", "table")`` over
    ``group``: each rank holds one row shard of the table (the rows in rank
    order), the ids (the same on every rank) are split over the ranks (the
    flat ids padded with -1 to a multiple of the world, rank r taking the
    r-th share), each share goes through the crossbar against the shards,
    and the rows come back all-gathered in rank order. Ids past a
    destination's queue (``capacity_factor`` of the uniform load) return
    zero rows, as the reference's do; each call appends the ids dropped on
    all ranks to ``dropped``."""
    import torch.distributed as dist

    from repro_torch.core.distributed import all_reduce_int, crossbar_exchange

    exchange, n = make_exchange(group)
    rank = dist.get_rank(group)

    def lookup(table, ids):
        flat = ids.reshape(-1)
        share = -(-flat.shape[0] // n)
        padded = torch.full((share * n,), -1, dtype=flat.dtype, device=flat.device)
        padded[: flat.shape[0]] = flat
        capacity = max(1, math.ceil(share * capacity_factor / n))
        rows, drop = crossbar_lookup_local(table, padded[rank * share:(rank + 1) * share],
                                           exchange, n, capacity)
        dropped.append(all_reduce_int(int(drop), "sum", group))
        rows = crossbar_exchange(rows.contiguous(), group)[: flat.shape[0]]
        return rows.reshape(*ids.shape, table.shape[-1])

    return lookup


class RecommendScorer:
    """recommend-for: DIN retrieval scoring over a fixed-size candidate pool.

    The pool is the ``pool_size`` highest in-degree vertices of the resident
    graph (recomputed on every flush, so newly hot vertices enter the pool),
    mapped onto the DIN item/category vocab by id. The user's behaviour
    history is their in-neighbor list decoded from the resident partition,
    the same array the neighbors-of path serves, so recommendations follow
    the graph through delta ingest. Shapes are static (pool size, seq_len).

    ``params`` takes carried-across weights (``din.params_from_reference``);
    without them the scorer draws ``din.init`` from a generator seeded with
    ``seed`` on ``device``. ``lookup='crossbar'`` routes item-table reads
    through the crossbar: under an initialised ``torch.distributed`` group of
    ``world`` ranks the item table is split into ``world`` row shards, one a
    rank (``dist.sharding.local_shard`` on a ``table`` mesh axis), and the
    ids over the ranks too (``_table_sharded_lookup``), as the reference
    shards it over one table shard a device; where ``item_vocab % world !=
    0``, and with no group, it runs at one shard (``make_crossbar_lookup``).
    ``table_shards`` says which; ``dropped`` lists the ids each sharded
    lookup dropped. ``'take'`` is the plain take. Every rank of a group
    builds its scorer with the same parameters and answers the same
    queries.
    """

    def __init__(
        self,
        cfg=None,
        *,
        pool_size: int = 64,
        topk: int = 8,
        lookup: str = "crossbar",
        seed: int = 0,
        params=None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.cfg = cfg if cfg is not None else get("din").smoke()
        self.pool_size = int(pool_size)
        self.topk = int(topk)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = din.init(self.cfg, gen, self.device)
        self.table_shards = 1
        self.dropped: list = []
        if lookup == "crossbar":
            import torch.distributed as dist

            world = dist.get_world_size() if dist.is_initialized() else 1
            if world > 1 and self.cfg.item_vocab % world == 0:
                from repro_torch.dist.sharding import P, local_shard, placements
                from repro_torch.launch.mesh import make_graph_mesh

                mesh = make_graph_mesh(world, axis="table")
                shard = local_shard(params["item_table"], mesh, placements(P("table", None), mesh))
                params = {**params, "item_table": shard.to_local().to(self.device)}
                self.table_shards = world
                self._lookup_fn = _table_sharded_lookup(mesh.get_group("table"), self.dropped)
            else:
                self._lookup_fn = make_crossbar_lookup()
        elif lookup == "take":
            self._lookup_fn = None
        else:
            raise ValueError(f"lookup must be 'crossbar' or 'take', got {lookup!r}")
        self._params = params
        self._pool_items = None
        self._pool_vertices = None
        self._pool_device = None

    def refresh_pool(self, g: COOGraph):
        """(Re)build the candidate pool from the current graph's in-degrees.
        Called at service construction and after every flush."""
        deg = in_degrees(g)
        order = np.argsort(-deg, kind="stable")[: self.pool_size]
        if order.shape[0] < self.pool_size:  # tiny graph: pad by repetition
            order = np.resize(order, self.pool_size)
        self._pool_vertices = order.astype(np.int64)
        self._pool_items = (order % self.cfg.item_vocab).astype(np.int32)
        items = torch.from_numpy(self._pool_items).to(self.device)
        self._pool_device = (items, items % self.cfg.cate_vocab)

    def recommend_for(self, pg: PartitionedGraph, root: int) -> dict:
        """Score the pool for one user (= vertex ``root``); returns the topk
        pool vertices with their DIN scores."""
        if self._pool_items is None:
            raise RuntimeError("refresh_pool was never called")
        cfg = self.cfg
        L = cfg.seq_len
        hist_v = pg.in_neighbors(root)[:L]
        hist_items = np.full((1, L), -1, dtype=np.int32)
        hist_items[0, : hist_v.shape[0]] = hist_v % cfg.item_vocab
        hist_cates = np.where(hist_items >= 0, hist_items % cfg.cate_vocab, -1)
        # deterministic per-user profile bag (stand-in for profile features)
        prof = ((int(root) + np.arange(cfg.profile_bag_len)) % cfg.cate_vocab).astype(np.int32)
        host = {"hist_items": hist_items, "hist_cates": hist_cates.astype(np.int32),
                "profile_bag": prof[None, :]}
        batch = {k: torch.from_numpy(v).to(self.device) for k, v in host.items()}
        batch["cand_items"], batch["cand_cates"] = self._pool_device
        scores = din.score_candidates(self._params, batch, cfg, lookup_fn=self._lookup_fn)
        scores = scores.cpu().numpy()
        top = np.argsort(-scores, kind="stable")[: self.topk]
        return {
            "vertices": self._pool_vertices[top].copy(),
            "items": self._pool_items[top].copy(),
            "scores": scores[top].copy(),
        }


class GraphService:
    """The always-on resident graph service: answers every kind of ``KINDS``
    from one ``PartitionedGraph`` on ``device`` (the card unless the caller
    asks for ``"cpu"``), accepts streamed edge insertions, and re-tiles dirty
    buckets on flush. recommend-for needs a ``scorer``."""

    def __init__(
        self,
        g: COOGraph,
        partition,  # PartitionConfig (partitions here) or a built PartitionedGraph
        *,
        lanes: int = 16,
        opts: Optional[EngineOptions] = None,
        scorer: Optional[RecommendScorer] = None,
        ppr_tol: float = 1e-4,
        ppr_topk: int = 8,
        auto_flush_edges: Optional[int] = None,
        device="cuda",
    ):
        if isinstance(partition, PartitionConfig):
            pg = partition_2d(g, partition)
        elif isinstance(partition, PartitionedGraph):
            pg = partition
        else:
            raise TypeError(
                f"partition must be PartitionConfig or PartitionedGraph, got {type(partition)}"
            )
        self.device = resolve_device(device)
        self.g = g
        self.pg = pg
        self.lanes = int(lanes)
        self.opts = opts if opts is not None else EngineOptions(lanes=lanes)
        if self.opts.lanes != self.lanes:
            raise ValueError(f"opts.lanes={self.opts.lanes} must match service lanes={lanes}")
        self.ppr_tol = ppr_tol
        self.ppr_topk = ppr_topk
        self.generation = 0
        self.delta = DeltaBuffer(pg, auto_flush_edges=auto_flush_edges)
        self.scorer = scorer
        if self.scorer is not None:
            self.scorer.refresh_pool(g)
        self._makers = {
            "bfs": bfs_multi,
            "sssp": sssp_multi,
            "ppr": lambda roots: ppr_multi(roots, tol=ppr_tol),
        }
        self._warm: set = set()  # (kind, generation) pairs whose first batch ran

    # -- delta ingest ------------------------------------------------------
    def ingest(self, src, dst, weights=None) -> int:
        """Stage streamed edge insertions; visible to queries after flush()."""
        return self.delta.stage(src, dst, weights)

    def flush(self) -> FlushRecord:
        """Re-tile the dirty buckets, swap in the new partition, sync the COO
        view, refresh the recommend pool, and free the retired partition's
        device copies."""
        src, dst, w = self.delta.pending()
        t0 = time.perf_counter()
        new_pg, report = self.delta.flush(self.pg)
        wall = time.perf_counter() - t0
        if report.edges_added:
            old_pg = self.pg
            self.pg = new_pg
            self.g = COOGraph(
                src=np.concatenate([self.g.src, src.astype(self.g.src.dtype)]),
                dst=np.concatenate([self.g.dst, dst.astype(self.g.dst.dtype)]),
                num_vertices=self.g.num_vertices,
                weights=(
                    np.concatenate([self.g.weights, w]) if self.g.weights is not None else None
                ),
            )
            self.generation += 1  # next batch per kind uploads the new partition (cold)
            evict_from_cache(old_pg)
            if self.scorer is not None:
                self.scorer.refresh_pool(self.g)
        return FlushRecord(
            edges_added=report.edges_added,
            wall_s=wall,
            buckets_retiled=report.buckets_retiled,
            total_buckets=report.total_buckets,
            repacked_fraction=report.repacked_fraction,
        )

    # -- query answering ---------------------------------------------------
    def answer_batch(self, queries: list) -> BatchResult:
        """Answer one SAME-KIND batch of up to ``lanes`` queries (the request
        loop's admission coalescing guarantees both)."""
        if not queries:
            raise ValueError("empty batch")
        kind = queries[0].kind
        if any(q.kind != kind for q in queries):
            raise ValueError("mixed-kind batch; admission must coalesce by kind")
        if kind not in KINDS:
            raise ValueError(f"unknown kind {kind!r}; supported: {KINDS}")
        if kind in TRAVERSAL_KINDS and len(queries) > self.lanes:
            raise ValueError(f"batch of {len(queries)} exceeds K={self.lanes}")
        t0 = time.perf_counter()
        if kind == "neighbors":
            answers = [self.pg.in_neighbors(q.root) for q in queries]
            iters, lanes_used, cold = 0, 1, False
        elif kind == "recommend":
            if self.scorer is None:
                raise ValueError("service built without a RecommendScorer")
            key = ("recommend", self.generation)
            cold = key not in self._warm
            self._warm.add(key)
            answers = [self.scorer.recommend_for(self.pg, q.root) for q in queries]
            iters, lanes_used = 0, 1
        else:
            answers, iters, cold = self._answer_traversal(kind, queries)
            lanes_used = self.lanes
        wall = time.perf_counter() - t0
        return BatchResult(
            kind=kind, answers=answers, served=len(queries),
            lanes=lanes_used, wall_s=wall, iterations=iters, cold=cold,
        )

    def _answer_traversal(self, kind: str, queries: list):
        roots = np.asarray([q.root for q in queries], dtype=np.int64)
        served = roots.shape[0]
        if served < self.lanes:  # pad the partial batch (admission_batches rule)
            roots = np.concatenate([roots, np.repeat(roots[-1:], self.lanes - served)])
        key = (kind, self.generation)
        cold = key not in self._warm
        self._warm.add(key)
        res = run(self._makers[kind](roots), self.g, self.pg, self.opts, device=self.device)
        if kind == "bfs":
            dist = res.labels["dist"]  # (V, K) uint32, INF_U32 = unreachable
            answers = [
                {"distance": int(dist[q.target, j]),
                 "reachable": bool(dist[q.target, j] != INF_U32)}
                for j, q in enumerate(queries)
            ]
        elif kind == "sssp":
            # (V, K) float32; an unreachable vertex holds FLT_MAX, which
            # np.isfinite accepts: "reachable" is the reference's own flag
            lab = res.labels["label"]
            answers = [
                {"distance": float(lab[q.target, j]),
                 "reachable": bool(np.isfinite(lab[q.target, j]))}
                for j, q in enumerate(queries)
            ]
        else:  # ppr: top-k vertices per seed lane
            lab = res.labels["label"]  # (V, K) float32 rank columns
            answers = []
            for j in range(served):
                top = np.argsort(-lab[:, j], kind="stable")[: self.ppr_topk]
                answers.append({"vertices": top.astype(np.int64), "scores": lab[top, j].copy()})
        return answers, res.iterations, cold
