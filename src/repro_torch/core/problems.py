"""Graph problems as map/reduce user-defined functions (paper §III, §IV).

Counterpart of ``repro.core.problems``: the laneless problems ``bfs``,
``wcc``, ``sssp`` and ``pagerank`` and the multi-query constructors
``bfs_multi``, ``sssp_multi`` and ``ppr_multi``. The UDF surface is the
same:

  * ``init_labels`` — host numpy, identical arrays to the reference's;
  * ``src_transform`` — per-source half of the map UDF on the label tensors;
  * ``edge_map`` / ``edge_op`` — per-edge half ('add' = SSSP's saturating
    weight add, 'none' = the contribution IS the payload);
  * ``reduce_kind`` / ``identity`` — 'min', 'sum' or 'or' and its identity;
  * ``finalize`` / ``not_converged`` — iteration end of sum problems and
    the convergence test.

uint32 labels (BFS/WCC) follow ``repro_torch.core.u32``: on device they
are int32 tensors holding the uint32 bit pattern, and every ordered op
widens to int64. ``u32_fields`` names the label fields that use it, so
``engine.unpad_labels`` hands them back as numpy uint32.

Multi-query lanes (``lanes = K > 0``) answer K point queries in one engine
run: the exchanged payload gains a trailing lane axis, either packed reach
words of ``bfs_multi`` (32 queries per word, reduced by bitwise OR) or a
(..., K) label block of ``sssp_multi``/``ppr_multi`` (min/sum per lane).
``not_converged_lanes`` is the per-lane live mask; a converged lane's
labels freeze, so it drops out of the union frontier by itself.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import u32
from repro_torch.core.graph import COOGraph, out_degrees

__all__ = [
    "Problem", "bfs", "wcc", "sssp", "pagerank", "bfs_multi", "sssp_multi", "ppr_multi",
    "lane_bits", "INF_U32", "INF_F32",
]

INF_U32 = np.uint32(u32.U32_MAX)
INF_F32 = np.float32(np.finfo(np.float32).max)

LabelTree = Dict[str, torch.Tensor]


def lane_bits(words: torch.Tensor, k: int) -> torch.Tensor:
    """Unpack the trailing packed-word axis (..., W) of int32 bits into
    (..., k) bools (little-endian bit order, as ``frontier_words.pack_bits``).
    The arithmetic shift of int32 storage is harmless: the ``& 1`` keeps
    only bit ``lane % 32``."""
    lane = torch.arange(k, device=words.device)
    w = words.index_select(-1, lane // 32)
    return ((w >> (lane % 32).to(w.dtype)) & 1) != 0


@dataclasses.dataclass(frozen=True)
class Problem:
    name: str
    reduce_kind: str  # 'min' | 'sum' | 'or'
    # host-side: initial (padded) label tree, numpy, given padded size & graph
    init_labels: Callable[[COOGraph, int], Dict[str, np.ndarray]]
    # map UDF, source half: label tree -> exchanged payload (p, Vl)
    src_transform: Callable[[LabelTree], torch.Tensor]
    # map UDF, edge half (oracle backend): (payload_at_src, weight|None) -> contribution
    edge_map: Callable[[torch.Tensor, Optional[torch.Tensor]], torch.Tensor]
    edge_op: str = "none"  # declarative edge_map for the kernel: 'none' | 'add'
    identity: float = 0.0  # reduce identity, as the reference states it
    finalize: Optional[Callable[[LabelTree, torch.Tensor], LabelTree]] = None
    # (old, new) -> bool tensor (True = keep iterating)
    not_converged: Optional[Callable[[LabelTree, LabelTree], torch.Tensor]] = None
    merge_field: str = "label"
    # multi-query lanes: concurrent queries (0 = one laneless query); the
    # merge field then carries a trailing axis of K lanes ('vector') or
    # ceil(K/32) packed reach words ('packed')
    lanes: int = 0
    lane_layout: str = ""  # '' | 'packed' | 'vector'
    # (old, new) -> (K,) bool: which lanes still change (observability only)
    not_converged_lanes: Optional[Callable[[LabelTree, LabelTree], torch.Tensor]] = None
    u32_fields: Tuple[str, ...] = ()  # label fields stored as uint32 bits

    @property
    def payload_u32(self) -> bool:
        """The exchanged payload and merged labels are uint32 bit patterns."""
        return self.merge_field in self.u32_fields

    @property
    def stored_identity(self):
        """``identity`` as the merged labels store it (int32 bits for uint32)."""
        return u32.identity_bits(self.identity) if self.payload_u32 else self.identity


def _labels_differ(old: LabelTree, new: LabelTree) -> torch.Tensor:
    return torch.any(old["label"] != new["label"])


# ---------------------------------------------------------------------------
# BFS — label = hop distance from root; map = src+1 (saturating); reduce = min.
# ---------------------------------------------------------------------------


def bfs(root: int) -> Problem:
    def init(g: COOGraph, padded: int):
        lab = np.full(padded, INF_U32, dtype=np.uint32)
        lab[root] = 0
        return {"label": lab}

    def src_transform(labels: LabelTree) -> torch.Tensor:
        lab = u32.widen(labels["label"])
        # saturating +1 so INF stays INF
        return u32.narrow(torch.where(lab == u32.U32_MAX, lab, lab + 1))

    return Problem(
        name="bfs",
        reduce_kind="min",
        init_labels=init,
        src_transform=src_transform,
        edge_map=lambda z, w: z,
        identity=float(INF_U32),
        not_converged=_labels_differ,
        u32_fields=("label",),
    )


# ---------------------------------------------------------------------------
# WCC — label = min vertex id in the weakly connected component. Requires the
# symmetrized edge set (undirected closure), as in the paper.
# ---------------------------------------------------------------------------


def wcc() -> Problem:
    def init(g: COOGraph, padded: int):
        return {"label": np.arange(padded, dtype=np.uint32)}

    return Problem(
        name="wcc",
        reduce_kind="min",
        init_labels=init,
        src_transform=lambda labels: labels["label"],
        edge_map=lambda z, w: z,
        identity=float(INF_U32),
        not_converged=_labels_differ,
        u32_fields=("label",),
    )


# ---------------------------------------------------------------------------
# SSSP — min-plus with float32 edge weights (unit weights when absent).
# ---------------------------------------------------------------------------


def sssp(root: int) -> Problem:
    def init(g: COOGraph, padded: int):
        lab = np.full(padded, INF_F32, dtype=np.float32)
        lab[root] = 0.0
        return {"label": lab}

    def edge_map(z, w):
        return torch.where(z >= float(INF_F32), z, z + (w if w is not None else 1.0))

    return Problem(
        name="sssp",
        reduce_kind="min",
        init_labels=init,
        src_transform=lambda labels: labels["label"],
        edge_map=edge_map,
        edge_op="add",
        identity=float(INF_F32),
        not_converged=_labels_differ,
    )


# ---------------------------------------------------------------------------
# PageRank — pull-based power iteration:
#   p(i) <- (1-d)/|V| + d * sum_{j in N_in(i)} p(j) / outdeg(j)
# The exchanged payload is rank * inv_outdeg, reduce = sum, finalize applies
# damping; converged when max |delta| <= tol.
# ---------------------------------------------------------------------------


def pagerank(damping: float = 0.85, tol: float = 1e-6) -> Problem:
    def init(g: COOGraph, padded: int):
        deg = out_degrees(g).astype(np.float32)
        inv = np.zeros(padded, dtype=np.float32)
        nz = deg > 0
        inv[: g.num_vertices][nz] = 1.0 / deg[nz]
        rank = np.zeros(padded, dtype=np.float32)
        rank[: g.num_vertices] = 1.0 / g.num_vertices
        mask = np.zeros(padded, dtype=np.float32)
        mask[: g.num_vertices] = 1.0
        return {"label": rank, "inv_deg": inv, "mask": mask, "n": np.float32(g.num_vertices)}

    def src_transform(labels: LabelTree) -> torch.Tensor:
        return labels["label"] * labels["inv_deg"]

    def finalize(labels: LabelTree, acc: torch.Tensor) -> LabelTree:
        n = labels["n"]
        new_rank = ((1.0 - damping) / n + damping * acc) * labels["mask"]
        out = dict(labels)
        out["label"] = new_rank
        return out

    def not_conv(old: LabelTree, new: LabelTree):
        return torch.max(torch.abs(old["label"] - new["label"])) > tol

    return Problem(
        name="pagerank",
        reduce_kind="sum",
        init_labels=init,
        src_transform=src_transform,
        edge_map=lambda z, w: z,
        identity=0.0,
        finalize=finalize,
        not_converged=not_conv,
    )


# ---------------------------------------------------------------------------
# Multi-query lane-batched constructors.
# ---------------------------------------------------------------------------


def bfs_multi(roots: Sequence[int]) -> Problem:
    """K-source BFS with bit-packed lanes: payload word w of vertex v has bit
    (k % 32) set iff query ``roots[k]`` has reached v. The reduce is the
    bitwise OR over the edge stream; hop distances are recovered
    level-synchronously in ``finalize`` from the newly set bits, so
    ``dist[:, k]`` is bit-identical to a single-query ``bfs(roots[k])``.

    'or' problems always take the synchronous (accumulate + finalize)
    schedule whatever ``EngineOptions.immediate_updates`` says: async
    multi-hop propagation within one iteration would record wrong levels.
    OR is monotone like min, so the dynamic tile skip stays sound."""
    roots = np.asarray(roots, dtype=np.int64)
    k = int(roots.shape[0])
    if not 1 <= k <= 1024:
        raise ValueError(f"bfs_multi supports 1..1024 lanes, got {k}")
    w = (k + 31) // 32

    def init(g: COOGraph, padded: int):
        if (roots < 0).any() or (roots >= g.num_vertices).any():
            raise ValueError("bfs_multi root out of range")
        reach = np.zeros((padded, w), dtype=np.uint32)
        lane = np.arange(k)
        bits = (np.uint32(1) << (lane % 32).astype(np.uint32)).astype(np.uint32)
        # unbuffered |= : duplicate roots land in the same word
        np.bitwise_or.at(reach, (roots, lane // 32), bits)
        dist = np.full((padded, k), INF_U32, dtype=np.uint32)
        dist[roots, lane] = 0
        return {"reach": reach, "dist": dist, "level": np.uint32(0)}

    def finalize(labels: LabelTree, acc: torch.Tensor) -> LabelTree:
        reach = labels["reach"]
        newly = acc & ~reach
        level = labels["level"] + 1  # int32 storage; levels stay far below 2^31
        hit = lane_bits(newly, k)
        dist = torch.where(hit, level, labels["dist"])
        return {"reach": reach | newly, "dist": dist, "level": level}

    def not_conv(old: LabelTree, new: LabelTree):
        return torch.any(old["reach"] != new["reach"])

    def lanes_live(old: LabelTree, new: LabelTree):
        diff = lane_bits(old["reach"] ^ new["reach"], k)
        return torch.any(diff.reshape(-1, k), dim=0)

    return Problem(
        name=f"bfs_multi[{k}]",
        reduce_kind="or",
        init_labels=init,
        src_transform=lambda labels: labels["reach"],
        edge_map=lambda z, w_: z,
        identity=0.0,
        finalize=finalize,
        not_converged=not_conv,
        merge_field="reach",
        lanes=k,
        lane_layout="packed",
        not_converged_lanes=lanes_live,
        u32_fields=("reach", "dist", "level"),
    )


def sssp_multi(roots: Sequence[int]) -> Problem:
    """K-source SSSP with a (..., K) label block: one min-plus reduce over
    the edge stream updates all K distance columns per tile decode. Column
    k is bit-identical to a single-query ``sssp(roots[k])`` run."""
    roots = np.asarray(roots, dtype=np.int64)
    k = int(roots.shape[0])

    def init(g: COOGraph, padded: int):
        if (roots < 0).any() or (roots >= g.num_vertices).any():
            raise ValueError("sssp_multi root out of range")
        lab = np.full((padded, k), INF_F32, dtype=np.float32)
        lab[roots, np.arange(k)] = 0.0
        return {"label": lab}

    def edge_map(z, w):
        step = 1.0 if w is None else w[..., None]
        return torch.where(z >= float(INF_F32), z, z + step)

    def lanes_live(old: LabelTree, new: LabelTree):
        return torch.any((old["label"] != new["label"]).reshape(-1, k), dim=0)

    return Problem(
        name=f"sssp_multi[{k}]",
        reduce_kind="min",
        init_labels=init,
        src_transform=lambda labels: labels["label"],
        edge_map=edge_map,
        edge_op="add",
        identity=float(INF_F32),
        not_converged=_labels_differ,
        lanes=k,
        lane_layout="vector",
        not_converged_lanes=lanes_live,
    )


def ppr_multi(seeds: Sequence[int], damping: float = 0.85, tol: float = 1e-6) -> Problem:
    """K-seed personalized PageRank, one (..., K) rank column per seed:
    ``p_k <- (1-d) * e_k + d * A_pull p_k``. The sum reduce is the one of
    single-query PageRank, widened by the lane axis."""
    seeds = np.asarray(seeds, dtype=np.int64)
    k = int(seeds.shape[0])

    def init(g: COOGraph, padded: int):
        if (seeds < 0).any() or (seeds >= g.num_vertices).any():
            raise ValueError("ppr_multi seed out of range")
        deg = out_degrees(g).astype(np.float32)
        inv = np.zeros(padded, dtype=np.float32)
        nz = deg > 0
        inv[: g.num_vertices][nz] = 1.0 / deg[nz]
        seed = np.zeros((padded, k), dtype=np.float32)
        seed[seeds, np.arange(k)] = 1.0
        mask = np.zeros(padded, dtype=np.float32)
        mask[: g.num_vertices] = 1.0
        return {"label": seed.copy(), "seed": seed, "inv_deg": inv, "mask": mask}

    def src_transform(labels: LabelTree) -> torch.Tensor:
        return labels["label"] * labels["inv_deg"][..., None]

    def finalize(labels: LabelTree, acc: torch.Tensor) -> LabelTree:
        new_rank = (1.0 - damping) * labels["seed"] + damping * acc
        out = dict(labels)
        out["label"] = new_rank * labels["mask"][..., None]
        return out

    def not_conv(old: LabelTree, new: LabelTree):
        return torch.max(torch.abs(old["label"] - new["label"])) > tol

    def lanes_live(old: LabelTree, new: LabelTree):
        diff = torch.abs(old["label"] - new["label"])
        return torch.amax(diff.reshape(-1, k), dim=0) > tol

    return Problem(
        name=f"ppr_multi[{k}]",
        reduce_kind="sum",
        init_labels=init,
        src_transform=src_transform,
        edge_map=lambda z, w: z,
        identity=0.0,
        finalize=finalize,
        not_converged=not_conv,
        lanes=k,
        lane_layout="vector",
        not_converged_lanes=lanes_live,
    )
