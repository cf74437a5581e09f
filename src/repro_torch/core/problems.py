"""Graph problems as map/reduce user-defined functions (paper §III, §IV).

Counterpart of ``repro.core.problems`` for the laneless problems ``bfs``,
``wcc``, ``sssp`` and ``pagerank``; the multi-query ``*_multi``
constructors are not ported yet. The UDF surface is the same:

  * ``init_labels`` — host numpy, identical arrays to the reference's;
  * ``src_transform`` — per-source half of the map UDF on the label tensors;
  * ``edge_map`` / ``edge_op`` — per-edge half ('add' = SSSP's saturating
    weight add, 'none' = the contribution IS the payload);
  * ``reduce_kind`` / ``identity`` — 'min' or 'sum' and its identity;
  * ``finalize`` / ``not_converged`` — iteration end of sum problems and
    the convergence test.

uint32 labels (BFS/WCC) follow ``repro_torch.core.u32``: on device they
are int32 tensors holding the uint32 bit pattern, and every ordered op
widens to int64. ``u32_fields`` names the label fields that use it, so
``engine.unpad_labels`` hands them back as numpy uint32.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import u32
from repro_torch.core.graph import COOGraph, out_degrees

__all__ = ["Problem", "bfs", "wcc", "sssp", "pagerank", "INF_U32", "INF_F32"]

INF_U32 = np.uint32(u32.U32_MAX)
INF_F32 = np.float32(np.finfo(np.float32).max)

LabelTree = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Problem:
    name: str
    reduce_kind: str  # 'min' | 'sum'
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
