"""Graph data structures and synthetic generators (host numpy).

Counterpart of ``repro.core.graph``: the port keeps its own numpy copy so it
never imports the JAX package. The paper's host code loads and partitions
the graph on the CPU before the partitions move to device memory; only the
engine's label and edge tensors live on the card.

  * ``COOGraph`` — edge list (src, dst), 8 bytes/edge.
  * ``CSRGraph`` — compressed sparse row (row = src), used by the oracles.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = [
    "COOGraph",
    "CSRGraph",
    "coo_to_csr",
    "csr_to_coo",
    "inverse_coo",
    "symmetrize",
    "deduplicate",
    "out_degrees",
    "in_degrees",
    "rmat",
    "erdos_renyi",
    "grid_2d",
    "chain",
    "star",
    "complete",
    "karate_club",
    "bytes_per_edge",
]


@dataclasses.dataclass(frozen=True)
class COOGraph:
    """Edge-list graph. ``src[i] -> dst[i]`` is a directed edge."""

    src: np.ndarray  # (E,) uint32
    dst: np.ndarray  # (E,) uint32
    num_vertices: int
    weights: Optional[np.ndarray] = None  # (E,) float32 (SSSP)

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """CSR adjacency: ``indices[indptr[v]:indptr[v+1]]`` are v's neighbors."""

    indptr: np.ndarray  # (V+1,) int64
    indices: np.ndarray  # (E,) uint32
    num_vertices: int
    weights: Optional[np.ndarray] = None

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v] : self.indptr[v + 1]]


def coo_to_csr(g: COOGraph) -> CSRGraph:
    """Sort edges by src and build the pointer array (row = src)."""
    order = np.argsort(g.src, kind="stable")
    src = g.src[order]
    indices = g.dst[order].astype(np.uint32)
    weights = g.weights[order] if g.weights is not None else None
    counts = np.bincount(src, minlength=g.num_vertices)
    indptr = np.zeros(g.num_vertices + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return CSRGraph(indptr=indptr, indices=indices, num_vertices=g.num_vertices, weights=weights)


def csr_to_coo(g: CSRGraph) -> COOGraph:
    src = np.repeat(
        np.arange(g.num_vertices, dtype=np.uint32), np.diff(g.indptr).astype(np.int64)
    )
    return COOGraph(src=src, dst=g.indices.astype(np.uint32), num_vertices=g.num_vertices,
                    weights=g.weights)


def inverse_coo(g: COOGraph) -> COOGraph:
    """Reverse every edge. inverse + coo_to_csr == the paper's inverse CSR."""
    return COOGraph(src=g.dst, dst=g.src, num_vertices=g.num_vertices, weights=g.weights)


def symmetrize(g: COOGraph) -> COOGraph:
    """Add reverse edges (WCC works on the undirected closure)."""
    src = np.concatenate([g.src, g.dst])
    dst = np.concatenate([g.dst, g.src])
    w = np.concatenate([g.weights, g.weights]) if g.weights is not None else None
    return deduplicate(COOGraph(src=src, dst=dst, num_vertices=g.num_vertices, weights=w))


def deduplicate(g: COOGraph) -> COOGraph:
    key = g.src.astype(np.int64) * g.num_vertices + g.dst.astype(np.int64)
    _, idx = np.unique(key, return_index=True)
    w = g.weights[idx] if g.weights is not None else None
    return COOGraph(src=g.src[idx], dst=g.dst[idx], num_vertices=g.num_vertices, weights=w)


def out_degrees(g: COOGraph) -> np.ndarray:
    return np.bincount(g.src, minlength=g.num_vertices).astype(np.int64)


def in_degrees(g: COOGraph) -> np.ndarray:
    return np.bincount(g.dst, minlength=g.num_vertices).astype(np.int64)


def rmat(
    scale: int,
    edge_factor: int = 16,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
    dedup: bool = True,
) -> COOGraph:
    """Graph500 R-MAT generator (the paper's rmat-24-16 / rmat-21-86)."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = n * edge_factor
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    ab, abc = a + b, a + b + c
    for _bit in range(scale):
        # quadrant probabilities: a (00), b (01), c (10), d (11)
        r = rng.random(m)
        src_bit = (r >= ab).astype(np.int64)  # quadrant c or d -> src high bit
        dst_bit = (((r >= a) & (r < ab)) | (r >= abc)).astype(np.int64)  # b or d
        src = (src << 1) | src_bit
        dst = (dst << 1) | dst_bit
    g = COOGraph(src=src.astype(np.uint32), dst=dst.astype(np.uint32), num_vertices=n)
    return deduplicate(g) if dedup else g


def erdos_renyi(n: int, m: int, seed: int = 0) -> COOGraph:
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, size=m, dtype=np.int64)
    dst = rng.integers(0, n, size=m, dtype=np.int64)
    keep = src != dst
    return deduplicate(
        COOGraph(src=src[keep].astype(np.uint32), dst=dst[keep].astype(np.uint32), num_vertices=n)
    )


def grid_2d(rows: int, cols: int) -> COOGraph:
    """Road-network-like high-diameter graph (roadnet-ca stand-in)."""
    idx = np.arange(rows * cols).reshape(rows, cols)
    right = np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], axis=0)
    down = np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], axis=0)
    e = np.concatenate([right, down], axis=1)
    g = COOGraph(src=e[0].astype(np.uint32), dst=e[1].astype(np.uint32), num_vertices=rows * cols)
    return symmetrize(g)


def chain(n: int) -> COOGraph:
    src = np.arange(n - 1, dtype=np.uint32)
    return COOGraph(src=src, dst=src + 1, num_vertices=n)


def star(n: int) -> COOGraph:
    """Hub 0 -> spokes 1..n-1 (wiki-talk-like low average degree)."""
    dst = np.arange(1, n, dtype=np.uint32)
    return COOGraph(src=np.zeros(n - 1, dtype=np.uint32), dst=dst, num_vertices=n)


def complete(n: int) -> COOGraph:
    s, d = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    keep = s != d
    return COOGraph(
        src=s[keep].astype(np.uint32), dst=d[keep].astype(np.uint32), num_vertices=n
    )


def karate_club() -> COOGraph:
    """Zachary's karate club — a tiny real graph embedded for exact oracles."""
    edges = [
        (0, 1), (0, 2), (0, 3), (0, 4), (0, 5), (0, 6), (0, 7), (0, 8), (0, 10),
        (0, 11), (0, 12), (0, 13), (0, 17), (0, 19), (0, 21), (0, 31), (1, 2),
        (1, 3), (1, 7), (1, 13), (1, 17), (1, 19), (1, 21), (1, 30), (2, 3),
        (2, 7), (2, 8), (2, 9), (2, 13), (2, 27), (2, 28), (2, 32), (3, 7),
        (3, 12), (3, 13), (4, 6), (4, 10), (5, 6), (5, 10), (5, 16), (6, 16),
        (8, 30), (8, 32), (8, 33), (9, 33), (13, 33), (14, 32), (14, 33),
        (15, 32), (15, 33), (18, 32), (18, 33), (19, 33), (20, 32), (20, 33),
        (22, 32), (22, 33), (23, 25), (23, 27), (23, 29), (23, 32), (23, 33),
        (24, 25), (24, 27), (24, 31), (25, 31), (26, 29), (26, 33), (27, 33),
        (28, 31), (28, 33), (29, 32), (29, 33), (30, 32), (30, 33), (31, 32),
        (31, 33), (32, 33),
    ]
    e = np.asarray(edges, dtype=np.uint32)
    return COOGraph(src=e[:, 0], dst=e[:, 1], num_vertices=34)


def bytes_per_edge(g: COOGraph, compressed: bool) -> float:
    """Fig. 1 metric: memory traffic per edge for edge-list vs CSR."""
    if compressed:
        return (4.0 * g.num_edges + 4.0 * (g.num_vertices + 1)) / max(g.num_edges, 1)
    return 8.0 * g.num_edges / max(g.num_edges, 1)
