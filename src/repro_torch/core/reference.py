"""Pure-numpy oracles for the graph problems (test ground truth).

Counterpart of ``repro.core.reference``: deliberately simple O(V+E) / O(V*E)
implementations that define correctness for both engine backends.
"""
from __future__ import annotations

from collections import deque

import numpy as np

from repro_torch.core.graph import COOGraph, coo_to_csr, symmetrize
from repro_torch.core.u32 import U32_MAX

__all__ = ["bfs_reference", "wcc_reference", "sssp_reference", "pagerank_reference"]

INF_U32 = np.uint32(U32_MAX)


def bfs_reference(g: COOGraph, root: int) -> np.ndarray:
    csr = coo_to_csr(g)
    dist = np.full(g.num_vertices, INF_U32, dtype=np.uint32)
    dist[root] = 0
    q = deque([root])
    while q:
        u = q.popleft()
        for v in csr.neighbors(u):
            if dist[v] == INF_U32:
                dist[v] = dist[u] + 1
                q.append(v)
    return dist


def wcc_reference(g: COOGraph) -> np.ndarray:
    und = symmetrize(g)
    csr = coo_to_csr(und)
    comp = np.full(g.num_vertices, INF_U32, dtype=np.uint32)
    for s in range(g.num_vertices):
        if comp[s] != INF_U32:
            continue
        comp[s] = s  # min id in component == first unvisited in increasing order
        q = deque([s])
        while q:
            u = q.popleft()
            for v in csr.neighbors(u):
                if comp[v] == INF_U32:
                    comp[v] = s
                    q.append(v)
    return comp


def sssp_reference(g: COOGraph, root: int) -> np.ndarray:
    """Bellman-Ford (weights default 1.0)."""
    w = g.weights if g.weights is not None else np.ones(g.num_edges, dtype=np.float32)
    inf = np.finfo(np.float32).max
    dist = np.full(g.num_vertices, inf, dtype=np.float32)
    dist[root] = 0.0
    for _ in range(g.num_vertices):
        cand = dist[g.src] + w
        cand[dist[g.src] >= inf] = inf
        new = dist.copy()
        np.minimum.at(new, g.dst, cand.astype(np.float32))
        if np.array_equal(new, dist):
            break
        dist = new
    return dist


def pagerank_reference(
    g: COOGraph, damping: float = 0.85, tol: float = 1e-6, max_iters: int = 1000
) -> np.ndarray:
    """Power iteration with the paper's formula (no dangling redistribution)."""
    n = g.num_vertices
    outdeg = np.bincount(g.src, minlength=n).astype(np.float64)
    inv = np.zeros(n)
    inv[outdeg > 0] = 1.0 / outdeg[outdeg > 0]
    rank = np.full(n, 1.0 / n)
    for _ in range(max_iters):
        z = rank * inv
        acc = np.zeros(n)
        np.add.at(acc, g.dst, z[g.src])
        new = (1.0 - damping) / n + damping * acc
        if np.max(np.abs(new - rank)) < tol:
            rank = new
            break
        rank = new
    return rank.astype(np.float32)
