"""Synthetic data: serving traffic (query streams, edge-insertion streams),
LM token batches, recsys batches and graph batches.

Counterpart of the serving, skewed-graph, path-grid, LM, recsys and graph generators
of ``repro.data.synthetic``: the same numpy RNG calls in the same order, so the
same seed gives the same arrays in both packages. Everything is drawn on the
host with numpy; the graph generators wrap the arrays in a ``GraphBatch`` of
CPU tensors (``GraphBatch.to`` moves it).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core.graph import COOGraph
from repro_torch.models.gnn.common import GraphBatch

__all__ = [
    "QUERY_KINDS",
    "DEFAULT_QUERY_MIX",
    "query_workload",
    "mixed_query_workload",
    "edge_insertion_stream",
    "admission_batches",
    "skewed_graph",
    "path_grid_graph",
    "lm_batch",
    "recsys_batch",
    "retrieval_batch",
    "random_positions_distances",
    "graph_batch_from_coo",
    "batched_molecules",
]

QUERY_KINDS = ("bfs", "sssp", "ppr", "recommend", "neighbors")
DEFAULT_QUERY_MIX = {"bfs": 0.35, "sssp": 0.2, "ppr": 0.2, "recommend": 0.25}


def query_workload(
    num_queries: int,
    num_vertices: int,
    *,
    zipf_a: float = 1.2,
    hot_fraction: float = 0.1,
    seed: int = 0,
) -> np.ndarray:
    """Multi-root query stream for the lane-batched traversal path: root ids
    for ``num_queries`` point queries (BFS roots / SSSP sources / PPR seeds)
    with SKEWED root popularity — real query traffic concentrates on hub
    entities, so admission batches contain duplicate roots and the packed
    lane layout must stay correct under them (the bit-OR init regression).

    A random ``hot_fraction`` of the vertex set forms the popularity-ranked
    head; each query picks rank ``r ~ Zipf(zipf_a)`` (clamped into the head)
    with probability ~rank^-a, so a handful of hot roots dominate while the
    tail keeps full-vertex-range coverage. Deterministic in ``seed``;
    returns (num_queries,) int64.
    """
    if num_vertices < 1 or num_queries < 1:
        raise ValueError((num_queries, num_vertices))
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, num_queries, num_vertices])
    )
    head = max(1, int(num_vertices * hot_fraction))
    # popularity rank -> vertex id: a seeded permutation, so hot roots are
    # scattered over the id space (and over graph cores / phases)
    by_rank = rng.permutation(num_vertices)
    ranks = np.minimum(rng.zipf(zipf_a, size=num_queries) - 1, head - 1)
    return by_rank[ranks].astype(np.int64)


def mixed_query_workload(
    num_queries: int,
    num_vertices: int,
    *,
    mix: dict | None = None,
    zipf_a: float = 1.2,
    hot_fraction: float = 0.1,
    seed: int = 0,
) -> list:
    """Mixed-op query stream for the always-on serving loop (repro_torch.serve):
    each query is a dict ``{"kind", "root", "target"}`` with ``kind`` drawn
    from ``mix`` (default ``DEFAULT_QUERY_MIX`` over bfs/sssp/ppr/recommend;
    weights are normalized) and zipf-skewed roots shared across kinds — hot
    entities are hot for EVERY traffic class, so same-kind admission
    coalescing sees duplicate roots inside one batch. ``target`` (the
    distance-to endpoint for bfs/sssp; ignored by other kinds) is drawn from
    the same skewed popularity head. Deterministic in ``seed``."""
    mix = dict(DEFAULT_QUERY_MIX) if mix is None else dict(mix)
    bad = sorted(set(mix) - set(QUERY_KINDS))
    if bad:
        raise ValueError(f"unknown query kinds {bad}; supported: {QUERY_KINDS}")
    total = float(sum(mix.values()))
    if total <= 0:
        raise ValueError(f"mix weights must sum > 0: {mix}")
    kinds = sorted(mix)
    probs = np.asarray([mix[k] / total for k in kinds], dtype=np.float64)
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, 11, num_queries, num_vertices])
    )
    roots = query_workload(
        num_queries, num_vertices, zipf_a=zipf_a,
        hot_fraction=hot_fraction, seed=seed,
    )
    targets = query_workload(
        num_queries, num_vertices, zipf_a=zipf_a,
        hot_fraction=hot_fraction, seed=seed + 1,
    )
    picks = rng.choice(len(kinds), size=num_queries, p=probs)
    return [
        {"kind": kinds[picks[i]], "root": int(roots[i]), "target": int(targets[i])}
        for i in range(num_queries)
    ]


def edge_insertion_stream(
    num_edges: int,
    num_vertices: int,
    *,
    num_batches: int = 1,
    hub_fraction: float = 0.05,
    hub_bias: float = 0.5,
    weighted: bool = False,
    seed: int = 0,
) -> list:
    """Streaming edge-insertion batches for delta ingest (repro_torch.serve.delta):
    returns ``num_batches`` tuples ``(src, dst, weights-or-None)`` covering
    ``num_edges`` total insertions. Destinations are biased so ``hub_bias``
    of the edges land on a ``hub_fraction`` head of the vertex set —
    sustained ingest concentrates on few (core, phase) buckets (the dirty-
    row-block regime) and keeps growing heavy rows, eventually driving them
    over the hub-split threshold. Deterministic in ``seed``."""
    if num_edges < 0 or num_batches < 1 or num_vertices < 1:
        raise ValueError((num_edges, num_batches, num_vertices))
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, 13, num_edges, num_vertices])
    )
    head = max(1, int(num_vertices * hub_fraction))
    hubs = rng.permutation(num_vertices)[:head]
    src = rng.integers(0, num_vertices, num_edges).astype(np.int64)
    dst = rng.integers(0, num_vertices, num_edges).astype(np.int64)
    to_hub = rng.random(num_edges) < hub_bias
    dst[to_hub] = hubs[rng.integers(0, head, int(to_hub.sum()))]
    w = (rng.random(num_edges) + 0.1).astype(np.float32) if weighted else None
    bounds = np.linspace(0, num_edges, num_batches + 1).astype(np.int64)
    return [
        (src[a:b], dst[a:b], w[a:b] if w is not None else None)
        for a, b in zip(bounds[:-1], bounds[1:])
    ]


def admission_batches(roots: np.ndarray, lanes: int) -> list:
    """Chunk a query stream into K-lane admission batches for the serving
    loop; the final partial batch is padded by repeating its last root
    (duplicate lanes are cheap — same packed word — and keep every batch at
    one width)."""
    if lanes < 1:
        raise ValueError(f"lanes must be >= 1, got {lanes}")
    roots = np.asarray(roots)
    out = []
    for i in range(0, len(roots), lanes):
        chunk = roots[i : i + lanes]
        served = len(chunk)
        if served < lanes:
            chunk = np.concatenate(
                [chunk, np.repeat(chunk[-1:], lanes - served)]
            )
        out.append((chunk, served))
    return out


def skewed_graph(
    n: int,
    *,
    kind: str = "star",
    hub_in_degree: int | None = None,
    num_hubs: int = 1,
    avg_degree: int = 2,
    zipf_a: float = 1.6,
    seed: int = 0,
):
    """Skew-heavy COOGraph generator for the hub-row-splitting perf path.

    The engine pulls along IN-edges, so the load of a kernel row is a
    vertex's in-degree — skew is therefore injected on the DESTINATION side
    (unlike ``graph.star``, whose hub has out-degree n-1 but in-degree 0).

      kind='star':     ``num_hubs`` hub vertices (ids 0..num_hubs-1) each
                       receive ``hub_in_degree`` edges from uniform sources
                       (duplicates kept: a multigraph, so hub in-degree can
                       exceed n), plus a uniform background of n*avg_degree
                       edges. wiki-talk-like: one row dwarfs the rest.
      kind='powerlaw': in-degrees follow a Zipf(``zipf_a``) rank profile
                       capped at ``hub_in_degree`` — RMAT-like heavy tail
                       with tunable hub mass.

    Deterministic in ``seed``. Returns a ``core.graph.COOGraph``.
    """
    rng = np.random.default_rng(np.random.SeedSequence([seed, n, num_hubs]))
    if hub_in_degree is None:
        hub_in_degree = n // 2
    if kind == "star":
        hub_dst = np.repeat(
            np.arange(num_hubs, dtype=np.uint32), hub_in_degree
        )
        hub_src = rng.integers(0, n, hub_dst.shape[0]).astype(np.uint32)
        bg_src = rng.integers(0, n, n * avg_degree).astype(np.uint32)
        bg_dst = rng.integers(0, n, n * avg_degree).astype(np.uint32)
        src = np.concatenate([hub_src, bg_src])
        dst = np.concatenate([hub_dst, bg_dst])
    elif kind == "powerlaw":
        ranks = np.arange(1, n + 1, dtype=np.float64)
        deg = np.minimum(
            np.maximum((hub_in_degree / ranks**zipf_a), 1.0).astype(np.int64),
            hub_in_degree,
        )
        dst = np.repeat(np.arange(n, dtype=np.uint32), deg)
        src = rng.integers(0, n, dst.shape[0]).astype(np.uint32)
    else:
        raise ValueError(f"kind must be 'star' or 'powerlaw', got {kind!r}")
    order = rng.permutation(src.shape[0])
    return COOGraph(src=src[order], dst=dst[order], num_vertices=n)


def path_grid_graph(
    width: int,
    height: int = 1,
    *,
    shuffle: bool = False,
    seed: int = 0,
):
    """High-diameter COOGraph for the frontier-aware dynamic-skip path.

    A ``width`` x ``height`` grid with bidirectional nearest-neighbour edges
    (``height=1`` degenerates to a simple path). BFS/SSSP from a corner takes
    ~``width + height`` iterations with a frontier that is a thin wavefront.
    ``shuffle=True`` applies a random permutation to the vertex ids, which
    scatters the frontier across tiles. Deterministic in ``seed``."""
    n = width * height
    vid = np.arange(n, dtype=np.uint32).reshape(height, width)
    right = np.stack([vid[:, :-1].ravel(), vid[:, 1:].ravel()])
    down = np.stack([vid[:-1, :].ravel(), vid[1:, :].ravel()])
    a = np.concatenate([right[0], down[0]])
    b = np.concatenate([right[1], down[1]])
    src = np.concatenate([a, b])
    dst = np.concatenate([b, a])
    if shuffle:
        perm = np.random.default_rng(
            np.random.SeedSequence([seed, width, height])
        ).permutation(n).astype(np.uint32)
        src, dst = perm[src], perm[dst]
    return COOGraph(src=src, dst=dst, num_vertices=n)


def lm_batch(seed: int, step: int, batch: int, seq: int, vocab: int) -> Dict[str, np.ndarray]:
    """Zipf-distributed token stream with next-token labels (int32)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    toks = rng.zipf(1.3, size=(batch, seq + 1)).astype(np.int64)
    toks = np.minimum(toks, vocab - 1).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def recsys_batch(
    seed: int, step: int, batch: int, seq_len: int, item_vocab: int, cate_vocab: int,
    profile_len: int = 32,
) -> Dict[str, np.ndarray]:
    """One DIN click batch: padded behaviour histories, targets, a multi-hot
    profile bag with ~30% padding, and click labels."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step, 7]))
    hist_items = rng.integers(0, item_vocab, (batch, seq_len)).astype(np.int32)
    lengths = rng.integers(5, seq_len + 1, (batch,))
    mask = np.arange(seq_len)[None, :] < lengths[:, None]
    hist_items = np.where(mask, hist_items, -1)
    hist_cates = np.where(mask, hist_items % cate_vocab, -1).astype(np.int32)
    target_item = rng.integers(0, item_vocab, (batch,)).astype(np.int32)
    profile = rng.integers(0, cate_vocab, (batch, profile_len)).astype(np.int32)
    profile[rng.random((batch, profile_len)) < 0.3] = -1
    # click label correlated with overlap of target category and history
    overlap = (hist_cates == (target_item % cate_vocab)[:, None]).sum(1)
    p = 1.0 / (1.0 + np.exp(-(overlap - 1.0)))
    labels = (rng.random(batch) < p).astype(np.float32)
    return {
        "hist_items": hist_items,
        "hist_cates": hist_cates,
        "target_item": target_item,
        "target_cate": (target_item % cate_vocab).astype(np.int32),
        "profile_bag": profile,
        "labels": labels,
    }


def retrieval_batch(
    seed: int, seq_len: int, n_candidates: int, item_vocab: int, cate_vocab: int,
    profile_len: int = 32,
) -> Dict[str, np.ndarray]:
    """One user (a full history and profile bag) against ``n_candidates``
    random items."""
    rng = np.random.default_rng(seed)
    hist = rng.integers(0, item_vocab, (1, seq_len)).astype(np.int32)
    cand = rng.integers(0, item_vocab, (n_candidates,)).astype(np.int32)
    return {
        "hist_items": hist,
        "hist_cates": (hist % cate_vocab).astype(np.int32),
        "profile_bag": rng.integers(0, cate_vocab, (1, profile_len)).astype(np.int32),
        "cand_items": cand,
        "cand_cates": (cand % cate_vocab).astype(np.int32),
    }


def random_positions_distances(rng, src, dst, n_nodes, box: float = 10.0):
    pos = rng.random((n_nodes, 3)).astype(np.float32) * box
    d = np.linalg.norm(pos[src] - pos[dst], axis=-1).astype(np.float32)
    return pos, d


def _batch(**arrays) -> GraphBatch:
    n_graphs = arrays.pop("n_graphs")
    return GraphBatch(n_graphs=n_graphs, **{
        k: torch.from_numpy(v) if v is not None else None for k, v in arrays.items()
    })


def graph_batch_from_coo(
    src: np.ndarray,
    dst: np.ndarray,
    n_nodes: int,
    d_feat: int,
    seed: int = 0,
    n_classes: int = 8,
    with_dist: bool = True,
) -> Tuple[GraphBatch, np.ndarray]:
    """Single full graph -> GraphBatch (CPU tensors) + node labels (numpy):
    features, labels, then positions, drawn in that order."""
    rng = np.random.default_rng(seed)
    feat = rng.standard_normal((n_nodes, d_feat)).astype(np.float32)
    labels = rng.integers(0, n_classes, (n_nodes,)).astype(np.int32)
    dist = None
    if with_dist:
        _, dist = random_positions_distances(rng, src, dst, n_nodes)
    batch = _batch(
        node_feat=feat,
        edge_src=src.astype(np.int32),
        edge_dst=dst.astype(np.int32),
        node_mask=np.ones(n_nodes, bool),
        edge_mask=np.ones(len(src), bool),
        graph_id=np.zeros(n_nodes, np.int32),
        n_graphs=1,
        edge_dist=dist,
    )
    return batch, labels


def batched_molecules(
    seed: int, n_graphs: int, nodes_per: int, edges_per: int, d_feat: int,
    n_classes: int = 2,
) -> Tuple[GraphBatch, np.ndarray]:
    """TU-style batch of small graphs (molecule shape: 30 nodes / 64 edges)."""
    rng = np.random.default_rng(seed)
    n = n_graphs * nodes_per
    e = n_graphs * edges_per
    src = np.zeros(e, np.int32)
    dst = np.zeros(e, np.int32)
    for g in range(n_graphs):
        s = rng.integers(0, nodes_per, edges_per)
        d = rng.integers(0, nodes_per, edges_per)
        src[g * edges_per : (g + 1) * edges_per] = g * nodes_per + s
        dst[g * edges_per : (g + 1) * edges_per] = g * nodes_per + d
    feat = rng.standard_normal((n, d_feat)).astype(np.float32)
    _, dist = random_positions_distances(rng, src, dst, n)
    batch = _batch(
        node_feat=feat,
        edge_src=src,
        edge_dst=dst,
        node_mask=np.ones(n, bool),
        edge_mask=np.ones(e, bool),
        graph_id=np.repeat(np.arange(n_graphs, dtype=np.int32), nodes_per),
        n_graphs=n_graphs,
        edge_dist=dist,
    )
    labels = rng.integers(0, n_classes, (n_graphs,)).astype(np.int32)
    return batch, labels
