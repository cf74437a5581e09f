"""Graph500-style streaming R-MAT generator (Kronecker a/b/c/d quadrants).

Counterpart of ``repro.data.rmat``: the same numpy RNG calls in the same
order, so a stream's chunks are byte-identical to the reference's.

The in-memory ``core.graph.rmat`` materializes the full ``(E, 2)`` edge
array — fine for unit-test scales, hopeless at graph500 scales where the edge
list alone dwarfs the packed partition it becomes. This module generates the
SAME family of graphs as a re-iterable stream of edge chunks, the ingestion
protocol ``partition_2d_streaming`` consumes: edges are produced
``chunk_edges`` at a time, each chunk seeded independently from
``(seed, chunk_index)`` so the stream replays bit-identically on every pass
(the two-pass builder's hard requirement) without any state carried between
chunks — and chunk k can be regenerated without generating chunks 0..k-1.

No global deduplication: a streaming generator cannot see across chunks, and
graph500 explicitly permits multi-edges and self-loops in the generated edge
list. All engine problems tolerate duplicates (min/or reduces are idempotent;
PageRank treats a duplicate as a parallel edge), so benchmark MTEPS rates are
computed over the generated edge count, duplicates included — exactly how
graph500 counts TEPS.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.graph import COOGraph

__all__ = ["RMATStream", "rmat_chunks", "materialize"]


@dataclasses.dataclass(frozen=True)
class RMATStream:
    """A replayable chunked R-MAT edge stream.

    Calling the stream opens one pass over its chunks (each a ``(src, dst)``
    or ``(src, dst, weights)`` tuple), so an ``RMATStream`` is itself a valid
    ``chunks`` argument for ``partition_2d_streaming``. ``num_edges`` counts
    generated (directed) edges, doubled when ``symmetric``.
    """

    scale: int
    edge_factor: int = 16
    a: float = 0.57
    b: float = 0.19
    c: float = 0.19
    seed: int = 0
    chunk_edges: int = 1 << 18
    symmetric: bool = False
    weighted: bool = False

    def __post_init__(self):
        if self.scale < 1:
            raise ValueError(f"scale must be >= 1, got {self.scale}")
        if self.edge_factor < 1:
            raise ValueError(f"edge_factor must be >= 1, got {self.edge_factor}")
        if self.chunk_edges < 1:
            raise ValueError(f"chunk_edges must be >= 1, got {self.chunk_edges}")
        if not (0.0 < self.a and 0.0 <= self.b and 0.0 <= self.c
                and self.a + self.b + self.c < 1.0):
            raise ValueError(
                f"quadrant probabilities must satisfy a > 0, b, c >= 0, "
                f"a + b + c < 1 (d is the remainder): "
                f"a={self.a}, b={self.b}, c={self.c}"
            )

    @property
    def num_vertices(self) -> int:
        return 1 << self.scale

    @property
    def base_edges(self) -> int:
        """Directed edges before symmetrization."""
        return self.num_vertices * self.edge_factor

    @property
    def num_edges(self) -> int:
        return self.base_edges * (2 if self.symmetric else 1)

    @property
    def num_chunks(self) -> int:
        return -(-self.base_edges // self.chunk_edges)

    def _chunk(self, idx: int):
        """Generate chunk ``idx`` — a pure function of (params, seed, idx)."""
        start = idx * self.chunk_edges
        m = min(self.chunk_edges, self.base_edges - start)
        # independent per-chunk entropy: replay and random access both free
        rng = np.random.default_rng([self.seed, idx])
        src = np.zeros(m, dtype=np.int64)
        dst = np.zeros(m, dtype=np.int64)
        ab, abc = self.a + self.b, self.a + self.b + self.c
        for _bit in range(self.scale):
            # quadrant probabilities: a (00), b (01), c (10), d (11)
            r = rng.random(m)
            src_bit = (r >= ab).astype(np.int64)  # c or d -> src high bit
            dst_bit = (((r >= self.a) & (r < ab)) | (r >= abc)).astype(np.int64)
            src = (src << 1) | src_bit
            dst = (dst << 1) | dst_bit
        if self.symmetric:
            src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        if self.weighted:
            w = rng.random(src.shape[0]).astype(np.float32)
            return src, dst, w
        return src, dst

    def __call__(self):
        for idx in range(self.num_chunks):
            yield self._chunk(idx)


def rmat_chunks(
    scale: int,
    edge_factor: int = 16,
    *,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
    chunk_edges: int = 1 << 18,
    symmetric: bool = False,
    weighted: bool = False,
) -> RMATStream:
    """Seeded graph500-style chunked R-MAT stream (see ``RMATStream``)."""
    return RMATStream(
        scale=scale, edge_factor=edge_factor, a=a, b=b, c=c, seed=seed,
        chunk_edges=chunk_edges, symmetric=symmetric, weighted=weighted,
    )


def materialize(stream: RMATStream) -> COOGraph:
    """Concatenate a stream's chunks into one in-RAM COOGraph — the edge list
    is IDENTICAL (same edges, same order) to what the chunks yield, so an
    in-memory ``partition_2d`` of the result is the bit-identity oracle for
    ``partition_2d_streaming(stream, ...)``. Only for scales where O(E) host
    RAM is acceptable (tests, agreement checks)."""
    chunks = list(stream())
    src = np.concatenate([ch[0] for ch in chunks])
    dst = np.concatenate([ch[1] for ch in chunks])
    w = (
        np.concatenate([ch[2] for ch in chunks]).astype(np.float32)
        if stream.weighted
        else None
    )
    return COOGraph(
        src=src.astype(np.uint32),
        dst=dst.astype(np.uint32),
        num_vertices=stream.num_vertices,
        weights=w,
    )
