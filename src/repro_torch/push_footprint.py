"""Size the push (scatter) stream for several ``push_block`` values, without
building it.

``stack_push_tiles`` pads every (core, phase, source block) to the fattest
block's tile count ``Tp``, so on a skewed graph the stacked stream can be
far larger than its edges. This counts, from the flat bucket arrays alone,
what ``partition_2d(..., build_push=True, push_block=b)`` would stack for
each ``b``: the shape (p, l, B, Tp, Eb), the bytes of the packed words, the
SSSP weights and the coverage words, and the share of stacked tiles that
hold edges. It is host numpy only; the graph is the one ``chip_smoke.py``
uses (graph500 RMAT, edge factor 16, deduplicated and symmetrized).
``stream_push_footprint`` counts the same from a chunk stream in one pass,
for the streaming build (``chip_smoke.py``'s ``stream_build``).

    PYTHONPATH=src python -m repro_torch.push_footprint --scale 20

prints one JSON line per ``push_block`` ("auto" is the partitioner's own
sizing rule).
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.core import graph as G
from repro_torch.core.frontier_words import coverage_word_count
from repro_torch.core.partition import (
    PartitionConfig, _resolve_dims, count_edge_stream, partition_2d,
)
from repro_torch.kernels.csr_gather_reduce.ops import (
    auto_push_block, choose_src_bits, push_block_edges,
)

__all__ = ["auto_push_block", "push_footprint", "stream_push_footprint"]


def _footprint(src_counts: np.ndarray, push_block, peb: int, sub_size: int, vpc: int) -> dict:
    """The stacked push stream at ``push_block`` (an int, or None for the auto
    rule) from ``src_counts`` (p, l, gathered): real edges a gathered source
    in each (core, phase) bucket."""
    p, l, gathered = src_counts.shape
    bucket_edges = src_counts.sum(axis=2)
    total_edges = int(bucket_edges.sum())
    bs = push_block or auto_push_block(total_edges, p, l, gathered, peb)
    tiles = -(-push_block_edges(src_counts, gathered_size=gathered, block_sources=bs) // peb)
    n_blocks = tiles.shape[-1]
    tp = max(1, int(tiles.max()))
    src_bits = choose_src_bits(gathered, vpc)
    slots = p * l * n_blocks * tp * peb
    return {
        "push_block": "auto" if push_block is None else push_block,
        "block_sources": bs,
        "push_eb": peb,
        "shape": [p, l, n_blocks, tp, peb],
        "src_bits": src_bits,
        "word_bytes": slots * 4 * (2 if src_bits == 32 else 1),
        "weight_bytes": slots * 4,
        "coverage_bytes": p * l * n_blocks * tp * coverage_word_count(p, sub_size) * 4,
        "real_tiles": int(tiles.sum()),
        "real_tile_share": float(tiles.sum()) / (p * l * n_blocks * tp),
        "largest_bucket_edges": int(bucket_edges.max()),
        "mean_bucket_edges": float(bucket_edges.mean()),
    }


def push_footprint(pg, push_block, peb: int) -> dict:
    """What the push stream of ``pg`` (flat bucket arrays) stacks at
    ``push_block`` (an int, or None for the auto rule)."""
    p, l, gathered = pg.p, pg.l, pg.gathered_size
    src_counts = np.zeros((p, l, gathered), np.int64)
    for i in range(p):
        for m in range(l):
            src = pg.src_gidx[i, m][pg.valid[i, m]].astype(np.int64)
            src_counts[i, m] = np.bincount(src, minlength=gathered)
    return _footprint(src_counts, push_block, peb, pg.sub_size, pg.vertices_per_core)


def stream_push_footprint(chunks, num_vertices: int, cfg: PartitionConfig, blocks,
                          peb: int) -> list:
    """``push_footprint`` of the partition ``partition_2d_streaming(chunks,
    num_vertices, cfg)`` would build, for each push block of ``blocks``, from
    one pass of the streaming build's own source counting
    (``count_edge_stream``): no edge is kept, so it sizes graphs whose flat
    arrays would not fit."""
    _, _, sub_size, vpc = _resolve_dims(num_vertices, cfg)
    src_counts = count_edge_stream(chunks, num_vertices, cfg, rows=False, sources=True).src_counts
    return [_footprint(src_counts, b, peb, sub_size, vpc) for b in blocks]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--p", type=int, default=4)
    ap.add_argument("--l", type=int, default=16)
    ap.add_argument("--eb", type=int, default=128)
    ap.add_argument("--blocks", default="auto,2048,8192,65536")
    args = ap.parse_args()
    g = G.symmetrize(G.rmat(args.scale, 16, a=0.57, b=0.19, c=0.19, seed=args.seed))
    pg = partition_2d(g, PartitionConfig(p=args.p, l=args.l, tile_eb=args.eb, build_tiles=False))
    for b in args.blocks.split(","):
        row = push_footprint(pg, None if b == "auto" else int(b), args.eb)
        print(json.dumps({"scale": args.scale, "edges": g.num_edges, **row}), flush=True)


if __name__ == "__main__":
    main()
