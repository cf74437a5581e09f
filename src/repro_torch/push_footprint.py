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
from repro_torch.core.partition import PartitionConfig, partition_2d
from repro_torch.kernels.csr_gather_reduce.ops import choose_src_bits

__all__ = ["auto_push_block", "push_footprint"]


def auto_push_block(total_edges: int, p: int, l: int, gathered: int, peb: int) -> int:
    """The partitioner's ``push_block=None`` rule: about two full push tiles
    of the average bucket degree per block, 32-aligned, at most one gathered
    block (``core.partition._build_tile_layouts``)."""
    avg_deg = total_edges / max(p * l, 1) / max(gathered, 1)
    want = 2.0 * peb / max(avg_deg, 1e-9)
    block = 32 * max(1, int(round(want / 32.0)))
    return min(block, 32 * ((gathered + 31) // 32))


def push_footprint(pg, push_block, peb: int) -> dict:
    """What the push stream of ``pg`` (flat bucket arrays) stacks at
    ``push_block`` (an int, or None for the auto rule)."""
    p, l, gathered = pg.p, pg.l, pg.gathered_size
    total_edges = int(pg.valid.sum())
    bs = push_block or auto_push_block(total_edges, p, l, gathered, peb)
    n_blocks = max(1, -(-gathered // bs))
    tiles = np.zeros((p, l, n_blocks), np.int64)
    bucket_edges = np.zeros((p, l), np.int64)
    for i in range(p):
        for m in range(l):
            src = pg.src_gidx[i, m][pg.valid[i, m]].astype(np.int64)
            counts = np.bincount(src // bs, minlength=n_blocks)
            tiles[i, m] = -(-counts // peb)
            bucket_edges[i, m] = src.size
    tp = max(1, int(tiles.max()))
    src_bits = choose_src_bits(gathered, pg.vertices_per_core)
    slots = p * l * n_blocks * tp * peb
    return {
        "push_block": "auto" if push_block is None else push_block,
        "block_sources": bs,
        "push_eb": peb,
        "shape": [p, l, n_blocks, tp, peb],
        "src_bits": src_bits,
        "word_bytes": slots * 4 * (2 if src_bits == 32 else 1),
        "weight_bytes": slots * 4,
        "coverage_bytes": p * l * n_blocks * tp * coverage_word_count(p, pg.sub_size) * 4,
        "real_tiles": int(tiles.sum()),
        "real_tile_share": float(tiles.sum()) / (p * l * n_blocks * tp),
        "largest_bucket_edges": int(bucket_edges.max()),
        "mean_bucket_edges": float(bucket_edges.mean()),
    }


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
