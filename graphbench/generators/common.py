"""Kernel 1 of both generators: an edge list made undirected.

Self-loops and duplicate edges are dropped, then each remaining undirected
edge becomes its two directed edges, sorted by (source, destination). A
weight, when asked for, is drawn once an undirected edge and shared by both
directions. Everything stays on the generator's device.
"""
from __future__ import annotations

import torch


def undirected(u: torch.Tensor, v: torch.Tensor, n: int, gen: torch.Generator,
               weights: bool) -> dict:
    keep = u != v
    lo = torch.minimum(u, v)[keep]
    hi = torch.maximum(u, v)[keep]
    key = torch.unique(lo * n + hi)  # sorted: the graph does not depend on draw order
    del lo, hi, keep
    lo, hi = key // n, key % n
    w = (torch.rand(key.numel(), generator=gen, device=key.device, dtype=torch.float32)
         if weights else None)
    src = torch.cat([lo, hi])
    dst = torch.cat([hi, lo])
    order = torch.argsort(src * n + dst)
    return {
        "src": src[order],
        "dst": dst[order],
        "weights": torch.cat([w, w])[order] if w is not None else None,
        "num_vertices": n,
    }


def generator_for(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    return gen
