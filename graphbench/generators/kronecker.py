"""Graph500's Kronecker generator (specification v3, kernel 0) on torch.

For each of ``edge_factor * 2**scale`` edges and each of ``scale`` bits,
the quadrant is drawn from the initiator (a, b, c, d) as the specification's
reference code draws it; vertex labels are then permuted at random and the
edge list shuffled. ``common.undirected`` is kernel 1's graph: no
self-loops, no duplicates, symmetric, and for SSSP (kernel 3) one uniform
[0, 1) weight an undirected edge.
"""
from __future__ import annotations

import torch

from graphbench.generators.common import generator_for, undirected


def generate(cfg: dict, seed: int, device) -> dict:
    gen = generator_for(seed, device)
    scale, n = int(cfg["scale"]), 1 << int(cfg["scale"])
    m = int(cfg["edge_factor"]) * n
    a, b, c = (float(cfg["initiator"][k]) for k in "abc")
    ab, c_norm, a_norm = a + b, c / (1.0 - (a + b)), a / (a + b)
    i = torch.zeros(m, dtype=torch.int64, device=device)
    j = torch.zeros(m, dtype=torch.int64, device=device)
    for bit in range(scale):
        ii = torch.rand(m, generator=gen, device=device) > ab
        jj = torch.rand(m, generator=gen, device=device) > torch.where(
            ii, torch.tensor(c_norm, device=device), torch.tensor(a_norm, device=device))
        i += ii.to(torch.int64) << bit
        j += jj.to(torch.int64) << bit
    perm = torch.randperm(n, generator=gen, device=device)
    order = torch.randperm(m, generator=gen, device=device)
    i, j = perm[i][order], perm[j][order]
    return undirected(i, j, n, gen, weights=cfg.get("weights") is not None)
