"""The GAP Benchmark Suite's ``urand`` graph (``-u scale -k degree``) on
torch: ``degree * 2**scale`` edges with both endpoints uniform over the
vertices, made undirected by ``common.undirected``."""
from __future__ import annotations

import torch

from graphbench.generators.common import generator_for, undirected


def generate(cfg: dict, seed: int, device) -> dict:
    gen = generator_for(seed, device)
    n = 1 << int(cfg["scale"])
    m = int(cfg["degree"]) * n
    u = torch.randint(0, n, (m,), generator=gen, device=device)
    v = torch.randint(0, n, (m,), generator=gen, device=device)
    return undirected(u, v, n, gen, weights=cfg.get("weights") is not None)
