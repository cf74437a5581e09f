"""Plain PageRank with the GAP Benchmark Suite's semantics: ranks start at
1/n; each iteration every vertex gets (1-d)/n plus d times the sum of
rank/out-degree over its in-edges; no dangling redistribution; a fixed
number of iterations (``params["iterations"]``). Over the harness's COO
arrays, in ``dtype`` (float64 for the yardstick, bfloat16 for the control).

Imports torch and numpy only.
"""
from __future__ import annotations

import numpy as np
import torch

# number compared -> limit (set from sound runs and the control; PERF.md §2)
LIMITS = {"pagerank_max_rel_err": 2e-4}


def solve(src, dst, weights, num_vertices, root, params, dtype=torch.float64):
    n = num_vertices
    d = float(params["damping"])
    deg = torch.bincount(src, minlength=n).to(dtype)
    inv = torch.where(deg > 0, 1.0 / deg, torch.zeros_like(deg))
    rank = torch.full((n,), 1.0 / n, dtype=dtype, device=src.device)
    base = torch.tensor((1.0 - d) / n, dtype=dtype, device=src.device)
    for _ in range(int(params["iterations"])):
        contrib = (rank * inv)[src]
        acc = torch.zeros(n, dtype=dtype, device=src.device).index_add_(0, dst, contrib)
        rank = base + d * acc
    return rank


def compare(got: np.ndarray, want: torch.Tensor) -> dict:
    """``got``: the program's float32 ranks. The largest relative error
    over the vertices (every rank is at least (1-d)/n > 0)."""
    g = torch.from_numpy(got).to(want.device, torch.float64)
    ref = want.to(torch.float64)
    return {"pagerank_max_rel_err": float(((g - ref).abs() / ref).max())}


def program_form(rank: torch.Tensor) -> np.ndarray:
    """A reference answer in the program's form (the control's use)."""
    return rank.to(torch.float32).cpu().numpy()
