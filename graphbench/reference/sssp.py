"""Plain single-source shortest paths (Graph500 kernel 3): Bellman-Ford
over the active vertices of the harness's COO arrays, in ``dtype``
(float64 for the yardstick, bfloat16 for the control).

Imports torch and numpy only. Distances are +inf where the root does not
reach.
"""
from __future__ import annotations

import numpy as np
import torch

# the program's "unreached" distance: float32's largest finite value
_UNREACHED = np.float32(np.finfo(np.float32).max)

# number compared -> limit (set from sound runs and the control; PERF.md §2)
LIMITS = {"sssp_wrong_reach": 0, "sssp_max_rel_err": 2e-4}


def solve(src, dst, weights, num_vertices, root, params, dtype=torch.float64):
    dist = torch.full((num_vertices,), float("inf"), dtype=dtype, device=src.device)
    dist[root] = 0.0
    w = weights.to(dtype)
    active = torch.zeros(num_vertices, dtype=torch.bool, device=src.device)
    active[root] = True
    while bool(active.any()):
        on = active[src]
        cand = dist[src[on]] + w[on]
        new = dist.scatter_reduce(0, dst[on], cand, reduce="amin")
        active = new < dist
        dist = new
    return dist


def compare(got: np.ndarray, want: torch.Tensor) -> dict:
    """``got``: the program's float32 distances. Counts the vertices whose
    reachability differs, and takes the largest relative error of the rest
    against the reference's distance (0 where both are 0)."""
    g = torch.from_numpy(got).to(want.device)
    g_reach = g < float(_UNREACHED)
    w_reach = torch.isfinite(want)
    both = g_reach & w_reach
    ref = want[both].to(torch.float64)
    err = (g[both].to(torch.float64) - ref).abs() / ref.abs().clamp_min(1e-300)
    return {
        "sssp_wrong_reach": int((g_reach != w_reach).sum()),
        "sssp_max_rel_err": float(err.max()) if err.numel() else 0.0,
    }


def program_form(dist: torch.Tensor) -> np.ndarray:
    """A reference answer in the program's form (the control's use)."""
    out = dist.to(torch.float32).cpu().numpy()
    return np.where(np.isfinite(out), out, _UNREACHED).astype(np.float32)
