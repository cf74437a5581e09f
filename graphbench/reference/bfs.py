"""Plain BFS levels from one root (Graph500 kernel 2), level-synchronous
over the harness's COO arrays; the yardstick of the ``bfs`` solve.

Imports torch and numpy only. ``solve`` gives int64 levels, -1 where the
root does not reach; BFS has no floating point, so ``dtype`` (the control's
lower precision) changes nothing.
"""
from __future__ import annotations

import numpy as np
import torch

# the program's "unreached" level: uint32 all ones
_UNREACHED = np.uint32(0xFFFFFFFF)

# number compared -> limit: levels are integers, so exact
LIMITS = {"bfs_wrong_levels": 0}


def solve(src, dst, weights, num_vertices, root, params, dtype=torch.float64):
    level = torch.full((num_vertices,), -1, dtype=torch.int64, device=src.device)
    frontier = torch.zeros(num_vertices, dtype=torch.bool, device=src.device)
    level[root] = 0
    frontier[root] = True
    depth = 0
    while bool(frontier.any()):
        depth += 1
        reached = torch.zeros_like(frontier)
        reached[dst[frontier[src]]] = True
        frontier = reached & (level < 0)
        level[frontier] = depth
    return level


def compare(got: np.ndarray, want: torch.Tensor) -> dict:
    """``got``: the program's uint32 levels. Counts the vertices whose level
    (or reachability) differs."""
    g = torch.from_numpy(got.astype(np.int64)).to(want.device)
    g[torch.from_numpy(got == _UNREACHED).to(want.device)] = -1
    return {"bfs_wrong_levels": int((g != want).sum())}


def program_form(level: torch.Tensor) -> np.ndarray:
    """A reference answer in the program's form (the control's use)."""
    out = level.cpu().numpy().astype(np.int64)
    return np.where(out < 0, np.int64(_UNREACHED), out).astype(np.uint32)
