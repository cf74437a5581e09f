"""Roots drawn from the seed, uniformly among the vertices of the largest
connected component (a random order of them, walked from the start)."""
from __future__ import annotations

import numpy as np


def roots(graph, seed: int) -> np.ndarray:
    members = np.flatnonzero(graph.components() == graph.largest_component())
    return np.random.default_rng([int(seed), 1]).permutation(members)
