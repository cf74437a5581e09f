"""The 95th percentile (nearest rank) of the per-solve wall, in ms, over the
window's completed solves."""
import math


def read(t):
    walls = sorted(s["wall_s"] for s in t["solves"])
    if not walls:
        return None
    return 1e3 * walls[max(0, math.ceil(0.95 * len(walls)) - 1)]
