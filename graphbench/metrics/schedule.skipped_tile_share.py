"""Share (%) of the edge tiles the frontier schedule skips: the mean of
``run_frontier_trace``'s ``mean_dynamic_skipped_tile_fraction`` over the
compared roots' solves that have a frontier schedule."""


def read(t):
    runs = t["schedule"]
    if not runs:
        return None
    return 100.0 * sum(r["mean_skipped"] for r in runs) / len(runs)
