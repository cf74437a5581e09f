"""Share (%) of iterations that took the push direction, over the same
``run_frontier_trace`` runs as ``schedule.skipped_tile_share``."""


def read(t):
    its = sum(r["iterations"] for r in t["schedule"])
    if not its:
        return None
    return 100.0 * sum(r["push_iterations"] for r in t["schedule"]) / its
