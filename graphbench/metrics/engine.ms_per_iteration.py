"""Milliseconds of wall an engine iteration, over the window's completed
solves: the sum of their walls over the sum of their
``EngineResult.iterations`` (label init and copy-back included)."""


def read(t):
    its = sum(s["iterations"] for s in t["solves"])
    if not its:
        return None
    return 1e3 * sum(s["wall_s"] for s in t["solves"]) / its
