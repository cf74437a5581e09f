"""Share (%) of the profiled sub-window in which no device activity ran:
1 - (union of the trace's device events) / (the sub-window's host-clock
length). The profiler on the card has been seen to drop device events, so
this is a ceiling (``run.py`` prints the events seen beside the launches
counted)."""


def read(t):
    prof = t["profile"]
    if prof is None:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
