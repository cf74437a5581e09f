"""Share (%) of its roofline that the pull gather kernel's sum arm
(``gather_reduce_cores``, ``sum_f32``) reaches in the profiled sub-window:
the least time for the sub-window's PageRank iterations
(``graphbench/roofline/gather_sum.py``) over the kernel's device time. The
kernel's time is the mean of the profiler's events of it times the launches
the port counted, so an event the profiler drops does not shorten it. Read
only where every gather launch of the sub-window is of the sum arm."""
from graphbench.roofline import gather_sum


def read(t):
    prof = t["profile"]
    if prof is None:
        return None
    launches = prof["launches"].get("gather_reduce_cores", {})
    if set(launches) != {"sum_f32"}:
        return None
    hits = [k for name, k in prof["kernels"].items() if "gather_reduce_cores_kernel" in name]
    seen = sum(k["events"] for k in hits)
    if not seen:
        return None
    kernel_s = sum(k["seconds"] for k in hits) / seen * launches["sum_f32"]
    iterations = sum(s["iterations"] for s in prof["solves"] if s["kind"] == "pagerank")
    bound_s, _ = gather_sum.bound_seconds(t["num_vertices"], t["num_edges"], iterations)
    return 100.0 * bound_s / kernel_s
