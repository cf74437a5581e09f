"""Reduce a ``torch.profiler`` trace of the traced sub-window to what the
per-layer readers and the result line need: device busy time (the union of
device activity), device time by kernel name, the device operations that
took most time, and the device's idle gaps named by what the host was
doing meanwhile (the innermost host operation or ``record_function`` range
open at the gap's middle)."""
from __future__ import annotations

import bisect
from collections import defaultdict

TOP = 10
RANGE_PREFIX = "graphbench."  # the harness's record_function ranges
_NAME = 80  # characters of an operation's name kept


def _interval(e):
    return float(e.time_range.start), float(e.time_range.end)


def reduce_events(events, device_type_cuda) -> dict:
    """``events``: ``prof.events()``. Times in the result are seconds."""
    dev, host = [], []
    for e in events:
        start, end = _interval(e)
        if end <= start:
            continue
        if e.device_type != device_type_cuda:
            host.append((start, end, e.name))
        elif not e.name.startswith(RANGE_PREFIX):  # not the ranges' device-side copies
            dev.append((start, end, e.name))
    if not dev:
        return {"device_events": 0}
    by_name = defaultdict(lambda: [0, 0.0])
    for start, end, name in dev:
        by_name[name][0] += 1
        by_name[name][1] += (end - start) * 1e-6
    dev.sort()
    merged = []
    for start, end, _ in dev:
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    busy = sum(end - start for start, end in merged) * 1e-6
    gaps = [(merged[k + 1][0] - merged[k][1], merged[k][1], merged[k + 1][0])
            for k in range(len(merged) - 1)]
    gaps.sort(reverse=True)
    host.sort()
    starts = [h[0] for h in host]
    outer = [h for h in host if h[2].startswith(RANGE_PREFIX)]
    idle_by = defaultdict(float)
    for length, g0, g1 in gaps[:2000]:
        idle_by[_host_at(host, starts, outer, 0.5 * (g0 + g1))] += length * 1e-6
    top_ops = sorted(by_name.items(), key=lambda kv: kv[1][1], reverse=True)[:TOP]
    return {
        "device_events": len(dev),
        "busy_s": busy,
        "span_s": (merged[-1][1] - merged[0][0]) * 1e-6,
        "kernels": {name: {"events": n, "seconds": s} for name, (n, s) in by_name.items()},
        "device_ops": [[name[:_NAME], s] for name, (_, s) in top_ops],
        "idle_gaps": [[name[:_NAME], s] for name, s in
                      sorted(idle_by.items(), key=lambda kv: kv[1], reverse=True)[:TOP]],
    }


def _host_at(host, starts, outer, t, scan=400) -> str:
    """What the host was doing at ``t``: the innermost host operation open
    then (of those open, the one that started last, among the last ``scan``
    to start); where none but the harness's own range around the call
    (``RANGE_PREFIX``) was open, Python in that range, named with the next
    operation it started."""
    k = bisect.bisect_right(starts, t) - 1
    for j in range(k, max(k - scan, -1), -1):
        start, end, name = host[j]
        if end >= t and not name.startswith(RANGE_PREFIX):
            return name
    where = next((name for start, end, name in reversed(outer) if start <= t <= end), "")
    after = next((h[2] for h in host[k + 1:k + 50] if not h[2].startswith(RANGE_PREFIX)), "none")
    return f"python {where[len(RANGE_PREFIX):] if where else 'outside a solve'}, next {after}"
