#!/usr/bin/env python3
"""Time the port's embedding-bag kernel, sum and mean, at the four shapes of
``chip_smoke.py``'s ``bag_kernel`` phase.

    python3 tools/bag_times.py [--src DIR] [--rounds 2] [--out FILE]

Shapes, at the published DIN width (D = 18): (a) B = 512, L = 32 over a
10,000-row table; (b) B = 262,144 over the same table; (c) B = 4096, L = 100
over a 10,000,384-row table, 8 id sets in rotation so the rows come from
HBM; (d) B = 1, L = 32. Ids come from ``recsys_batch`` (seed 0), the tables
from a seeded generator on the card. The modes are timed alternately
(sum, mean, mean, sum, ``--rounds`` times); each reading is the device time
per launch over ``--reps`` launches (torch.profiler, the kernel's own
events). Reports the median and min/max per shape and mode, and a SHA-256 of
each output, so two checkouts (``--src``, run A, B, B, A on one machine)
compare in time and in bits. One JSON line goes to stdout (and to
``--out``). Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import hashlib
import itertools
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SEED = 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("bag_times: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.src.resolve()))
    from repro_torch.data.synthetic import recsys_batch
    from repro_torch.kernels.embedding_bag import embedding_bag

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cate = torch.randn(10_000, 18, generator=gen, device=dev)
    items = torch.randn(10_000_384, 18, generator=gen, device=dev)

    def ids(batch, step, key, vocab_items=10_000_384):
        b = recsys_batch(SEED, step, batch, 100, vocab_items, 10_000, 32)[key]
        return torch.from_numpy(np.ascontiguousarray(b, dtype=np.int32)).to(dev)

    shapes = {
        "a_serve_p99": (cate, [ids(512, 0, "profile_bag")]),
        "b_serve_bulk": (cate, [ids(262_144, 1, "profile_bag")]),
        "c_cold_items": (items, [ids(4096, 2 + k, "hist_items") for k in range(8)]),
        "d_one_bag": (cate, [ids(1, 10, "profile_bag")]),
    }

    def device_ms(fn):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(args.reps):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        us = sum(getattr(e, "self_device_time_total", 0) for e in evs
                 if "embedding_bag_kernel" in e.key)
        return us / 1e3 / args.reps

    result = {}
    for shape, (table, id_sets) in shapes.items():
        for mode in ("sum", "mean"):  # warm both modes; hash the first id set's output
            out = embedding_bag(table, id_sets[0], mode)
            torch.cuda.synchronize()
            result[f"{shape}[{mode}]"] = {
                "sha256": hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest(), "ms_readings": []}
        cyc = {m: itertools.cycle(id_sets) for m in ("sum", "mean")}
        for mode in ("sum", "mean", "mean", "sum") * args.rounds:
            result[f"{shape}[{mode}]"]["ms_readings"].append(
                device_ms(lambda: embedding_bag(table, next(cyc[mode]), mode)))
    for row in result.values():
        r = row["ms_readings"]
        row.update(ms=float(np.median(r)), ms_min_max=[min(r), max(r)])
    line = json.dumps({"src": str(args.src), "nvidia_smi": smi, "reps": args.reps,
                       "rounds": args.rounds, "times": result})
    print(line, flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
