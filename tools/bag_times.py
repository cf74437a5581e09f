#!/usr/bin/env python3
"""Time the port's embedding-bag kernel, sum and mean, at the four shapes of
``chip_smoke.py``'s ``bag_kernel`` phase.

    python3 tools/bag_times.py [--src DIR] [--variant NAME] [--rounds 2] [--out FILE]

Shapes, at the published DIN width (D = 18): (a) B = 512, L = 32 over a
10,000-row table; (b) B = 262,144 over the same table; (c) B = 4096, L = 100
over a 10,000,384-row table, 8 id sets in rotation so the rows come from
HBM; (d) B = 1, L = 32. Ids come from ``recsys_batch`` (seed 0), the tables
from a seeded generator on the card. The modes are timed alternately
(sum, mean, mean, sum, ``--rounds`` times); each reading is the device time
per launch by CUDA events around ``--reps`` back-to-back launches, a spin
kernel holding the stream while the host enqueues them (as
``tools/kernel_arm_times.py`` times; the profiler drops device events at
random on the card). Reports the median and min/max per shape and mode, a
SHA-256 of each output and whether it has the plain version's bits, so two
checkouts (``--src``, run A, B, B, A on one machine) compare in time and in
bits. ``--variant NAME`` times a copy of the sources with the text edits of
``VARIANTS[NAME]`` in ``tools/arm_variants.py`` (as ``kernel_arm_times.py``
does). One JSON line goes to stdout (and to ``--out``). Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import hashlib
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SEED = 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--variant", help="a name of tools/arm_variants.py's VARIANTS")
    args = ap.parse_args()
    if args.variant:
        sys.path.insert(0, str(ROOT / "tools"))
        from kernel_arm_times import variant_tree

        args.src = variant_tree(args.src, args.variant)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("bag_times: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.src.resolve()))
    from repro_torch.data.synthetic import recsys_batch
    from repro_torch.kernels.embedding_bag import embedding_bag, embedding_bag_reference

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

    covered = []

    def event_ms(fn):
        """Device ms per call of ``fn`` by CUDA events around ``--reps``
        calls, a spin kernel holding the stream while the host enqueues them
        (``covered``: whether each hold outlasted its enqueue; ``--reps``
        stays well inside the launch queue's depth, past which the host
        would block and the device then wait on its refill)."""
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        hold_s = min(0.2, 1.5 * args.reps * (time.perf_counter() - t))
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(hold_s * 2e9))
        start.record()
        t = time.perf_counter()
        for _ in range(args.reps):
            fn()
        covered.append(time.perf_counter() - t < hold_s)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.reps

    result = {}
    for shape, (table, id_sets) in shapes.items():
        for mode in ("sum", "mean"):  # warm both modes; hash the first id set's output
            out = embedding_bag(table, id_sets[0], mode)
            want = embedding_bag_reference(table, id_sets[0], mode)
            torch.cuda.synchronize()
            result[f"{shape}[{mode}]"] = {
                "sha256": hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest(),
                "plain_bits_equal": bool(torch.equal(out.view(torch.int32),
                                                     want.view(torch.int32))),
                "ms_readings": []}
        cyc = {m: itertools.cycle(id_sets) for m in ("sum", "mean")}
        for mode in ("sum", "mean", "mean", "sum") * args.rounds:
            result[f"{shape}[{mode}]"]["ms_readings"].append(
                event_ms(lambda: embedding_bag(table, next(cyc[mode]), mode)))
    for row in result.values():
        r = row["ms_readings"]
        row.update(ms=float(np.median(r)), ms_min_max=[min(r), max(r)])
    line = json.dumps({"src": str(args.src), "variant": args.variant, "nvidia_smi": smi,
                       "reps": args.reps, "rounds": args.rounds, "times": result,
                       "timed_runs": len(covered), "holds_covered": sum(covered)})
    print(line, flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
