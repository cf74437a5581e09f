#!/usr/bin/env python3
"""Time the port's flash-attention kernel at the shapes of ``chip_smoke.py``'s
``flash_kernel`` phase, for one or more tiles.

    python3 tools/flash_times.py [--src DIR] [--shapes a,b,c,d]
                                 [--blocks 128x128,128x64 | legal] [--reps 20] [--out FILE]

Shapes (causal, q/k/v drawn from a seeded generator on the card): (a)
smollm-135m's layer at prefill_32k's S = 32,768 (B 1, Hq 9, Hkv 3, D 64,
bf16); (b) llama3-8b's layer at S = 4096 (B 1, Hq 32, Hkv 8, D 128, bf16);
(c) (a)'s widths at S = 4096 in float32; (d) the train step's layer, (a)'s
widths at B = 4, S = 4096, bf16. ``--blocks legal`` sweeps every tile the
kernel takes: block_q and block_k in 16, 32, ..., 128. Per shape and tile:
the kernel's time per launch by CUDA events around ``--reps`` back-to-back
launches and its TFLOP/s (the causal flops over that time), the profiler's
count of the kernel's events over the same launches (``events_seen``), and
the largest difference from the plain version; per shape, the library
call's time (``F.scaled_dot_product_attention(..., is_causal=True,
enable_gqa=True)``, a yardstick the port never calls) and the bound: the
larger of q, k, v and out moved once at 3.35 TB/s and the causal flops at
989 TFLOP/s (bf16) or 67 TFLOP/s (float32). A SHA-256 of each output lets
two checkouts (``--src``) compare bits: run the two in turns in one call
(old, new, new, old), since times move between calls. One JSON line goes
to stdout (and to ``--out``). Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SEED = 0
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
SHAPES = {  # name -> (B, Hq, Hkv, S, D, dtype)
    "a": (1, 9, 3, 32768, 64, "bfloat16"),
    "b": (1, 32, 8, 4096, 128, "bfloat16"),
    "c": (1, 9, 3, 4096, 64, "float32"),
    "d": (4, 9, 3, 4096, 64, "bfloat16"),
}
LEGAL = [(bq, bk) for bq in range(16, 129, 16) for bk in range(16, 129, 16)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--shapes", default="a,b,c,d")
    ap.add_argument("--blocks", default="128x128")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("flash_times: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.src.resolve()))
    from repro_torch.kernels.flash_attention import kernel as FK

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()

    def event_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def events_seen(fn, reps):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        return sum(e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and "flash_attention_kernel" in e.key)

    rows = {}
    tiles = LEGAL if args.blocks == "legal" else [
        tuple(int(x) for x in blk.split("x")) for blk in args.blocks.split(",")]
    for name in args.shapes.split(","):
        b, hq, hkv, s, d, dt = SHAPES[name]
        dtype = getattr(torch, dt)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        q = torch.randn(b, hq, s, d, generator=gen, device=dev).to(dtype)
        k = torch.randn(b, hkv, s, d, generator=gen, device=dev).to(dtype)
        v = torch.randn(b, hkv, s, d, generator=gen, device=dev).to(dtype)
        nbytes = (2 * hq + 2 * hkv) * b * s * d * q.element_size()
        flops = 2 * 2 * b * hq * d * s * s / 2
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dt] * 1e3
        lib_ms = event_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), args.reps)
        row = dict(b=b, hq=hq, hkv=hkv, s=s, d=d, dtype=dt, bound_ms=max(bytes_ms, ops_ms),
                   bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                   library_ms=lib_ms, library_tflops=flops / lib_ms / 1e9, blocks={})
        plain = {}  # block_k -> the plain version's output (block_q does not change it)
        for bq, bk in tiles:
            blk = f"{bq}x{bk}"
            fn = lambda: FK.flash_attention_tiles(q, k, v, block_q=bq, block_k=bk)  # noqa: E731
            out = fn()
            torch.cuda.synchronize()
            if bk not in plain:
                plain[bk] = FK.flash_attention_tiles_plain(q, k, v, causal=True, scale=d ** -0.5,
                                                           block_q=bq, block_k=bk)
            err = float((out.float() - plain[bk].float()).abs().max())
            ms = event_ms(fn, args.reps)
            row["blocks"][blk] = dict(
                ms=ms, tflops=flops / ms / 1e9, events_seen=events_seen(fn, args.reps),
                events_expected=args.reps, max_abs_err_vs_plain=err,
                sha256=hashlib.sha256(out.view(torch.uint8).cpu().numpy().tobytes()).hexdigest())
        rows[name] = row
        del q, k, v, plain
        torch.cuda.empty_cache()
    line = json.dumps({"nvidia_smi": smi, "torch": torch.__version__, "reps": args.reps,
                       "shapes": rows})
    print(line, flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
