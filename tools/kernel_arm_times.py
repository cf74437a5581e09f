#!/usr/bin/env python3
"""Time every arm of the port's two CUDA kernels on one partition.

    python3 tools/kernel_arm_times.py [--src DIR] [--variant NAME] [--arms A,B]
                                      [--scale 20] [--out FILE]

Builds the smoke's graph and partition (graph500 RMAT, edge factor 16, seed
0, ``chip_smoke.CFG``), then, for each arm, launches the kernel once per
phase over the l phase streams and reports the device time per launch
(CUDA events around ``--reps`` passes, the stream held while the host
enqueues them) and a SHA-256 of the outputs of every phase. The arms are
the laneless variants (gather min_u32 and min_f32_add on a fetch map of
every real tile, sum_f32 on the static counts; scatter min_u32 and
min_f32_add) and the lane arms of the serving width (gather 'or' on one
and two packed words, min_f32_add and sum_f32 at L=16, min_f32_add at
L=64; scatter 'or' on one and two packed words, min_f32_add at L=16 and
L=64). Then the one-bucket gather kernel's three forms (min_u32,
min_f32_add with the edge weights, sum_f32) over the partition's 64 (core,
phase) buckets, each tiled as ``chip_smoke.py``'s ``bucket`` phase tiles it
(``prepare_tiles``), one launch a bucket, with a SHA-256 of the 64 outputs
and whether a second pass gave the same bits. Then the segment-softmax
kernel at chip_smoke's two GAT layouts, H = 8 and seeded scores: (a) layer
1 at the Cora shape (16,384 edge slots), (b) the smoke graph as one layout.

``--src`` imports ``repro_torch`` from another checkout's ``src`` (default:
this one's), so that two versions of the kernels are timed and their outputs
compared on the same card; run it once per checkout on one machine, in the
order A, B, B, A. Payloads come from a fixed seed, so the hashes of two
checkouts agree iff their kernels give the same bits. ``--variant NAME``
times a copy of those sources with the text edits of ``VARIANTS[NAME]`` in
``tools/arm_variants.py`` applied (built under ``build/arm_variants/``): a
design question answered in the same call as the kernels as they are.
``--arms`` keeps the arms whose names start with one of the comma-separated
prefixes (``scatter``, ``gather[sum``, ``bucket``, ``softmax``; default:
every arm, the bucket forms and the softmax). One JSON line goes to stdout
(and to ``--out``). Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CFG = dict(p=4, l=16, tile_vb=1024, tile_eb=128, build_push=True, push_block=65536)
INF_F32 = 3.4028234663852886e38
QUEUED_LAUNCHES = 256  # launches enqueued a hold, well inside the launch queue
# arm -> (kernel, kind, edge_op, identity, lanes (0: laneless), payload kind, schedule)
ARMS = {
    "gather[min_u32]": ("gather", "min", "none", float(0xFFFFFFFF), 0, "labels", "fetch"),
    "gather[min_f32_add]": ("gather", "min", "add", INF_F32, 0, "dist", "fetch"),
    "gather[sum_f32]": ("gather", "sum", "none", 0.0, 0, "rank", "counts"),
    "scatter[min_u32]": ("scatter", "min", "none", float(0xFFFFFFFF), 0, "labels", "fetch"),
    "scatter[min_f32_add]": ("scatter", "min", "add", INF_F32, 0, "dist", "fetch"),
    "gather[or_w1]": ("gather", "or", "none", 0.0, 1, "words", "fetch"),
    "gather[or_w2]": ("gather", "or", "none", 0.0, 2, "words", "fetch"),
    "gather[min_f32_add_l16]": ("gather", "min", "add", INF_F32, 16, "dist", "fetch"),
    "gather[sum_f32_l16]": ("gather", "sum", "none", 0.0, 16, "rank", "counts"),
    "gather[min_f32_add_l64]": ("gather", "min", "add", INF_F32, 64, "dist", "fetch"),
    "scatter[or_w1]": ("scatter", "or", "none", 0.0, 1, "words", "fetch"),
    "scatter[or_w2]": ("scatter", "or", "none", 0.0, 2, "words", "fetch"),
    "scatter[min_f32_add_l16]": ("scatter", "min", "add", INF_F32, 16, "dist", "fetch"),
    "scatter[min_f32_add_l64]": ("scatter", "min", "add", INF_F32, 64, "dist", "fetch"),
}
# one-bucket kernel form -> (kind, edge_op, identity, payload kind)
BUCKET_ARMS = {
    "bucket[min_u32]": ("min", "none", float(0xFFFFFFFF), "labels"),
    "bucket[min_f32_add]": ("min", "add", INF_F32, "dist"),
    "bucket[sum_f32]": ("sum", "none", 0.0, "rank"),
}


def variant_tree(src: Path, name: str) -> Path:
    """A copy of ``src``'s ``repro_torch`` with the edits of variant ``name``
    applied to its kernel sources; returns the copy's ``src``."""
    import shutil

    sys.path.insert(0, str(ROOT / "tools"))
    from arm_variants import VARIANTS

    dst = ROOT / "build" / "arm_variants" / name / "src"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src / "repro_torch", dst / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for source, old, new in VARIANTS[name]:
        path = dst / "repro_torch" / "csrc" / source
        text = path.read_text()
        if old not in text:
            raise SystemExit(f"variant {name}: its edit does not apply to {source}")
        path.write_text(text.replace(old, new))
    return dst


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--variant", help="a name of tools/arm_variants.py's VARIANTS")
    ap.add_argument("--arms", help="comma-separated prefixes of the arms to time")
    args = ap.parse_args()
    keep = tuple(args.arms.split(",")) if args.arms else ("",)
    if args.variant:
        args.src = variant_tree(args.src, args.variant)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_arm_times: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.src.resolve()))
    import repro_torch.core.graph as G
    from repro_torch.core import frontier_words as F
    from repro_torch.core import u32
    from repro_torch.core.partition import PartitionConfig, partition_2d
    from repro_torch.kernels.csr_gather_reduce import kernel as K
    from repro_torch.kernels.csr_gather_reduce import scatter as S
    from repro_torch.kernels.segment_softmax import kernel as SK
    from repro_torch.kernels.segment_softmax.ops import build_edge_tiles, device_tiles
    from repro_torch.models.gnn.common import SOFTMAX_EB, softmax_vb

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    t0 = time.perf_counter()
    g0 = G.symmetrize(G.rmat(args.scale, 16, a=0.57, b=0.19, c=0.19, seed=0))
    w = np.random.default_rng(0).random(g0.num_edges).astype(np.float32)
    g = G.COOGraph(src=g0.src, dst=g0.dst, num_vertices=g0.num_vertices, weights=w)
    pg = partition_2d(g, PartitionConfig(**CFG))
    setup_s = time.perf_counter() - t0

    def on(a):
        return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def stream(kern, m, add):
        if kern == "gather":
            word, counts, hi, wts = pg.tile_word, pg.tile_counts, pg.tile_word_hi, pg.tile_weights
            kw = dict(num_rows=pg.packed_rows_per_core, vb=pg.tile_vb, src_bits=pg.src_bits)
        else:
            word, counts, hi, wts = pg.push_word, pg.push_counts, pg.push_word_hi, pg.push_weights
            kw = dict(num_rows=pg.vertices_per_core, src_bits=pg.push_src_bits)
        return ([on(word[:, m]), on(counts[:, m]), on(None if hi is None else hi[:, m]),
                 on(wts[:, m] if add and wts is not None else None)], kw)

    def payload(pkind, lanes, rng):
        n, width = pg.gathered_size, max(lanes, 1)
        if pkind == "words":  # K = 16 (one word) or K = 40 (two) reach bits
            k = 16 if width == 1 else 40
            bits = rng.random((n, 32 * width)) < 0.15
            bits[:, k:] = False
            v = (bits.reshape(n, width, 32).astype(np.uint64)
                 << np.arange(32, dtype=np.uint64)).sum(-1)
            return u32.to_bits(v.astype(np.uint32)).to(dev)
        if pkind == "labels":
            v = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
            v[rng.random(n) < 0.1] = u32.U32_MAX
            return u32.to_bits(v).to(dev)
        shape = (n, width) if lanes else (n,)
        if pkind == "dist":
            v = (rng.random(shape) * 100).astype(np.float32)
            v[rng.random(shape) < 0.1] = np.finfo(np.float32).max
        else:
            v = (rng.random(shape) / n).astype(np.float32)
        return torch.from_numpy(v).to(dev)

    hold = {}  # whether the last event_ms call's holds outlasted its enqueues

    def event_ms(fn, reps, launches=1):
        """Device ms per call of ``fn`` (``launches`` kernel launches) by
        CUDA events around ``reps`` calls, a spin kernel holding the stream
        while the host enqueues them, at most QUEUED_LAUNCHES launches a
        hold: past the launch queue's depth the host blocks until the device
        drains it, and the device then waits on the host's refill (a pass of
        64 launches timed 20 times a hold measured an empty kernel at 8-13
        us a launch)."""
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t
        per_hold = max(1, QUEUED_LAUNCHES // launches)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        total_ms, done, covered = 0.0, 0, True
        while done < reps:
            n = min(per_hold, reps - done)
            hold_s = min(0.2, 1.5 * n * call_s)
            torch.cuda._sleep(int(hold_s * 2e9))
            start.record()
            t = time.perf_counter()
            for _ in range(n):
                fn()
            covered &= time.perf_counter() - t < hold_s
            end.record()
            torch.cuda.synchronize()
            total_ms += start.elapsed_time(end)
            done += n
        hold["hold_covered"] = covered
        return total_ms / reps

    results = {}
    for name, (kern, kind, edge_op, identity, lanes, pkind, sched) in ARMS.items():
        if not name.startswith(keep):
            continue
        rng = np.random.default_rng(7)
        pay = payload(pkind, lanes, rng)
        fn = K.gather_reduce_cores if kern == "gather" else S.scatter_reduce_cores
        calls = []
        for m in range(pg.l):
            a, kw = stream(kern, m, edge_op == "add")
            if sched == "fetch":  # every real tile active: the main path's arm
                real = torch.arange(a[0].shape[2], device=dev).view(1, 1, -1) < a[1].unsqueeze(-1)
                a.append(F.active_fetch_map(real))
            calls.append((a, dict(kw, kind=kind, edge_op=edge_op, identity=identity)))

        def launch_all(fn=fn, pay=pay, calls=calls):
            return [fn(pay, *a, **kw) for a, kw in calls]

        outs = launch_all()
        torch.cuda.synchronize()
        digest = hashlib.sha256()
        for o in outs:
            digest.update(o.cpu().numpy().tobytes())
        del outs
        results[name] = dict(ms=event_ms(launch_all, args.reps, pg.l) / pg.l,
                             sha256=digest.hexdigest()[:16], **hold)
        del calls

    # the one-bucket kernel over every (core, phase) bucket, tiled as the
    # smoke's bucket phase tiles it
    bucket_setup_s = None
    if any(name.startswith(keep) for name in BUCKET_ARMS):
        from repro_torch.core.partition import _bucket_split_threshold
        from repro_torch.kernels.csr_gather_reduce import bucket as B
        from repro_torch.kernels.csr_gather_reduce import ops as BO

        t = time.perf_counter()
        cfg = PartitionConfig(**CFG)
        vpc, vb, eb = pg.vertices_per_core, pg.tile_vb, pg.tile_word.shape[4]
        layouts = [BO.layout_to(BO.prepare_tiles(
            pg.src_gidx[i, m], pg.dst_lidx[i, m], pg.valid[i, m], num_rows=vpc, vb=vb, eb=eb,
            weights=pg.weights[i, m] if pg.weights is not None else None,
            balance_rows=cfg.degree_aware_tiles,
            split_threshold=_bucket_split_threshold(cfg, int(pg.valid[i, m].sum()), vpc // vb)),
            dev) for i in range(pg.p) for m in range(pg.l)]
        bucket_setup_s = time.perf_counter() - t
        for name, (kind, edge_op, identity, pkind) in BUCKET_ARMS.items():
            if not name.startswith(keep):
                continue
            rng = np.random.default_rng(7)
            pays = [payload(pkind, 0, rng) for _ in range(pg.l)]
            calls = [((pays[k % pg.l], tl.src, tl.dstb, tl.valid,
                       tl.weights if edge_op == "add" else None),
                      dict(num_rows=tl.src.shape[0] * vb, vb=vb, kind=kind, edge_op=edge_op,
                           identity=identity)) for k, tl in enumerate(layouts)]

            def launch_all(calls=calls):
                return [B.gather_reduce_bucket(*a, **kw) for a, kw in calls]

            outs, again = launch_all(), launch_all()
            torch.cuda.synchronize()
            digest = hashlib.sha256()
            for o in outs:
                digest.update(o.cpu().numpy().tobytes())
            same = all(torch.equal(a, b) for a, b in zip(outs, again))
            del outs, again
            results[name] = dict(ms=event_ms(launch_all, args.reps, len(calls)) / len(calls),
                                 sha256=digest.hexdigest()[:16], same_bits_twice=same, **hold)
        del layouts

    # the segment softmax at chip_smoke's two GAT layouts, H = 8
    gc = G.symmetrize(G.rmat(12, 2, seed=0))
    cora_dst = np.concatenate([gc.dst, np.zeros(16384 - gc.num_edges, gc.dst.dtype)])
    layouts = {
        "a_cora_layer1": (cora_dst, np.arange(16384) < gc.num_edges, gc.num_vertices),
        "b_smoke_graph": (g.dst, np.ones(g.num_edges, bool), g.num_vertices),
    }
    softmax = {}
    for label, (dst, valid, n) in layouts.items() if "softmax".startswith(keep) else ():
        dt = device_tiles(build_edge_tiles(dst, valid, n, vb=softmax_vb(n), eb=SOFTMAX_EB), dev)
        srng = np.random.default_rng(7)
        shape = (8,) + tuple(dt.dstb.shape)
        scores = torch.from_numpy((srng.random(shape, dtype=np.float32) - 0.5) * 8).to(dev)

        def launch(scores=scores, dt=dt):
            return SK.segment_softmax_tiles(scores, dt.dstb, dt.valid, vb=dt.vb)

        out = launch()
        torch.cuda.synchronize()
        softmax[label] = dict(ms=event_ms(launch, args.reps), **hold, vb=dt.vb,
                              shape=list(shape),
                              sha256=hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()[:16])
        del scores, out, dt
    line = dict(src=str(args.src), variant=args.variant, card=smi, scale=args.scale, config=CFG,
                reps=args.reps, setup_seconds=setup_s, bucket_setup_seconds=bucket_setup_s,
                arms=results, softmax=softmax,
                note="ms: device time per launch by CUDA events around reps passes (the stream "
                     "held while the host enqueues them, at most 256 launches a hold), "
                     "averaged over the l phase streams (bucket: over the p * l buckets); "
                     "softmax: one launch a pass; sha256: of every phase's output; "
                     "hold_covered: every hold outlasted its enqueue")
    print(json.dumps(line), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
