#!/usr/bin/env python3
"""Time the fixed-order segment sum at the main path's shapes, as
``chip_smoke.py``'s ``segment_sum_kernel`` and ``bag_kernel`` phases build
them:

  (a) GAT layer 1's aggregate on the smoke graph: (E, 64) float32 seeded
      messages summed by destination over the batch's layout
      (symmetrized graph500 RMAT, ``--scale``, edge factor 16);
  (b) DIN's history-item take at train_batch: (B * L, 18) float32 into the
      10,000,384-row item table by the clamped ids;
  (c) smollm-135m's embedding gradient at train_4k: (4 * 4096, 576) bf16
      into the 49,152-row vocab by lm_batch(0)'s tokens;
  (d) granite-moe's combine: (E * C, 1024) bf16 slot outputs into the
      B * S = 2,048 tokens by route_logits of seeded logits, max_run E;
  (e) the embedding bag's backward at train_batch: its launch alone on
      precomputed runs (sum), and the whole op.

    python3 tools/segment_sum_times.py [--src DIR] [--shapes abcde] [--reps 10]
                                       [--scale 20] [--out FILE]

Each ``ms`` is CUDA events around ``--reps`` back-to-back calls after a
warm one (a call: one ``segment_sum`` given its layout), per call; beside
it the layout's sort alone (``sort_ms``), ``zeros + index_add_`` in x's type
(``library_ms``), the kernel's own time a launch from the profiler's
events (``kernel_ms``), its launches a call and the byte bound (x, the
ids and the sums once at 3.35 TB/s). Every shape is checked bit for bit
against the plain version on the card. ``--src`` points at another
checkout's ``src`` (run A, B, B, A on one machine to compare two commits).
One JSON line goes to stdout (and to ``--out``). Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SEED = 0
HBM_BYTES_PER_S = 3.35e12


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--shapes", default="abcde")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("segment_sum_times: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.src.resolve()))
    import repro_torch.core.graph as G
    from repro_torch.configs.registry import get
    from repro_torch.data.synthetic import graph_batch_from_coo, lm_batch, recsys_batch
    from repro_torch.kernels.embedding_bag import kernel as EB
    from repro_torch.kernels.segment_sum import kernel as SS
    from repro_torch.kernels.segment_sum import segment_layout, segment_sum, segment_sum_plain
    from repro_torch.models.gnn.common import edge_layout
    from repro_torch.models.layers import route_logits

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)

    def ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    def profiled_ms(fn, reps):
        """The kernel's own device time a launch (profiler events named
        segment_sum_kernel), or None where the profiler saw none."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages() if "segment_sum_kernel" in e.key]
        n = sum(e.count for e in evs)
        us = sum(getattr(e, "device_time_total", 0.0) or getattr(e, "cuda_time_total", 0.0)
                 for e in evs)
        return us / n / 1e3 if n else None

    def bits(t):
        return t.contiguous().view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)

    cases = []
    if "a" in args.shapes:
        cache = ROOT / "build" / f"segment_sum_rmat{args.scale}.npz"  # kept across runs
        if not cache.exists():
            g = G.symmetrize(G.rmat(args.scale, 16, a=0.57, b=0.19, c=0.19, seed=SEED))
            cache.parent.mkdir(parents=True, exist_ok=True)
            np.savez(cache, src=g.src, dst=g.dst, n=g.num_vertices)
        gz = np.load(cache)
        big, _ = graph_batch_from_coo(gz["src"], gz["dst"], int(gz["n"]), 1, seed=SEED,
                                      with_dist=False)
        big = big.to(dev)
        cases.append(("a_gat_smoke_graph", big.edge_dst.long(), big.num_nodes, 64,
                      torch.float32, lambda ids, n: edge_layout(big)))
    din = get("din")
    c = din.model
    batch = din.shape("train_batch").dims["batch"]
    rb = recsys_batch(SEED, 0, batch, c.seq_len, c.item_vocab, c.cate_vocab, c.profile_bag_len)
    if "b" in args.shapes:
        cases.append(("b_din_take", torch.from_numpy(np.maximum(rb["hist_items"], 0)
                                                     .reshape(-1)).to(dev),
                      c.item_vocab, c.embed_dim, torch.float32, segment_layout))
    if "c" in args.shapes:
        lm = get("smollm-135m")
        toks = lm_batch(SEED, 0, 4, lm.shape("train_4k").dims["seq"], lm.model.vocab)["tokens"]
        cases.append(("c_smollm_embedding_grad",
                      torch.from_numpy(toks.reshape(-1)).long().to(dev), lm.model.vocab,
                      lm.model.d_model, lm.model.dtype, segment_layout))
    if "d" in args.shapes:
        moe = get("granite-moe-1b-a400m").model
        t = 4 * 512
        logits = torch.randn((t, moe.moe.num_experts), generator=gen, device=dev)
        rows = route_logits(logits, moe.moe, moe.capacity(t), moe.dtype)[0]
        cases.append(("d_granite_moe_combine", rows, t, moe.d_model, moe.dtype,
                      lambda ids, n, e=moe.moe.num_experts: segment_layout(ids, n, max_run=e)))

    out = dict(src=str(args.src), device=torch.cuda.get_device_name(0), shapes={})
    for label, seg, n_seg, d, dtype, build in cases:
        x = torch.randn((seg.shape[0], d), generator=gen, device=dev).to(dtype)
        layout = build(seg, n_seg)
        n0 = sum(SS.LAUNCHES.values())
        got = segment_sum(x, seg, n_seg, layout)
        per_call = sum(SS.LAUNCHES.values()) - n0
        want = segment_sum_plain(x, seg, n_seg)
        lib_seg = seg.clamp(0, n_seg)
        nbytes = (x.numel() + n_seg * d) * x.element_size() + seg.numel() * seg.element_size()
        out["shapes"][label] = dict(
            launches_per_call=per_call, bits_equal=bool(torch.equal(bits(got), bits(want))),
            ms=ms(lambda: segment_sum(x, seg, n_seg, layout), args.reps),
            kernel_ms=profiled_ms(lambda: segment_sum(x, seg, n_seg, layout), args.reps),
            sort_ms=ms(lambda: segment_layout(seg, n_seg), max(1, args.reps // 5)),
            library_ms=ms(lambda: torch.zeros((n_seg + 1, d), dtype=dtype, device=dev)
                          .index_add_(0, lib_seg, x), args.reps),
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
        print(label, out["shapes"][label], file=sys.stderr, flush=True)
        del x, got, want, layout, lib_seg
    if "e" in args.shapes:
        ids = torch.from_numpy(rb["profile_bag"]).to(dev)
        n, length = c.cate_vocab, ids.shape[1]
        g_out = torch.randn((ids.shape[0], c.embed_dim), generator=gen, device=dev)
        order, start = EB.backward_runs(ids, n)
        got = EB.launch_backward(g_out, order, start, None, length, "sum")
        want = SS.fold_runs_plain(g_out, order // length, start, torch.float32)
        nbytes = (g_out.numel() + ids.numel() + n * c.embed_dim) * 4
        out["shapes"]["e_bag_backward"] = dict(
            bits_equal=bool(torch.equal(bits(got), bits(want))),
            launch_ms=ms(lambda: EB.launch_backward(g_out, order, start, None, length, "sum"),
                         args.reps),
            kernel_ms=profiled_ms(lambda: EB.launch_backward(g_out, order, start, None, length,
                                                             "sum"), args.reps),
            whole_ms=ms(lambda: EB.embedding_bag_backward_cuda(g_out, ids, n, "sum"), args.reps),
            longest_run=int((start[1:] - start[:-1]).max()),
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
        print("e", out["shapes"]["e_bag_backward"], file=sys.stderr, flush=True)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
