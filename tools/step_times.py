#!/usr/bin/env python3
"""Time the steps whose sums the fixed-order segment sum carries, as
``chip_smoke.py``'s ``gnn`` and ``din_train`` phases build them: a GAT train
step at gat-cora's published width on the Cora shape (full_graph_sm), a GAT
forward on the smoke graph at ogbn-products' widths, and a DIN train step at
the published width on train_batch.

    python3 tools/step_times.py [--src DIR] [--scale 20] [--steps 20] [--out FILE]

Each time is the host clock around one step ending in a read of its loss (a
forward: a synchronize), the median, min and max over ``--steps`` after two
warm ones. Beside it, the first step's loss and gradients (a forward's
output) computed twice from the same weights and batch: a SHA-256 of each
run's bytes and whether the two are the same bits, and the segment-sum
kernel's own device time in one profiled step or forward (``*_sum_ms``:
the ms and launches of the profiler's ``segment_sum_kernel`` events, each
sum's kernel with the bag backward's). ``--src`` points at
another checkout's ``src`` (run A, B, B, A on one machine to compare two
commits). One JSON line goes to stdout (and to ``--out``). Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SEED = 0


def _digest(tree) -> str:
    """SHA-256 of every tensor's bytes in a (nested) result, in order."""
    import torch

    h = hashlib.sha256()
    stack = [tree]
    while stack:
        v = stack.pop()
        if isinstance(v, dict):
            stack.extend(v[k] for k in sorted(v, reverse=True))
        elif isinstance(v, (list, tuple)):
            stack.extend(reversed(v))
        elif isinstance(v, torch.Tensor):
            h.update(v.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _times(fn, steps):
    fn()
    fn()
    lat = []
    for _ in range(steps):
        t = time.perf_counter()
        fn()
        lat.append((time.perf_counter() - t) * 1e3)
    lat.sort()
    return dict(median=lat[len(lat) // 2], min=lat[0], max=lat[-1], steps=steps)


def _sum_ms(fn):
    """The segment-sum kernel's device ms and launches in one call of fn,
    from the profiler's events (ms None where it saw no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if "segment_sum_kernel" in e.key]
    us = sum(getattr(e, "device_time_total", 0.0) or getattr(e, "cuda_time_total", 0.0)
             for e in evs)
    return dict(ms=us / 1e3 if us else None, launches=sum(e.count for e in evs))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("step_times: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.src.resolve()))
    import repro_torch.core.graph as G
    from repro_torch.configs.registry import get
    from repro_torch.data.synthetic import graph_batch_from_coo, recsys_batch
    from repro_torch.models.gnn import archs
    from repro_torch.models.recsys import din
    from repro_torch.train import steps as S
    from repro_torch.train.optim import AdamWConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    out = dict(src=str(args.src), device=torch.cuda.get_device_name(0))

    def twice(fn):
        a, b = fn(), fn()
        return dict(sha256=[_digest(a), _digest(b)], same_bits=_digest(a) == _digest(b))

    # GAT train on the Cora shape: 4096 nodes, 16,384 slots (the rest masked)
    cfg = get("gat-cora").model
    dims = get("gat-cora").shape("full_graph_sm").dims
    gc_ = G.symmetrize(G.rmat(12, 2, seed=SEED))
    pad = dims["n_edges"] - gc_.num_edges
    src = np.concatenate([gc_.src, np.zeros(pad, gc_.src.dtype)])
    dst = np.concatenate([gc_.dst, np.zeros(pad, gc_.dst.dtype)])
    b, lab = graph_batch_from_coo(src, dst, dims["n_nodes"], 1433, seed=SEED, n_classes=7)
    b = dataclasses.replace(b, edge_mask=torch.from_numpy(np.arange(dims["n_edges"])
                                                          < gc_.num_edges)).to(dev)
    labels = torch.from_numpy(lab).to(dev)

    def gat_params(d_in, d_out, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        p = archs.init(cfg, d_in, d_out, gen, dev)
        for k in ("l1_asrc", "l1_adst", "l2_asrc", "l2_adst"):
            p[k] = torch.randn(p[k].shape, generator=gen, device=dev) * 0.5
        return p

    params = gat_params(1433, 7, SEED)
    ocfg = AdamWConfig(lr=1e-3, total_steps=args.steps + 2, warmup_steps=20)
    loss_fn = S.make_gnn_loss(cfg, "node_class")
    out["gat_train_first_step"] = twice(lambda: S.value_and_grad(loss_fn, params, b, labels))
    step = S.make_gnn_train_step(cfg, ocfg, task="node_class")
    state = [S.init_train_state(params, ocfg)]

    def gat_step():
        state[0], m = step(state[0], b, labels)
        float(m["loss"])

    out["gat_train_ms"] = _times(gat_step, args.steps)
    del state, params, b

    # GAT forward on the smoke graph at ogbn-products' widths
    prod = get("gat-cora").shape("ogb_products").dims
    g = G.symmetrize(G.rmat(args.scale, 16, a=0.57, b=0.19, c=0.19, seed=SEED))
    big, _ = graph_batch_from_coo(g.src, g.dst, g.num_vertices, prod["d_feat"], seed=SEED,
                                  n_classes=prod["n_classes"])
    big = big.to(dev)
    infer = S.make_gnn_infer(cfg)
    ip = gat_params(prod["d_feat"], prod["n_classes"], SEED + 1)

    def forward():
        o = infer(ip, big)
        torch.cuda.synchronize()
        return o

    out["gat_infer_first"] = twice(forward)
    out["gat_infer_ms"] = _times(forward, max(3, args.steps // 4))
    out["gat_infer_sum_ms"] = _sum_ms(forward)
    out["gat_infer_graph"] = dict(nodes=big.num_nodes, edges=big.num_edges)
    del big, ip, g

    # DIN train at train_batch
    dcfg = get("din").model
    bsz = get("din").shape("train_batch").dims["batch"]
    dp = din.init(dcfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    batches = [din.batch_to(recsys_batch(SEED, i, bsz, dcfg.seq_len, dcfg.item_vocab,
                                         dcfg.cate_vocab, dcfg.profile_bag_len), dev)
               for i in range(2)]
    dloss = S.make_din_loss(dcfg)
    out["din_train_first_step"] = twice(lambda: S.value_and_grad(dloss, dp, batches[0]))
    dstep = S.make_din_train_step(dcfg, ocfg)
    dstate = [S.init_train_state(dp, ocfg)]
    i = [0]

    def din_step():
        dstate[0], m = dstep(dstate[0], batches[i[0] % 2])
        i[0] += 1
        float(m["loss"])

    out["din_train_ms"] = _times(din_step, args.steps)
    out["din_train_sum_ms"] = _sum_ms(din_step)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
