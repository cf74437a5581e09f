"""Hillclimb cell C: gat-cora at ogb_products scale on the GraphScale layout.

Counterpart of ``repro.launch.hillclimb_gat``. The same training math as
the gat-cora cell, on the paper's layout: vertices dst-partitioned over p
ranks (l = 1), one all-gather of the projected payload a layer, everything
else local (``dist.gat_parallel``'s loss, written per rank, so no DTensor).
The edge layout is an actual 2-D partition of an R-MAT graph at
ogb_products scale (scale 21, edge factor 29, seed 7: ~61M edges), with the
paper's stride mapping and without it, and with bf16 wires.

One rank's train step (loss, gradients, AdamW) is traced once on a fake
world of p ranks (``launch.mesh.fake_world``): its floats are fake tensors,
its edge arrays this rank's real ones (the softmax layout is built from
them on the host first). The record holds the dry run's per-device counts
and roofline terms; its collective bytes are checked against the count the
layout gives (``expected_collectives``): two all-gathers forward, their
gradients all-reduced backward, the replicated parameters' gradients
all-reduced, two scalar all-reduces of the loss.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb_gat
    PYTHONPATH=src python -m repro_torch.launch.hillclimb_gat --scale 10 --p 4 --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import torch

__all__ = ["build_partition", "run_variant", "expected_collectives", "main"]

OUT = "results/hillclimb"
F_DIM, H, HD, OUT_DIM = 100, 8, 8, 47
N_OGB, E_OGB = 2449029, 61859140  # ogbn-products, for the analytic MODEL_FLOPS


def build_partition(p: int, stride, scale: int = 21, edge_factor: int = 29):
    import repro_torch.core.graph as G
    from repro_torch.core.partition import PartitionConfig, partition_2d

    t0 = time.time()
    g = G.rmat(scale, edge_factor, seed=7, dedup=False)
    pg = partition_2d(g, PartitionConfig(p=p, l=1, lane=8, edge_pad=8, stride=stride))
    print(f"partitioned |V|={g.num_vertices} |E|={g.num_edges} p={p} stride={stride}: "
          f"E_pad={pg.edge_pad} imbalance={pg.imbalance:.2f} "
          f"padding={pg.padding_ratio:.2%} ({time.time() - t0:.0f}s)", flush=True)
    return pg


def expected_collectives(params, pg, wire_dtype: Optional[torch.dtype]) -> list:
    """The loss step's collectives on one rank, from the layout: (kind,
    output bytes, group size) each."""
    p = pg.p
    v = p * pg.vertices_per_core
    wire = torch.empty((), dtype=wire_dtype or torch.float32).element_size()
    out = []
    for w in (params["l1_w"], params["l2_w"]):  # (in, heads, head dim)
        cols = w.shape[1] * w.shape[2] + w.shape[1]  # payload ++ source scores
        out.append(("all-gather", v * cols * wire, p))  # forward
        out.append(("all-reduce", v * cols * wire, p))  # its transpose, backward
    n_params = sum(t.numel() for t in _leaves(params))
    out.append(("all-reduce", n_params * 4, p))  # replicated params' gradients
    out.append(("all-reduce", 4, p))  # the loss numerator
    out.append(("all-reduce", 4, p))  # its denominator
    return out


def _leaves(tree):
    from repro_torch.train.optim import tree_flatten

    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def run_variant(mesh_name: str, pg, tag: str, wire_dtype=None, out_dir: str = OUT,
                device: str = "cuda") -> dict:
    """Trace rank 0's train step of the GraphScale GAT on a fake world of
    ``pg.p`` ranks; write and return its record."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.dist.gat_parallel import make_gat_graphscale_loss
    from repro_torch.kernels.segment_softmax.ops import build_edge_tiles, device_tiles
    from repro_torch.launch.dryrun import trace_cell
    from repro_torch.launch.mesh import fake_world
    from repro_torch.launch.roofline import collective_bytes, roofline_report
    from repro_torch.models.gnn import archs as gnn
    from repro_torch.models.gnn.common import SOFTMAX_EB, softmax_vb
    from repro_torch.train import steps as steps_mod
    from repro_torch.train.optim import AdamWConfig, adamw_update, init_adamw

    fake_world(pg.p)
    group = dist.group.WORLD
    vpc = pg.vertices_per_core
    dev = torch.device(device)
    cfg = gnn.GNNConfig(name="gat", n_layers=2, d_hidden=HD, n_heads=H)
    ocfg = AdamWConfig(lr=3e-4, total_steps=100_000, warmup_steps=2000)
    # rank 0's edges: real, for the softmax layout built here on the host
    host = build_edge_tiles(pg.dst_lidx[0, 0], pg.valid[0, 0], vpc, vb=softmax_vb(vpc),
                            eb=SOFTMAX_EB)
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        params = gnn.init(cfg, F_DIM, OUT_DIM, torch.Generator(), "cpu")
        params = {k: _to(v, dev) for k, v in params.items()}
        state = {"params": params, "opt": init_adamw(params, ocfg)}
        edges = [torch.empty(a[0:1].shape, dtype=torch.int32 if a.dtype != bool else torch.bool,
                             device=dev) for a in (pg.src_gidx, pg.dst_lidx, pg.valid)]
        args = (state, torch.empty((vpc, F_DIM), device=dev), *edges,
                torch.empty((vpc,), dtype=torch.int32, device=dev),
                torch.empty((vpc,), device=dev))
        tiles = device_tiles(host, dev)
    loss_fn = make_gat_graphscale_loss(group, vpc, H, HD, wire_dtype=wire_dtype, tiles=tiles)

    def train_step(state, feat, sg, dl, vm, labels, lmask):
        loss, grads = steps_mod.value_and_grad(loss_fn, state["params"], feat, sg, dl, vm,
                                               labels, lmask)
        new_p, new_opt = adamw_update(state["params"], grads, state["opt"], ocfg)
        return {"params": new_p, "opt": new_opt}, loss

    class _Cell:  # what trace_cell reads
        pass

    cell = _Cell()
    cell.fn, cell.args, cell.mode, cell.setup = train_step, args, mode, None
    t0 = time.time()
    got = trace_cell(cell)
    t_trace = time.time() - t0
    coll = collective_bytes(got["collectives"])
    coll["method"] = "exact (no layer scan)"
    want = collective_bytes(expected_collectives(params, pg, wire_dtype))
    hh = HD * H
    fwd = 2 * N_OGB * F_DIM * hh + 2 * (2 * N_OGB * hh * hh + 3 * E_OGB * hh) \
        + 2 * N_OGB * hh * OUT_DIM
    terms = roofline_report(
        key=f"gat-cora/ogb_products[{tag}]", mesh_name=mesh_name, chips=pg.p,
        cost={"flops": got["flops"], "bytes accessed": got["bytes"]}, coll=coll,
        model_flops=3.0 * fwd, dtype=torch.float32, memory_bytes=got["peak_bytes"],
        extras={"trace_s": t_trace, "edge_pad": pg.edge_pad, "imbalance": pg.imbalance,
                "padding_ratio": pg.padding_ratio})
    rec = terms.to_dict()
    rec["collectives"] = coll
    rec["expected_collectives"] = want
    rec["collectives_match_layout"] = (
        coll["count_by_kind"] == want["count_by_kind"]
        and all(abs(coll["bytes_by_kind"][k] - want["bytes_by_kind"][k])
                <= 1e-9 * max(1.0, want["bytes_by_kind"][k]) for k in want["bytes_by_kind"]))
    rec["memory"] = dict(peak_bytes=got["peak_bytes"], input_bytes=got["input_bytes"])
    rec["kernel_calls"] = got["kernel_calls"]
    rec["device_type"] = dev.type
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"gat-cora__ogb_products__{mesh_name}__{tag}.json"), "w") as f:
        json.dump(rec, f, indent=1)
    print(f"[OK] gat/ogb[{tag}] mesh={mesh_name} trace={t_trace:.1f}s "
          f"flops/dev={terms.flops_per_device:.3e} bytes/dev={terms.bytes_per_device:.3e} "
          f"coll/dev={terms.collective_bytes_per_device:.3e} (layout's "
          f"{want['total_wire_bytes_per_device']:.3e}, match={rec['collectives_match_layout']}) "
          f"dominant={terms.dominant} mem/dev={got['peak_bytes'] / 2**30:.2f}GiB", flush=True)
    return rec


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    # a fresh fake on the device (a fake CPU tensor cannot move to a card a
    # CPU-only build lacks)
    return torch.empty_strided(tree.shape, tree.stride(), dtype=tree.dtype, device=dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=21)
    ap.add_argument("--edge-factor", type=int, default=29)
    ap.add_argument("--p", default="256,512", help="ranks of the single and multi meshes")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device type (cpu: the plain versions)")
    args = ap.parse_args(argv)
    p_single, p_multi = (int(x) for x in args.p.split(","))
    kw = dict(out_dir=args.out, device=args.device)
    recs = []
    # iteration 1: GraphScale layout, stride mapping ON (the paper's default)
    pg = build_partition(p_single, stride=100, scale=args.scale, edge_factor=args.edge_factor)
    recs.append(run_variant("single", pg, "it1_graphscale_stride", **kw))
    # iteration 3: the same with bf16 wires
    recs.append(run_variant("single", pg, "it3_bf16_wire", wire_dtype=torch.bfloat16, **kw))
    # iteration 2 (ablation): stride mapping OFF -> larger E_pad
    pg = build_partition(p_single, stride=None, scale=args.scale, edge_factor=args.edge_factor)
    recs.append(run_variant("single", pg, "it2_graphscale_nostride", **kw))
    # multi-pod with stride
    pg = build_partition(p_multi, stride=100, scale=args.scale, edge_factor=args.edge_factor)
    recs.append(run_variant("multi", pg, "it1_graphscale_stride", **kw))
    bad = [r["key"] for r in recs if not r["collectives_match_layout"]]
    if bad:
        print("collective bytes differ from the layout's count:", bad)
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
