"""GNN message passing over the 2-D-partitioned crossbar engine: the
engine's gather -> reduce with (Vl, D) feature ROWS as the exchanged payload
instead of scalar labels.

Counterpart of ``repro.dist.gnn_parallel``, over ``torch.distributed``: rank
q holds core q's (1, Vl, D) feature shard and core q's flat per-phase edge
arrays (a feature row does not fit the packed scalar stream). At phase m
every rank all-gathers its active sub-interval of rows
(``core.distributed.crossbar_exchange``), then reads every edge's source
row from that gathered block and sums it into the destination's row, by
the port's fixed-order segment sum (``kernels.segment_sum``) over each
phase's destination layout, built once, so a rank's sums have the same bits
on every run.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.distributed import crossbar_exchange
from repro_torch.core.partition import PartitionedGraph
from repro_torch.device import resolve_device
from repro_torch.kernels.segment_sum import segment_layout, segment_sum

__all__ = ["shard_features", "make_graphscale_aggregate"]


def shard_features(feat: np.ndarray, pg: PartitionedGraph, group, device="cuda") -> torch.Tensor:
    """Node features -> engine vertex order (stride permutation + padding) ->
    this rank's core, (1, Vl, D) on ``device``."""
    feat = np.asarray(feat)
    d = feat.shape[1]
    padded = np.zeros((pg.padded_vertices, d), feat.dtype)
    if pg.perm is not None:
        padded[pg.perm[: pg.num_vertices]] = feat[: pg.num_vertices]
    else:
        padded[: pg.num_vertices] = feat
    q = dist.get_rank(group)
    arr = padded.reshape(pg.p, pg.vertices_per_core, d)[q : q + 1]
    return torch.from_numpy(np.ascontiguousarray(arr)).to(resolve_device(device))


def make_graphscale_aggregate(pg: PartitionedGraph, group, device="cuda"):
    """Build ``agg(feat) -> (1, Vl, D)`` over this rank's (1, Vl, D) shard:
    for every vertex v of the core, the sum of feat[u] over processing edges
    (u -> v), one sub-interval all-gather per phase."""
    p, q = dist.get_world_size(group), dist.get_rank(group)
    if p != pg.p:
        raise ValueError(f"the partition has {pg.p} cores, the group {p} ranks")
    dev = resolve_device(device)
    sub, vpc = pg.sub_size, pg.vertices_per_core
    sg = torch.from_numpy(np.ascontiguousarray(pg.src_gidx[q])).to(dev, torch.int64)
    dl = torch.from_numpy(np.ascontiguousarray(pg.dst_lidx[q])).to(dev, torch.int64)
    vm = torch.from_numpy(np.ascontiguousarray(pg.valid[q])).to(dev)
    # each phase's destinations, an invalid edge's -1 (in no segment)
    seg = torch.where(vm, dl, -1)
    layouts = [segment_layout(seg[m], vpc) for m in range(pg.l)]

    def agg(feat):
        f = feat[0]
        acc = torch.zeros((vpc, f.shape[1]), dtype=f.dtype, device=f.device)
        for m in range(pg.l):
            gathered = crossbar_exchange(f[m * sub : (m + 1) * sub].contiguous(), group)
            msgs = torch.where(vm[m][:, None], gathered[sg[m]], 0.0)  # (E, D) label reads
            acc = acc + segment_sum(msgs, seg[m], vpc, layouts[m])
        return acc[None]

    return agg
