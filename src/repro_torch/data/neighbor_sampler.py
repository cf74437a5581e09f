"""Host-side fan-out neighbor sampler (GraphSAGE-style) for the
``minibatch_lg`` shape: seed nodes -> k-hop sampled subgraph with static
padded shapes (batch_nodes=1024, fanout 15-10).

Counterpart of ``repro.data.neighbor_sampler``, the same numpy code: for
the same ``(seed, step)`` the batch, its features and its labels are bit
for bit the reference's. The batch is the port's ``GraphBatch`` of CPU
tensors over the sampled arrays (``GraphBatch.to`` moves it; the data
pipeline does so on a side stream). Its first ``batch_nodes`` rows are the
seed nodes (the loss is computed on those) plus all sampled neighbors, with
edges oriented neighbor -> seed side (pull), matching the engine's
inverse-CSR orientation.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.graph import COOGraph, coo_to_csr
from repro_torch.models.gnn.common import GraphBatch

__all__ = ["NeighborSampler"]


class NeighborSampler:
    def __init__(self, g: COOGraph, fanouts: Sequence[int], d_feat: int, seed: int = 0):
        # sample over the undirected closure's out-edges (standard SAGE)
        self.csr = coo_to_csr(g)
        self.fanouts = tuple(fanouts)
        self.d_feat = d_feat
        self.num_vertices = g.num_vertices
        self._feat_rng = np.random.default_rng(seed)

    def max_nodes(self, batch_nodes: int) -> int:
        n = batch_nodes
        total = batch_nodes
        for f in self.fanouts:
            n = n * f
            total += n
        return total

    def max_edges(self, batch_nodes: int) -> int:
        n = batch_nodes
        total = 0
        for f in self.fanouts:
            total += n * f
            n = n * f
        return total

    def sample(self, seed: int, step: int, batch_nodes: int) -> Tuple[GraphBatch, np.ndarray]:
        """(the batch of CPU tensors, the seed nodes' int32 labels)."""
        rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
        seeds = rng.integers(0, self.num_vertices, batch_nodes).astype(np.int64)

        max_n, max_e = self.max_nodes(batch_nodes), self.max_edges(batch_nodes)
        node_ids = np.zeros(max_n, np.int64)
        node_ids[:batch_nodes] = seeds
        n_nodes = batch_nodes
        src_l, dst_l = [], []
        frontier_lo, frontier_hi = 0, batch_nodes
        indptr, indices = self.csr.indptr, self.csr.indices
        for f in self.fanouts:
            frontier = node_ids[frontier_lo:frontier_hi]
            deg = (indptr[frontier + 1] - indptr[frontier]).astype(np.int64)
            # sample up to f neighbors per frontier node (with replacement)
            pick = rng.integers(0, np.maximum(deg, 1)[:, None], (len(frontier), f))
            nbr = indices[np.minimum(indptr[frontier][:, None] + pick,
                                     indptr[frontier + 1][:, None] - 1)]
            ok = (deg > 0)[:, None] & np.ones((1, f), bool)
            new = nbr[ok].astype(np.int64)
            dst_local = np.repeat(np.arange(frontier_lo, frontier_hi), f)[ok.ravel()]
            lo = n_nodes
            node_ids[lo : lo + len(new)] = new
            src_l.append(np.arange(lo, lo + len(new), dtype=np.int64))
            dst_l.append(dst_local)
            frontier_lo, frontier_hi = lo, lo + len(new)
            n_nodes = lo + len(new)

        src = np.concatenate(src_l) if src_l else np.zeros(0, np.int64)
        dst = np.concatenate(dst_l) if dst_l else np.zeros(0, np.int64)
        n_edges = len(src)
        edge_src = np.zeros(max_e, np.int32)
        edge_dst = np.zeros(max_e, np.int32)
        edge_src[:n_edges] = src
        edge_dst[:n_edges] = dst
        edge_mask = np.zeros(max_e, bool)
        edge_mask[:n_edges] = True
        node_mask = np.zeros(max_n, bool)
        node_mask[:n_nodes] = True
        # features hashed from global node id (deterministic, no big table)
        feat = self._features(node_ids, max_n)
        dist = rng.random(max_e).astype(np.float32) * 10.0
        labels = (node_ids[:batch_nodes] % 16).astype(np.int32)
        batch = GraphBatch(
            node_feat=torch.from_numpy(feat),
            edge_src=torch.from_numpy(edge_src),
            edge_dst=torch.from_numpy(edge_dst),
            node_mask=torch.from_numpy(node_mask),
            edge_mask=torch.from_numpy(edge_mask),
            graph_id=torch.zeros(max_n, dtype=torch.int32),
            n_graphs=1,
            edge_dist=torch.from_numpy(dist),
        )
        return batch, labels

    def _features(self, node_ids: np.ndarray, max_n: int) -> np.ndarray:
        rng = np.random.default_rng(12345)
        proj = rng.standard_normal((8, self.d_feat)).astype(np.float32)
        base = np.stack(
            [np.sin(node_ids * (k + 1) * 0.001) for k in range(8)], axis=1
        ).astype(np.float32)
        return (base @ proj)[:max_n]
