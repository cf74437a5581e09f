"""Synchronous edge-centric baseline engine (HitGraph [8] / ThunderGP [9]), on
torch.

Counterpart of ``repro.core.edge_centric``: the comparison target the paper
measures against. Iterate the *edge list* (8 bytes/edge, uncompressed),
produce one update per edge from the source label, coalesce updates, and
apply them only at the END of each iteration (synchronous propagation). Per
paper Fig. 1 this pays both more bytes/edge and more iterations than
GraphScale's asynchronous compressed design.

Per iteration, as torch ops on the labels' device: one ``index_select`` of
the payload at the (p, E_pad) global source ids, the problem's map UDF,
then a per-core segment reduce at the local destination ids
(``engine._segment_reduce``, the oracle backend's: uint32 labels reduce
through ``core.u32``'s widened min, sums accumulate in float64 so a hub
row's rounding does not depend on the order the card adds in). No kernel
backs it in the reference either. The edge arrays are uploaded once per
partition (``EdgeCentricPartition.device_cache``). The convergence flag is
read back once per iteration.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.core import u32
from repro_torch.core.engine import _segment_reduce, _to_tensor
from repro_torch.core.partition import EdgeCentricPartition
from repro_torch.core.problems import Problem
from repro_torch.device import resolve_device

__all__ = ["EdgeCentricOptions", "EdgeCentricResult", "run_edge_centric"]


@dataclasses.dataclass(frozen=True)
class EdgeCentricOptions:
    max_iters: int = 1000


@dataclasses.dataclass
class EdgeCentricResult:
    labels: Dict[str, np.ndarray]
    iterations: int
    converged: bool


def _prepare(problem: Problem, g, part: EdgeCentricPartition, dev) -> Dict[str, torch.Tensor]:
    padded = part.p * part.vertices_per_core
    out = {}
    for k, v in problem.init_labels(g, padded).items():
        v = np.asarray(v)
        if v.ndim == 1 and v.shape[0] == padded:
            v = v.reshape(part.p, part.vertices_per_core)
        out[k] = _to_tensor(v, dev)
    return out


def _device_edges(part: EdgeCentricPartition, dev):
    """The edge arrays on ``dev``, uploaded once per partition: (p * E_pad,)
    int32 source ids, (p, E_pad) int64 local destinations, the valid mask
    and the weights (None when the graph has none)."""
    key = str(dev)
    hit = part.device_cache.get(key)
    if hit is None:
        on = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        hit = part.device_cache[key] = (
            on(part.src_vid).reshape(-1), on(part.dst_lidx).long(), on(part.valid),
            on(part.weights) if part.weights is not None else None,
        )
    return hit


def run_edge_centric(
    problem: Problem,
    g,
    part: EdgeCentricPartition,
    opts: EdgeCentricOptions = EdgeCentricOptions(),
    device="cuda",
) -> EdgeCentricResult:
    """Run ``problem`` (a laneless one) to convergence on ``device`` (the card
    unless the caller asks for ``"cpu"``)."""
    if problem.lanes:
        raise ValueError("the edge-centric baseline runs laneless problems only")
    dev = resolve_device(device)
    p, vpc = part.p, part.vertices_per_core
    labels = _prepare(problem, g, part, dev)
    src, dst, valid, w = _device_edges(part, dev)
    if problem.edge_op != "add":  # only the SSSP map reads weights
        w = None
    mf = problem.merge_field
    minimum = u32.minimum if problem.payload_u32 else torch.minimum

    def iteration(labels):
        # scatter phase: every core reads source labels from the full
        # (synchronously consistent) label array of the previous iteration
        payload = problem.src_transform(labels).reshape(p * vpc)
        contrib = problem.edge_map(payload.index_select(0, src).view(p, -1), w)
        contrib = torch.where(valid, contrib, problem.stored_identity)
        acc = _segment_reduce(problem.reduce_kind, contrib, dst, vpc, problem.identity)
        # gather/apply phase: updates applied only now (synchronous)
        if problem.reduce_kind == "min":
            new = dict(labels)
            new[mf] = minimum(labels[mf], acc)
            return new
        return problem.finalize(labels, acc)

    it, changed = 0, True
    while changed and it < opts.max_iters:
        new = iteration(labels)
        changed = bool(problem.not_converged(labels, new))
        labels = new
        it += 1
    out = {}
    for k, v in labels.items():
        v = u32.from_bits(v) if k in problem.u32_fields else v.detach().cpu().numpy()
        if v.shape == (p, vpc):
            v = v.reshape(-1)[: part.num_vertices]
        out[k] = v
    return EdgeCentricResult(labels=out, iterations=it, converged=not changed)
