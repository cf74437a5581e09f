"""Frontier-compressed crossbar exchange over ``torch.distributed``.

Counterpart of ``repro.core.frontier`` (beyond the paper). The paper's
crossbar always moves full label requests. For monotone min problems
(BFS/WCC/SSSP) the set of labels that changed since a core last broadcast
its sub-interval, the *frontier*, collapses as the run converges. This
engine keeps a replicated CACHE of every phase's gathered block and, per
phase, exchanges only (index, value) pairs of changed labels under a budget
K, falling back to the full all-gather when any rank's frontier exceeds K:
the per-rank count is all-reduced (MAX) first, so every rank takes the same
branch.

Wire cost per phase:  sparse  p * K * (4 + label) bytes  vs  full  p * sub * label.

The results equal the dense engine's: the cache is updated with exactly the
labels the dense path would re-gather. Edge processing streams the
compressed per-channel layout through the single-process engine's phase
reduce (``engine.channel_phase_reduce`` / ``channel_phase_scatter``, a core
axis of 1) against the cache row, which IS the phase's gathered block. The
exchange's changed-mask doubles as the exact live frontier for the dynamic
tile skip: word-packed and all-gathered over the same crossbar, it drives
``frontier_active_tiles`` (iteration 0 runs dense: the initial cache rows
were never reduced).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import frontier_words as fwords
from repro_torch.core import u32
from repro_torch.core.distributed import (
    _all_gather,
    _gather_labels,
    all_reduce_int,
    crossbar_exchange,
    place_channel_shards,
    shard_labels,
)
from repro_torch.core.engine import (
    EngineOptions,
    EngineResult,
    channel_phase_reduce,
    channel_phase_scatter,
    dynamic_skip_enabled,
    phase_consts_at,
    prepare_labels,
    push_enabled,
    unpad_labels,
)
from repro_torch.core.partition import PartitionedGraph
from repro_torch.core.problems import Problem
from repro_torch.device import resolve_device

__all__ = ["run_distributed_frontier", "frontier_wire_bytes"]


def _sparse_exchange(changed, payload_sub, cache_row, sub, group, budget):
    """Exchange changed entries only; returns (new cache row, overflowed?,
    this rank's changed count).

    ``changed`` is a (sub,) per-VERTEX mask; for lane-batched payloads (sub,
    L) it is the union over lanes, and each exchanged entry carries the
    vertex's whole L-wide payload row."""
    count = int(changed.sum())
    if all_reduce_int(count, "max", group) > budget:
        return crossbar_exchange(payload_sub, group), True, count
    dev = payload_sub.device
    idx = torch.where(changed, torch.arange(sub, dtype=torch.int32, device=dev),
                      torch.full((), sub, dtype=torch.int32, device=dev))
    idx = torch.sort(idx).values[:budget]  # changed indices first (padded with sub)
    vals = payload_sub[idx.clamp(max=sub - 1).long()]
    all_idx = _all_gather(idx[None], group)  # (p, K)
    all_vals = _all_gather(vals[None], group)  # (p, K[, L])
    p = all_idx.shape[0]
    base = torch.arange(p, dtype=torch.int64, device=dev)[:, None] * sub
    flat_pos = torch.where(all_idx < sub, base + all_idx, p * sub).reshape(-1)
    flat_val = all_vals.reshape(-1, *all_vals.shape[2:])
    padded = torch.cat([cache_row, cache_row[-1:]])
    padded[flat_pos] = flat_val
    return padded[:-1], False, count


def run_distributed_frontier(
    problem: Problem,
    g,
    pg: PartitionedGraph,
    group,
    opts: EngineOptions = EngineOptions(),
    budget: int = 64,
    device="cuda",
) -> Tuple[EngineResult, Dict[str, float]]:
    """Min-problem engine with the frontier-compressed exchange, called on
    every rank of ``group``. Returns the result (whole, on every rank) plus
    the run's wire statistics (sparse phases vs full phases)."""
    if problem.reduce_kind != "min" or not opts.immediate_updates:
        raise ValueError("the frontier engine runs min problems with immediate_updates")
    p = dist.get_world_size(group)
    if p != pg.p:
        raise ValueError(f"the partition has {pg.p} cores, the group {p} ranks")
    if opts.backend != "kernel":
        raise ValueError(
            "run_distributed_frontier streams the compressed per-channel layout (the "
            f"kernel phase reduce); backend={opts.backend!r} has no frontier variant"
        )
    dev = resolve_device(device)
    sub, l, q = pg.sub_size, pg.l, dist.get_rank(group)
    dyn = dynamic_skip_enabled(problem, pg, opts)
    push_on = push_enabled(problem, pg, opts)
    forced_push = opts.direction == "push"
    if forced_push and not push_on:
        raise ValueError(
            "direction='push' requires a push stream (PartitionConfig.build_push), a "
            "min/or reduce and dynamic tile scheduling"
        )
    cm_all = place_channel_shards(problem, pg, group, dev, opts)
    coverage = cm_all.pop("coverage")
    push_coverage = cm_all.pop("push_coverage")
    push_cm = {"word": cm_all.pop("push_word"), "word_hi": cm_all.pop("push_word_hi"),
               "counts": cm_all.pop("push_counts"), "w": cm_all.pop("push_w")}
    word_pad = fwords.words_per_sub(sub) * fwords.WORD_BITS - sub
    # per-PHASE thresholds: a phase's frontier lives in the p active
    # sub-intervals (p * sub source bits), not the whole vertex set. The
    # direction choice is stateless here: each phase's exchange count is an
    # exact frontier popcount, so alpha alone decides; forced 'push' yields
    # only to the mandatory-dense iteration 0.
    dense_thr = int(p * sub * opts.dynamic_skip_density)
    alpha_thr = int(p * sub * opts.direction_alpha / max(problem.lanes, 1))
    mf = problem.merge_field
    minimum = u32.minimum if problem.payload_u32 else torch.minimum

    labels = shard_labels(prepare_labels(problem, g, pg, device=dev), group)
    payload0 = problem.src_transform(labels)[0]
    # cache rows start from the true initial gathered blocks (one full
    # gather per phase: what the dense engine pays on iteration 1)
    cache = torch.stack([crossbar_exchange(payload0[m * sub : (m + 1) * sub].contiguous(),
                                           group) for m in range(l)])  # (l, p*sub[, L])
    it, changed, nsparse, nfull = 0, True, 0, 0
    while changed and it < opts.max_iters:
        start = labels
        for m in range(l):
            mine = problem.src_transform(labels)[0, m * sub : (m + 1) * sub]
            diff = mine != cache[m, q * sub : (q + 1) * sub]  # changed since LAST broadcast
            changed_src = diff.any(-1) if diff.dim() == 2 else diff
            row, overflow, count = _sparse_exchange(changed_src, mine.contiguous(), cache[m],
                                                    sub, group, budget)
            cache[m] = row
            cm_m = phase_consts_at(cm_all, m)
            active = gfw = None
            use_dense = True
            if dyn:
                bits = (torch.nn.functional.pad(changed_src, (0, word_pad)) if word_pad
                        else changed_src)
                gfw = crossbar_exchange(fwords.pack_bits(bits), group)  # (p * Ws,)
                pop = all_reduce_int(count, "sum", group)
                use_dense = it == 0 or pop >= dense_thr
                active = fwords.frontier_active_tiles(coverage[m], gfw, cm_m["counts"],
                                                      use_dense)
            use_push = push_on and ((it > 0) if forced_push
                                    else (not use_dense and pop < alpha_thr))
            if use_push:
                pm = phase_consts_at(push_cm, m)
                pactive = fwords.frontier_active_tiles(push_coverage[m], gfw, pm["counts"],
                                                       None)
                reduced = channel_phase_scatter(problem, pg, row, pm, pactive)
            else:
                reduced = channel_phase_reduce(problem, pg, row, cm_m, active)
            labels = dict(labels)
            labels[mf] = minimum(labels[mf], reduced)
            nsparse += not overflow
            nfull += overflow
        changed = all_reduce_int(bool(problem.not_converged(start, labels)), "max", group) > 0
        it += 1
    merge = labels[mf]
    # per-vertex payload bytes: lane-batched labels ship the whole lane row
    lane_w = merge.shape[-1] if problem.lanes > 0 else 1
    stats = frontier_wire_bytes(pg, nsparse, nfull, budget, merge.element_size() * lane_w)
    res = EngineResult(
        labels=unpad_labels(_gather_labels(labels, group), pg, u32_fields=problem.u32_fields),
        iterations=it,
        converged=not changed,
    )
    return res, stats


def frontier_wire_bytes(pg, nsparse: int, nfull: int, budget: int, label_bytes: int):
    """Per-rank wire bytes: sparse phase = p*K*(4+label); full = p*sub*label.
    Includes the one-time initial full gather of all l phases."""
    p, sub, l = pg.p, pg.sub_size, pg.l
    full_phase = p * sub * label_bytes
    sparse_phase = p * budget * (4 + label_bytes)
    dense_equivalent = (nsparse + nfull + l) * full_phase
    actual = l * full_phase + nsparse * sparse_phase + nfull * full_phase
    return {
        "sparse_phases": nsparse,
        "full_phases": nfull,
        "bytes_actual": actual,
        "bytes_dense_equivalent": dense_equivalent,
        "reduction": dense_equivalent / max(actual, 1),
    }
