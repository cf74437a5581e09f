"""Multi-channel GraphScale engine over ``torch.distributed``: one rank per
graph core, the phased crossbar as an all-gather, streaming the COMPRESSED
per-channel edge layout.

Counterpart of ``repro.core.distributed``. Rank q of the ``graph`` group
(``launch.mesh.make_graph_group``) is graph core / memory channel q. It
holds core q's label shard, (1, Vl[, L]), and uploads only core q's slice of
``pg.channel_arrays(problem)``: the packed ``tile_word``/``tile_word_hi``
words, the ``tile_counts`` that skip padding tiles, the hub-split map, and
what the options use of the coverage words and the push stream. The flat
(l, E_pad) src/dst/valid arrays never reach the card.

At phase m every rank contributes its active sub-interval of the payload to
``crossbar_exchange`` (an all-gather: the paper's two-level vertex-label
crossbar) and then reduces its own edges against that gathered block with
the SAME phase reduce as the single-process engine
(``engine.channel_phase_reduce`` / ``channel_phase_scatter``, a leading core
axis of 1), so the gather and scatter kernels run one launch a phase on
every rank. The apply semantics are the single-process engine's too:
``engine.make_iteration`` with this module's hooks. The frontier words ride
the same crossbar for ``frontier_active_tiles``.

Collectives line up because every rank takes every branch on values that
are the same everywhere: the frontier popcount is all-reduced (SUM) before
the density and direction switches read it, the convergence flag (static
schedule) is all-reduced (MAX), and a push phase is skipped only when no
rank has a live source in it (MAX). The results equal the single-process
engine's: labels and iteration counts bit for bit for the min problems,
PageRank to float reassociation.

Transport (the group's backend): NCCL moves device tensors, one card a
rank. Gloo, for the CPU and for p ranks sharing one card, has no all-gather
of CUDA tensors, so a CUDA sub-interval is copied to the host, exchanged
there and copied back. The kernels run on the card either way.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

from repro_torch.core import frontier_words as fwords
from repro_torch.core.engine import (
    EngineOptions,
    EngineResult,
    _edge_constants,
    channel_phase_reduce,
    channel_phase_scatter,
    dynamic_skip_enabled,
    make_iteration,
    phase_consts_at,
    prepare_labels,
    push_enabled,
    unpad_labels,
)
from repro_torch.core.partition import PartitionedGraph
from repro_torch.core.problems import Problem
from repro_torch.device import resolve_device

__all__ = [
    "crossbar_exchange",
    "all_reduce_int",
    "transport",
    "place_channel_shards",
    "shard_labels",
    "build_distributed_run",
    "run_distributed",
]

def transport(group) -> str:
    """The crossbar's transport: the group's backend, 'gloo' or 'nccl'."""
    return dist.get_backend(group)


def _staged(t: torch.Tensor, group) -> bool:
    # gloo exchanges host tensors only: a CUDA tensor goes through the host
    return t.device.type == "cuda" and transport(group) == "gloo"


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    staged = _staged(x, group)
    src = x.detach().to("cpu") if staged else x.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts)
    return out.to(x.device) if staged else out


def _all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    staged = _staged(x, group)
    buf = x.detach().to("cpu") if staged else x.detach().clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(x.device) if staged else buf


class _AllGather(torch.autograd.Function):
    """Tiled all-gather along axis 0; its backward is the transpose: the
    gradient summed over the ranks, this rank's rows kept."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[0]
        return _all_gather(x, group)

    @staticmethod
    def backward(ctx, grad):
        total = _all_reduce_sum(grad.contiguous(), ctx.group)
        r = dist.get_rank(ctx.group)
        return total[r * ctx.rows : (r + 1) * ctx.rows], None


def crossbar_exchange(sub_payload: torch.Tensor, group) -> torch.Tensor:
    """The two-level crossbar: replicate the p active sub-intervals so every
    later label read is local. ``sub_payload``: this rank's (sub, ...)
    block; returns the gathered (p * sub, ...) block in rank order.
    Differentiable (the GAT layer trains through it)."""
    if sub_payload.requires_grad and torch.is_grad_enabled():
        return _AllGather.apply(sub_payload, group)
    return _all_gather(sub_payload, group)


def all_reduce_int(value, op: str, group) -> int:
    """A host integer reduced over the group ('sum' or 'max'): the one way a
    rank's host decision becomes every rank's."""
    dev = "cuda" if transport(group) == "nccl" else "cpu"
    buf = torch.tensor([int(value)], dtype=torch.int64, device=dev)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX,
                    group=group)
    return int(buf.item())


def place_channel_shards(problem: Problem, pg: PartitionedGraph, group, device="cuda",
                         opts: EngineOptions = EngineOptions()) -> Dict[str, torch.Tensor]:
    """This rank's core of the packed per-channel edge stream on ``device``:
    every ``channel_arrays()`` entry's slice ``[q:q+1]``, phase-major ((l, 1,
    ...), a phase's slice contiguous), typed and selected as the
    single-process engine's (the coverage words and the push stream only
    when ``opts`` use them), uploaded once per partition
    (``pg.device_array(..., core=q)``; only the slice is read, so a
    memory-mapped partition stays on disk)."""
    return _edge_constants(problem, pg, opts, resolve_device(device),
                           core=dist.get_rank(group))


def shard_labels(labels: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """This rank's shard of a ``prepare_labels`` tree: the core axis of every
    (p, Vl[, L]) field cut to (1, Vl[, L]); scalars are kept."""
    q = dist.get_rank(group)
    return {k: (v[q : q + 1].contiguous() if v.dim() >= 2 else v) for k, v in labels.items()}


def _gather_labels(labels: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """Every rank's (1, Vl[, L]) shard back into the (p, Vl[, L]) tree."""
    return {k: (_all_gather(v, group) if v.dim() >= 2 else v) for k, v in labels.items()}


def build_distributed_run(problem: Problem, pg: PartitionedGraph, group,
                          opts: EngineOptions = EngineOptions(), device="cuda"):
    """Returns ``run_fn(labels) -> (labels, iters, changed)`` over this rank's
    label shard (``shard_labels``). ``run_fn.const_keys`` names the edge
    constants this rank holds; ``run_fn.device_bytes`` their bytes."""
    if opts.backend != "kernel":
        raise ValueError(
            "run_distributed streams the compressed per-channel layout and has "
            "exactly one phase-reduce implementation, the kernel one; "
            f"backend={opts.backend!r} has no distributed variant (run the oracle "
            "through core.engine.run instead)"
        )
    p = dist.get_world_size(group)
    if p != pg.p:
        raise ValueError(f"the partition has {pg.p} cores, the group {p} ranks")
    dev = resolve_device(device)
    consts = place_channel_shards(problem, pg, group, dev, opts)
    const_keys = tuple(k for k, v in consts.items() if v is not None)
    device_bytes = sum(consts[k].numel() * consts[k].element_size() for k in const_keys)
    coverage = consts.pop("coverage")
    push_coverage = consts.pop("push_coverage")
    push_cm = {"word": consts.pop("push_word"), "word_hi": consts.pop("push_word_hi"),
               "counts": consts.pop("push_counts"), "w": consts.pop("push_w")}
    sub = pg.sub_size
    dyn = dynamic_skip_enabled(problem, pg, opts)
    push_on = push_enabled(problem, pg, opts)

    def gathered_block(m, labels):
        payload = problem.src_transform(labels)  # (1, Vl[, L])
        return crossbar_exchange(payload[0, m * sub : (m + 1) * sub].contiguous(), group)

    def reduce_at_phase(m, labels, active=None):
        return channel_phase_reduce(problem, pg, gathered_block(m, labels),
                                    phase_consts_at(consts, m), active)

    def push_reduce_at_phase(m, labels, active):
        return channel_phase_scatter(problem, pg, gathered_block(m, labels),
                                     phase_consts_at(push_cm, m), active)

    def phase_active(m, words, use_dense):
        # the dense arm reads no frontier; use_dense is the same on every
        # rank (it comes from the all-reduced popcount), so all skip alike
        gfw = None if use_dense else crossbar_exchange(words, group)
        return fwords.frontier_active_tiles(coverage[m], gfw, consts["counts"][m], use_dense)

    def push_phase_active(m, words):
        return fwords.frontier_active_tiles(push_coverage[m], crossbar_exchange(words, group),
                                            push_cm["counts"][m], None)

    def push_phase_live(m, words):
        # a phase no rank has a live source in is skipped by every rank
        return all_reduce_int(bool((words != 0).any()), "max", group) > 0

    def density_fn(fw):
        return all_reduce_int(fwords.frontier_popcount(fw), "sum", group)

    iteration = make_iteration(
        problem, pg, opts, device=dev,
        reduce_at_phase=reduce_at_phase,
        phase_active=phase_active if dyn else None,
        density_fn=density_fn,
        push_reduce_at_phase=push_reduce_at_phase if push_on else None,
        push_phase_active=push_phase_active if push_on else None,
        push_phase_live=push_phase_live if push_on else None,
    )

    def run_fn(labels):
        it, changed = 0, True
        if dyn:
            fw = fwords.full_frontier_words(pg.l, sub, lead=(1,), device=dev)
            pop = pg.p * pg.l * sub  # the full frontier's global popcount
            prev = False if push_on else None
            while pop > 0 and it < opts.max_iters:
                out = iteration(labels, fw, prev, pop=pop)
                labels, fw = out[0], out[1]
                if prev is not None:
                    prev = out[2]
                pop = density_fn(fw)  # every rank stops together
                it += 1
            changed = pop > 0
        else:
            while changed and it < opts.max_iters:
                new = iteration(labels)
                changed = all_reduce_int(bool(problem.not_converged(labels, new)), "max",
                                         group) > 0
                labels = new
                it += 1
        return labels, it, changed

    run_fn.const_keys = const_keys
    run_fn.device_bytes = device_bytes
    return run_fn


def run_distributed(problem: Problem, g, pg: PartitionedGraph, group,
                    opts: EngineOptions = EngineOptions(),
                    labels: Dict[str, torch.Tensor] | None = None,
                    device="cuda") -> EngineResult:
    """Convenience end to end, called on every rank of ``group``: init
    labels, shard, run, gather the shards and unpad. ``labels`` (a whole
    ``prepare_labels`` tree) overrides the problem's own init. Every rank
    returns the whole result."""
    dev = resolve_device(device)
    if labels is None:
        labels = prepare_labels(problem, g, pg, device=dev)
    run_fn = build_distributed_run(problem, pg, group, opts, dev)
    out, iters, changed = run_fn(shard_labels(labels, group))
    return EngineResult(
        labels=unpad_labels(_gather_labels(out, group), pg, u32_fields=problem.u32_fields),
        iterations=iters,
        converged=not changed,
    )
