"""Asynchronous pull-based vertex-centric engine (paper §III-A/B), on torch.

Counterpart of ``repro.core.engine``. The ``p`` graph cores are a leading
tensor axis; the crossbar is the phase-m gathered label block. Per iteration
(paper Fig. 4):

  for phase m in range(l):                  # meta-partition M_m
    1. prefetch: slice sub-interval m of every core's payload and concatenate
       -> the gathered block (G,) = (p * sub_size,)
    2. process: gather per-edge source payloads, apply the map UDF, reduce by
       destination
    3. apply: min problems with ``immediate_updates`` merge into the live
       labels NOW (asynchronous — later phases see the new labels);
       otherwise contributions accumulate and merge at iteration end
       (synchronous; sum problems replace the labels via ``finalize``).

Two step-2 backends, selected by ``EngineOptions.backend``:

  * ``'kernel'`` (default; the reference's ``'pallas'``): one launch of
    ``gather_reduce_cores`` per phase covers all ``p`` cores, reading the
    compressed (p, R, T, Eb) word stream and skipping the tiles that do not
    run. On the card that is the hand-written CUDA kernel; on the CPU its
    plain PyTorch version. Hub rows split at partition time are folded back
    into natural rows by ``combine_split_rows``; LPT row packing is undone
    by a gather.
  * ``'oracle'`` (the reference's ``'xla'``): materializes the (p, E_pad)
    contributions of the flat bucket arrays and scatter-reduces them, on the
    static schedule. Bit-identical to the kernel for min problems; sum
    problems (PageRank) agree to float-summation-order reassociation.

Frontier-aware dynamic tile skip (``dynamic_tile_skip``, on by default; min
problems on the kernel backend with coverage words): the run carries the
frontier words of the last iteration's label changes
(``core.frontier_words``), and each phase ANDs the per-tile coverage words
against the live frontier, so real tiles none of whose sources changed are
skipped through the kernel's fetch map. While the frontier is wide
(popcount >= ``dynamic_skip_density`` * source bits) a phase runs all real
tiles. The async path adds each phase's merges to the live frontier, which
keeps the dynamic schedule bit-identical per iteration to the static one:
same labels, same iteration counts. An empty frontier is the convergence
test.

Direction-optimizing push (``direction``, 'auto' by default; needs the
dynamic skip and a partition built with ``build_push=True``): each
iteration picks pull or push on the frontier popcount with the Beamer
hysteresis (enter push below ``direction_alpha`` * source bits, stay below
``direction_beta``). A push phase is one ``scatter_reduce_cores`` launch
over the source-binned push stream, with the fetch map of the push stream's
own coverage words; its output rows are natural rows, so there is no fold.
The reference skips a phase with no live source outright; here such a
phase's fetch map is all inactive, so the launch does nothing, the merge is
a no-op and the result is identical, without a per-phase host read.

Multi-query lanes (``Problem.lanes = K > 0``): the payload and the merged
labels carry a trailing lane axis, packed reach words of ``bfs_multi``
(reduce 'or') or a (..., K) block of ``sssp_multi``/``ppr_multi``, and each
phase is still one kernel launch that decodes every tile word once for all
K lanes. 'or' problems always take the synchronous schedule (their
``finalize`` recovers hop levels from a per-iteration counter) and stay
eligible for the dynamic tile skip and push (OR is monotone like min). The
frontier words are the union over lanes, and the direction thresholds are
scaled by 1/K, since a push pass scatters each changed vertex's whole lane
row. ``EngineOptions.lanes`` pins the batch width a caller expects.

Host reads: the frontier's popcount is the one scalar read back per
iteration. It is the convergence test, and the next iteration's density and
direction switches are taken from it on the host, so no phase waits for the
device. The static schedule reads the convergence flag once per iteration.

uint32 labels follow ``core.u32`` (int32 storage, widened for ordered ops).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict

import numpy as np
import torch

from repro_torch.core import frontier_words as fwords
from repro_torch.core import u32
from repro_torch.core.partition import PartitionedGraph
from repro_torch.core.problems import Problem
from repro_torch.device import resolve_device
from repro_torch.kernels.csr_gather_reduce.kernel import _min_into, _or_into, gather_reduce_cores
from repro_torch.kernels.csr_gather_reduce.ops import combine_split_rows
from repro_torch.kernels.csr_gather_reduce.scatter import scatter_reduce_cores

__all__ = [
    "EngineOptions",
    "EngineResult",
    "dynamic_skip_enabled",
    "push_enabled",
    "prepare_labels",
    "labels_from_numpy",
    "unpad_labels",
    "make_iteration",
    "phase_consts_at",
    "channel_phase_reduce",
    "channel_phase_scatter",
    "channel_phase_reduce_oracle",
    "run",
    "run_frontier_trace",
    "evict_from_cache",
]

_BACKENDS = ("kernel", "oracle")


@dataclasses.dataclass(frozen=True)
class EngineOptions:
    immediate_updates: bool = True  # paper opt 1: async write-back
    max_iters: int = 1000
    # 'kernel': gather_reduce_cores, one launch per phase (reference 'pallas').
    # 'oracle': materialize-then-reduce (reference 'xla').
    backend: str = "kernel"
    # frontier-aware dynamic tile skip (min problems, kernel backend); the
    # results and iteration counts equal the static schedule's
    dynamic_tile_skip: bool = True
    # dense fallback: while the frontier popcount >= density * source bits a
    # phase runs all real tiles; 0.0 = always dense, > 1.0 = never dense
    dynamic_skip_density: float = 0.5
    # Beamer push/pull: 'auto' switches per iteration (enter push below
    # alpha * source bits, stay below beta); 'push'/'pull' force one
    # direction ('push' raises unless the problem and partition admit it)
    direction: str = "auto"
    direction_alpha: float = 0.02
    direction_beta: float = 0.1
    # multi-query batch width K: None accepts whatever the problem declares
    # (laneless included); an int pins it, and a problem of another width
    # raises (the serving loop's admission check on its batches)
    lanes: int | None = None

    def __post_init__(self):
        if self.backend not in _BACKENDS:
            raise ValueError(f"backend must be one of {_BACKENDS}, got {self.backend!r}")
        if self.lanes is not None and self.lanes < 0:
            raise ValueError(f"lanes must be None or >= 0, got {self.lanes}")
        if self.direction not in ("auto", "push", "pull"):
            raise ValueError(
                f"direction must be 'auto', 'push' or 'pull', got {self.direction!r}"
            )
        if not 0.0 <= self.direction_alpha <= self.direction_beta:
            raise ValueError(
                "need 0 <= direction_alpha <= direction_beta, got "
                f"{self.direction_alpha} / {self.direction_beta}"
            )


def dynamic_skip_enabled(problem: Problem, pg: PartitionedGraph, opts: EngineOptions) -> bool:
    """Frontier skipping is sound only for monotone reduces, min and the word
    OR of packed multi-source BFS (a skipped tile's sources re-contribute
    values already merged); sum problems need every contribution every
    iteration. It also needs the kernel backend and the partition-time
    coverage words."""
    return bool(
        opts.dynamic_tile_skip
        and opts.backend == "kernel"
        and problem.reduce_kind in ("min", "or")
        and pg.tile_coverage is not None
    )


def push_enabled(problem: Problem, pg: PartitionedGraph, opts: EngineOptions) -> bool:
    """The push direction is admissible: a min/or problem, the kernel backend, a
    partition-time push stream, and the dynamic skip (its frontier carry is
    what the switch and the push fetch map read). ``direction='pull'`` opts
    out."""
    return bool(
        opts.direction != "pull"
        and pg.push_word is not None
        and dynamic_skip_enabled(problem, pg, opts)
    )


@dataclasses.dataclass
class EngineResult:
    labels: Dict[str, np.ndarray]  # unpadded, original vertex ids
    iterations: int
    converged: bool


def _to_tensor(v: np.ndarray, device) -> torch.Tensor:
    if v.dtype == np.uint32:
        return u32.to_bits(v).to(device)
    return torch.from_numpy(np.array(v)).to(device)  # copy: v may be read-only


def prepare_labels(problem: Problem, g, pg: PartitionedGraph, device="cuda"):
    """Init labels on host, apply the stride permutation, reshape to (p, Vl)
    and move to ``device`` (uint32 fields as int32 bits). A lane-batched
    field (padded, L) becomes (p, Vl, L): the permutation moves rows and the
    lane axis rides along."""
    dev = resolve_device(device)
    padded = pg.padded_vertices
    out = {}
    for k, v in problem.init_labels(g, padded).items():
        v = np.asarray(v)
        if v.ndim in (1, 2) and v.shape[0] == padded:
            if pg.perm is not None:
                # perm is a bijection on [0, V); slots >= V keep their init
                moved = v.copy()
                moved[pg.perm[: pg.num_vertices]] = v[: pg.num_vertices]
                v = moved
            v = v.reshape(pg.p, pg.vertices_per_core, *v.shape[1:])
        out[k] = _to_tensor(v, dev)
    return out


def labels_from_numpy(tree: Dict[str, np.ndarray], device="cuda"):
    """State carry-over: a reference ``prepare_labels`` tree, as numpy arrays
    (already permuted and shaped (p, Vl)), to the port's label tensors."""
    dev = resolve_device(device)
    return {k: _to_tensor(np.asarray(v), dev) for k, v in tree.items()}


def unpad_labels(labels, pg: PartitionedGraph, u32_fields=()) -> Dict[str, np.ndarray]:
    """Back to original vertex ids (undo stride permutation + padding) as
    numpy; ``u32_fields`` come back as uint32. A trailing lane axis stays."""
    out = {}
    for k, v in labels.items():
        v = u32.from_bits(v) if k in u32_fields else v.detach().cpu().numpy()
        if v.ndim in (2, 3) and v.shape[:2] == (pg.p, pg.vertices_per_core):
            flat = v.reshape(pg.padded_vertices, *v.shape[2:])
            v = flat[pg.perm[: pg.num_vertices]] if pg.perm is not None else flat[: pg.num_vertices]
        out[k] = v
    return out


# kernel-backend constant -> (PartitionedGraph field, torch dtype on device);
# torch indexes with int64, so the row maps are widened once at upload
_KERNEL_FIELDS = {
    "word": ("tile_word", None),
    "word_hi": ("tile_word_hi", None),
    "counts": ("tile_counts", None),
    "w": ("tile_weights", None),
    "row_pos": ("tile_row_pos", torch.int64),
    "split_map": ("tile_split_map", torch.int64),
    "coverage": ("tile_coverage", None),
    "push_word": ("push_word", None),
    "push_word_hi": ("push_word_hi", None),
    "push_counts": ("push_counts", None),
    "push_w": ("push_weights", None),
    "push_coverage": ("push_coverage", None),
}
_PUSH_KEYS = ("push_word", "push_word_hi", "push_counts", "push_w", "push_coverage")


def _edge_constants(problem: Problem, pg: PartitionedGraph, opts: EngineOptions, device,
                    core=None):
    """Per-phase edge tensors on ``device``, phase-major so that a phase's
    slice is contiguous, uploaded once per graph (``pg.device_array``). The
    coverage words and the push stream are uploaded only when the options
    use them. ``core`` keeps that core's slice alone (a rank of the
    multi-channel engine)."""
    if opts.backend == "kernel":
        # channel_arrays(problem) is the weight-streaming rule: weights only
        # for edge_op 'add'; without them the kernel adds unit weight
        arrs = pg.channel_arrays(problem)
        unused = set()
        if not dynamic_skip_enabled(problem, pg, opts):
            unused.add("coverage")
        if not push_enabled(problem, pg, opts):
            unused.update(_PUSH_KEYS)
        return {
            k: pg.device_array(f, device, dtype=dt, phase_major=True, core=core)
            if arrs[k] is not None and k not in unused else None
            for k, (f, dt) in _KERNEL_FIELDS.items()
        }
    return {
        "src": pg.device_array("src_gidx", device, dtype=torch.int64, phase_major=True,
                               core=core),
        "dst": pg.device_array("dst_lidx", device, dtype=torch.int64, phase_major=True,
                               core=core),
        "valid": pg.device_array("valid", device, phase_major=True, core=core),
        "w": pg.device_array("weights", device, phase_major=True, core=core)
        if problem.edge_op == "add" else None,
    }


def phase_consts_at(consts, m: int):
    """Phase ``m``'s slice of every (phase-major) edge constant."""
    return {k: (v[m] if v is not None else None) for k, v in consts.items()}


def channel_phase_reduce(problem: Problem, pg: PartitionedGraph, gathered, cm, active=None):
    """The fused gather-map-reduce of one phase over all cores: one
    ``gather_reduce_cores`` launch, then the level-2 split-row fold or the
    row-packing undo. ``active`` ((p, R, T) bool, already ANDed with the
    real-tile mask) is the dynamic schedule, passed to the kernel as its
    fetch map; None is the static schedule. Returns (p, Vl[, L])."""
    reduced = gather_reduce_cores(
        gathered, cm["word"], cm["counts"], cm["word_hi"], cm["w"],
        fwords.active_fetch_map(active) if active is not None else None,
        num_rows=pg.packed_rows_per_core, vb=pg.tile_vb, src_bits=pg.src_bits,
        kind=problem.reduce_kind, edge_op=problem.edge_op, identity=problem.identity,
    )  # (p, R*vb) level-1 reductions in packed (virtual-)row space
    if cm["split_map"] is not None:
        return combine_split_rows(
            reduced, cm["split_map"], kind=problem.reduce_kind, identity=problem.identity
        )
    if cm["row_pos"] is not None:
        pos = cm["row_pos"]
        if reduced.dim() == 3:  # lane axis: one row index for every lane
            pos = pos.unsqueeze(-1).expand(*pos.shape, reduced.shape[-1])
        return torch.gather(reduced, 1, pos)
    return reduced


def channel_phase_scatter(problem: Problem, pg: PartitionedGraph, gathered, cm, active=None):
    """Push counterpart of ``channel_phase_reduce``: one
    ``scatter_reduce_cores`` launch over the source-binned push stream of the
    phase (``cm`` keyed like the pull constants). ``active`` is the
    frontier-ANDed (p, B, Tp) mask over the push stream's own coverage
    words. The output rows are natural rows, so there is no fold. Returns
    (p, Vl[, L])."""
    return scatter_reduce_cores(
        gathered, cm["word"], cm["counts"], cm["word_hi"], cm["w"],
        fwords.active_fetch_map(active) if active is not None else None,
        num_rows=pg.vertices_per_core, src_bits=pg.push_src_bits,
        kind=problem.reduce_kind, edge_op=problem.edge_op, identity=problem.identity,
    )


def _segment_reduce(kind, contrib, dst, num_segments, identity):
    """Per-core segment reduce of (n, E[, L]) contributions at rows ``dst``
    (int32 contributions are uint32 bits). Empty segments hold ``identity``
    (what the reference's segment ops fill; 0 for sums and ORs). 'or' is
    the reference's bit-plane form: a 0/1 max per bit."""
    n, e = contrib.shape[:2]
    lane_shape = tuple(contrib.shape[2:])
    idx = (dst + num_segments * torch.arange(n, device=dst.device).view(n, 1)).reshape(-1)
    flat = contrib.reshape(n * e, *lane_shape)
    size = n * num_segments
    if kind == "or":
        return _or_into(flat, idx, size).view(n, num_segments, *lane_shape)
    if kind == "min":
        return _min_into(flat, idx, size, identity).view(n, num_segments, *lane_shape)
    # sums accumulate in float64: on the card index_add_ adds in no fixed
    # order, and a hub row's float32 rounding would then rival the
    # reassociation differences the oracle is meant to bound
    out = torch.zeros((size,) + lane_shape, dtype=torch.float64, device=contrib.device)
    out.index_add_(0, idx, flat.to(torch.float64))
    return out.to(contrib.dtype).view(n, num_segments, *lane_shape)


def channel_phase_reduce_oracle(problem: Problem, pg: PartitionedGraph, gathered, cm):
    """Oracle form of the phase reduce (the reference's
    ``channel_phase_reduce_xla``): materialize (p, E_pad[, L]) contributions
    from the flat bucket arrays, then segment-reduce. Returns (p, Vl[, L])."""
    contrib = problem.edge_map(gathered[cm["src"]], cm["w"])  # (p, E_pad[, L])
    valid = cm["valid"]
    if contrib.dim() > valid.dim():  # the lane axis broadcasts
        valid = valid.unsqueeze(-1)
    contrib = torch.where(valid, contrib, problem.stored_identity)
    return _segment_reduce(problem.reduce_kind, contrib, cm["dst"], pg.vertices_per_core,
                           problem.identity)


def _gather_local(problem: Problem, pg: PartitionedGraph, labels, m: int):
    """Single-process crossbar: every core's phase-m sub-interval is a slice
    of the (p, Vl[, L]) payload; concatenating them IS the gathered block
    ((G,), or (G, L) with a lane axis)."""
    payload = problem.src_transform(labels)
    sub = payload[:, m * pg.sub_size : (m + 1) * pg.sub_size]
    return sub.reshape(pg.gathered_size, *payload.shape[2:])


def make_iteration(
    problem: Problem,
    pg: PartitionedGraph,
    opts: EngineOptions,
    device="cuda",
    with_stats: bool = False,
    *,
    reduce_at_phase=None,
    phase_active=None,
    density_fn=None,
    push_reduce_at_phase=None,
    push_phase_active=None,
    push_phase_live=None,
):
    """Build one engine iteration (the l-phase loop + apply semantics).

    The returned ``iteration(labels, frontier=None, prev_push=None, pop=None)``
    has the reference's calling modes:

      * ``iteration(labels)``: the static schedule; returns the new labels.
      * ``iteration(labels, frontier)``: the dynamic tile skip (requires
        ``dynamic_skip_enabled``). ``frontier`` is the (p, l, Ws) word
        tensor of the last iteration's label changes
        (``full_frontier_words`` on iteration 0); returns ``(labels,
        new_frontier)``. Pull only, unless ``direction='push'`` forces the
        push arm.
      * ``iteration(labels, frontier, prev_push)``: adds the push/pull switch
        (requires ``push_enabled``); ``prev_push`` is last iteration's
        direction (False on iteration 0) and the return gains the direction
        taken: ``(labels, new_frontier, used_push)``.

    ``pop`` is the host popcount of ``frontier`` (the caller read it as the
    convergence test); when None it is ``density_fn(frontier)``, read here.
    ``with_stats=True`` appends ``{"active_tiles": device int64 scalar,
    "use_dense": int[, "direction": int, "popcount": int]}`` to a dynamic
    call's return.

    Hooks (the reference's; the distributed engine supplies them, and when
    ``reduce_at_phase`` is None they are built here from the partition's
    edge tensors on ``device``, all p cores in this process):

      * ``reduce_at_phase(m, labels[, active]) -> reduced`` (steps 1+2 of
        phase m, shaped like ``labels[merge_field]``);
      * ``phase_active(m, words, use_dense) -> active``: phase m's tile mask
        from ``words``, the live frontier words of phase m of the cores held
        here (``frontier[:, m]`` flattened, core-major);
      * ``density_fn(frontier) -> popcount`` (host int or scalar tensor);
      * ``push_reduce_at_phase(m, labels, active)`` and
        ``push_phase_active(m, words)``, the push arm's two; a caller that
        supplies ``reduce_at_phase`` without them runs pull only;
      * ``push_phase_live(m, words) -> bool``: when given, a push phase it
        rejects is skipped outright (no exchange, no launch). It must answer
        the same on every rank. Without it a dead phase runs with an
        all-inactive fetch map: the launch does nothing, the result is the
        same, and no host read is made.

    'or' problems (packed multi-source BFS) always take the synchronous
    schedule, whatever ``immediate_updates`` says: their ``finalize``
    recovers hop levels from a per-iteration counter, which async multi-hop
    propagation would corrupt."""
    if opts.lanes is not None and opts.lanes != problem.lanes:
        raise ValueError(
            f"EngineOptions.lanes={opts.lanes} but problem {problem.name!r} "
            f"declares lanes={problem.lanes}"
        )
    dev = resolve_device(device)
    mf = problem.merge_field
    is_min = problem.reduce_kind == "min"
    is_or = problem.reduce_kind == "or"
    minimum = u32.minimum if problem.payload_u32 else torch.minimum
    dyn = dynamic_skip_enabled(problem, pg, opts)
    push_on = push_enabled(problem, pg, opts)
    forced_push = opts.direction == "push"
    if forced_push and not push_on:
        raise ValueError(
            "direction='push' requires an admissible push path: a min/or "
            "problem, the kernel backend, a partition built with "
            "build_push=True, and dynamic scheduling (dynamic_skip_enabled)"
        )
    if reduce_at_phase is None:
        consts = _edge_constants(problem, pg, opts, dev)
        coverage = consts.pop("coverage", None)
        push = {k: consts.pop(k, None) for k in _PUSH_KEYS}
        push_cm_all = {"word": push["push_word"], "word_hi": push["push_word_hi"],
                       "counts": push["push_counts"], "w": push["push_w"]}
        reduce_fn = (channel_phase_reduce if opts.backend == "kernel"
                     else channel_phase_reduce_oracle)

        def reduce_at_phase(m, labels, active=None):
            gathered = _gather_local(problem, pg, labels, m)
            if active is None:
                return reduce_fn(problem, pg, gathered, phase_consts_at(consts, m))
            return channel_phase_reduce(problem, pg, gathered, phase_consts_at(consts, m),
                                        active)

        def push_reduce_at_phase(m, labels, active):
            gathered = _gather_local(problem, pg, labels, m)
            return channel_phase_scatter(problem, pg, gathered,
                                         phase_consts_at(push_cm_all, m), active)

        def phase_active(m, gfw, use_dense):
            # gfw: phase m's live frontier words in gathered order (the cores'
            # [:, m] rows, core-major: the layout contract of the coverage words)
            return fwords.frontier_active_tiles(coverage[m], gfw, consts["counts"][m],
                                                use_dense)

        def push_phase_active(m, gfw):
            # no dense fallback: a wide frontier takes the pull arm. A phase with
            # no live source gets an all-inactive map, which is the reference's
            # phase-level skip without a host read.
            return fwords.frontier_active_tiles(push["push_coverage"][m], gfw,
                                                push["push_counts"][m], None)
    else:
        if dyn and phase_active is None:
            raise ValueError("a caller-supplied reduce_at_phase needs phase_active for "
                             "the dynamic schedule")
        if push_on and (push_reduce_at_phase is None or push_phase_active is None):
            if forced_push:
                raise ValueError("direction='push' with caller-supplied reduce hooks needs "
                                 "push_reduce_at_phase/push_phase_active")
            push_on = False
    if density_fn is None:
        density_fn = fwords.frontier_popcount

    total_bits = pg.p * pg.l * pg.sub_size
    dense_thr = int(total_bits * opts.dynamic_skip_density)
    # Beamer thresholds scaled by 1/K for a K-lane batch: a push pass
    # scatters each changed vertex's whole lane row, so the crossover moves
    # down K-fold (one switch per batch, on the union popcount)
    lane_k = max(problem.lanes, 1)
    alpha_thr = int(total_bits * opts.direction_alpha / lane_k)
    beta_thr = int(total_bits * opts.direction_beta / lane_k)

    def words_of(old, new):
        # lane-batched labels: the frontier is the union over lanes
        return fwords.frontier_words_from_labels(old, new, pg.l, pg.sub_size,
                                                 lanes=problem.lanes > 0)

    def gathered_words(fw, m):
        return fw[:, m].reshape(-1)

    def count(n_act, active):
        return n_act + active.sum() if with_stats else n_act

    def async_sweep(labels, fw_in, reduce_m, active_m, live_m=None):
        """The async phase sweep of either direction: the live frontier is
        last iteration's changes OR this iteration's so far, since later
        phases see fresh labels. ``live_m`` skips a phase it rejects."""
        nf = torch.zeros_like(fw_in)
        n_act = torch.zeros((), dtype=torch.int64, device=fw_in.device)
        for m in range(pg.l):
            words = gathered_words(fw_in, m) | gathered_words(nf, m)
            if live_m is not None and not live_m(m, words):
                continue
            active = active_m(m, words)
            lab = labels[mf]
            merged = minimum(lab, reduce_m(m, labels, active))
            labels = dict(labels)
            labels[mf] = merged
            nf = nf | words_of(lab, merged)
            n_act = count(n_act, active)
        return labels, nf, n_act

    def sync_sweep(labels, frontier, reduce_m, active_m, live_m=None):
        """The synchronous sweep: contributions accumulate over the phases,
        which all see last iteration's labels (and frontier). ``live_m``
        skips a phase it rejects."""
        lab = labels[mf]
        if is_min:
            acc = torch.full_like(lab, problem.stored_identity)
        elif is_or:
            acc = torch.zeros_like(lab)
        else:
            acc = torch.full(lab.shape, problem.identity, dtype=torch.float32, device=lab.device)
        n_act = torch.zeros((), dtype=torch.int64, device=lab.device)
        for m in range(pg.l):
            if active_m is None:
                reduced = reduce_m(m, labels)
            else:
                words = gathered_words(frontier, m)
                if live_m is not None and not live_m(m, words):
                    continue
                active = active_m(m, words)
                n_act = count(n_act, active)
                reduced = reduce_m(m, labels, active)
            if is_min:
                acc = minimum(acc, reduced)
            else:
                acc = acc | reduced if is_or else acc + reduced
        return acc, n_act

    def static(labels):
        if is_min and opts.immediate_updates:
            for m in range(pg.l):
                labels = dict(labels)
                labels[mf] = minimum(labels[mf], reduce_at_phase(m, labels))
            return labels
        acc, _ = sync_sweep(labels, None, reduce_at_phase, None)
        if is_min:
            new = dict(labels)
            new[mf] = minimum(labels[mf], acc)
            return new
        return problem.finalize(labels, acc)

    def iteration(labels, frontier=None, prev_push=None, pop=None):
        if frontier is None:
            if prev_push is not None:
                raise ValueError("prev_push requires a frontier")
            return static(labels)
        if not dyn:
            raise ValueError(
                "iteration got a frontier but dynamic skipping is disabled "
                "(see dynamic_skip_enabled)"
            )
        if prev_push is not None and not push_on:
            raise ValueError(
                "iteration got prev_push but the push direction is not "
                "admissible (see push_enabled)"
            )
        if pop is None:
            pop = int(density_fn(frontier))
        use_dense = pop >= dense_thr
        push_aware = push_on and (prev_push is not None or forced_push)
        if forced_push:
            use_push = True
        elif push_aware:  # Beamer hysteresis: stay push while below beta
            use_push = pop < alpha_thr or (bool(prev_push) and pop < beta_thr)
        else:
            use_push = False
        if use_push:
            reduce_m, active_m, live_m = push_reduce_at_phase, push_phase_active, push_phase_live
        else:
            reduce_m, live_m = reduce_at_phase, None
            active_m = functools.partial(phase_active, use_dense=use_dense)
        if is_min and opts.immediate_updates:
            new, nf, n_act = async_sweep(labels, frontier, reduce_m, active_m, live_m)
        else:
            acc, n_act = sync_sweep(labels, frontier, reduce_m, active_m, live_m)
            if is_min:
                new = dict(labels)
                new[mf] = minimum(labels[mf], acc)
            else:  # 'or': the new reach words and their hop levels
                new = problem.finalize(labels, acc)
            # monotone: the words of (labels in vs out) are the frontier
            nf = words_of(labels[mf], new[mf])
        out = (new, nf)
        if prev_push is not None:
            out += (use_push,)
        if with_stats:
            stats = {"active_tiles": n_act, "use_dense": int(use_dense)}
            if push_aware:
                stats.update(direction=int(use_push), popcount=pop)
            out += (stats,)
        return out

    return iteration


def _dynamic_steps(problem, pg, opts, labels, dev, with_stats=False):
    """The frontier-carried loop shared by ``run`` and
    ``run_frontier_trace``: yields each iteration's result tuple and the
    new frontier's popcount, the one value read back per iteration."""
    iteration = make_iteration(problem, pg, opts, device=dev, with_stats=with_stats)
    fw = fwords.full_frontier_words(pg.l, pg.sub_size, lead=(pg.p,), device=dev)
    pop = pg.p * pg.l * pg.sub_size  # the full frontier's popcount, known here
    prev = False if push_enabled(problem, pg, opts) else None
    it = 0
    while pop > 0 and it < opts.max_iters:
        out = iteration(labels, fw, prev, pop=pop)
        labels, fw = out[0], out[1]
        if prev is not None:
            prev = out[2]
        pop = int(fwords.frontier_popcount(fw))
        it += 1
        yield labels, out, pop


def run(
    problem: Problem,
    g,
    pg: PartitionedGraph,
    opts: EngineOptions = EngineOptions(),
    labels: Dict[str, torch.Tensor] | None = None,
    device="cuda",
) -> EngineResult:
    """Run ``problem`` to convergence on ``device`` (the card unless the
    caller asks for ``"cpu"``). ``labels`` (a ``prepare_labels`` or
    ``labels_from_numpy`` tree) overrides the problem's own init."""
    dev = resolve_device(device)
    if labels is None:
        labels = prepare_labels(problem, g, pg, device=dev)
    it, changed = 0, True
    if dynamic_skip_enabled(problem, pg, opts):
        for labels, _, pop in _dynamic_steps(problem, pg, opts, labels, dev):
            it, changed = it + 1, pop > 0
    else:
        iteration = make_iteration(problem, pg, opts, device=dev)
        while changed and it < opts.max_iters:
            new = iteration(labels)
            changed = bool(problem.not_converged(labels, new))
            labels = new
            it += 1
    return EngineResult(
        labels=unpad_labels(labels, pg, u32_fields=problem.u32_fields),
        iterations=it,
        converged=not changed,
    )


def run_frontier_trace(
    problem: Problem, g, pg: PartitionedGraph, opts: EngineOptions = EngineOptions(),
    device="cuda",
) -> dict:
    """A dynamic run that records the per-iteration schedule: the reference's
    ``run_frontier_trace``. Same numerics as ``run``; each iteration's
    active-tile count is read back too. Returns the final ``labels`` /
    ``iterations`` / ``converged`` plus ``dynamic_skipped_tile_fraction``,
    per iteration, over all (core, phase, row-block) x T tile slots (a push
    iteration's over the push stream's (core, phase, source-block) x Tp
    slots), ``dense_iterations``, ``direction`` ('push'/'pull' per
    iteration) and ``push_iterations``."""
    if not dynamic_skip_enabled(problem, pg, opts):
        raise ValueError(
            "run_frontier_trace needs dynamic skipping: a min problem, the "
            "kernel backend, coverage words, and dynamic_tile_skip=True"
        )
    dev = resolve_device(device)
    labels = prepare_labels(problem, g, pg, device=dev)
    total_tiles = pg.tile_counts.size * pg.tile_word.shape[3]
    total_push_tiles = (
        pg.push_counts.size * pg.push_word.shape[3] if push_enabled(problem, pg, opts) else 0
    )
    fractions, directions = [], []
    dense_iters, it, pop = 0, 0, 1
    for labels, out, pop in _dynamic_steps(problem, pg, opts, labels, dev, with_stats=True):
        stats = out[-1]
        pushed = bool(stats.get("direction", 0))
        total = total_push_tiles if pushed else total_tiles
        fractions.append(1.0 - int(stats["active_tiles"]) / max(total, 1))
        directions.append("push" if pushed else "pull")
        dense_iters += stats["use_dense"]
        it += 1
    return {
        "labels": unpad_labels(labels, pg, u32_fields=problem.u32_fields),
        "iterations": it,
        "converged": pop == 0,
        "dynamic_skipped_tile_fraction": fractions,
        "mean_dynamic_skipped_tile_fraction": float(np.mean(fractions)) if fractions else 0.0,
        "dense_iterations": dense_iters,
        "direction": directions,
        "push_iterations": directions.count("push"),
    }


def evict_from_cache(pg: PartitionedGraph) -> bool:
    """Drop a retired partition's device copies (typically the pre-flush
    ``PartitionedGraph`` after ``partition.apply_edge_deltas``).

    The port has no trace cache; what a retired partition pins is its
    ``device_cache``, the edge tensors every run on it uploaded (about 8.8 GB
    at RMAT scale 20 with the push stream). A flush returns a NEW partition
    with an empty cache, so the old copies can never serve the updated
    graph; clearing them frees that device memory once no caller holds the
    tensors. The serving loop calls this on every flush. Returns True if
    anything was dropped."""
    had = bool(pg.device_cache)
    pg.device_cache.clear()
    return had
