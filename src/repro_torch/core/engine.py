"""Asynchronous pull-based vertex-centric engine (paper §III-A/B), on torch.

Counterpart of ``repro.core.engine`` for the STATIC schedule. The ``p``
graph cores are a leading tensor axis; the crossbar is the phase-m gathered
label block. Per iteration (paper Fig. 4):

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
    compressed (p, R, T, Eb) word stream and skipping padding tiles. On the
    card that is the hand-written CUDA kernel; on the CPU its plain PyTorch
    version. Hub rows split at partition time are folded back into natural
    rows by ``combine_split_rows``; LPT row packing is undone by a gather.
  * ``'oracle'`` (the reference's ``'xla'``): materializes the (p, E_pad)
    contributions of the flat bucket arrays and scatter-reduces them.
    Bit-identical to the kernel for min problems; sum problems (PageRank)
    agree to float-summation-order reassociation.

This slice runs the static schedule only. The reference's frontier-aware
dynamic tile skip and push direction give the same labels and iteration
counts as its static schedule, so ``run`` with the port's defaults equals
the reference's ``run`` with its own defaults. Asking for either raises
``NotImplementedError`` until they are ported. The convergence flag is read
back to the host once per iteration.

uint32 labels follow ``core.u32`` (int32 storage, widened for ordered ops).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.core import u32
from repro_torch.core.partition import PartitionedGraph
from repro_torch.core.problems import Problem
from repro_torch.device import resolve_device
from repro_torch.kernels.csr_gather_reduce.kernel import gather_reduce_cores
from repro_torch.kernels.csr_gather_reduce.ops import combine_split_rows

__all__ = [
    "EngineOptions",
    "EngineResult",
    "prepare_labels",
    "labels_from_numpy",
    "unpad_labels",
    "make_iteration",
    "phase_consts_at",
    "channel_phase_reduce",
    "channel_phase_reduce_oracle",
    "run",
]

_BACKENDS = ("kernel", "oracle")


@dataclasses.dataclass(frozen=True)
class EngineOptions:
    immediate_updates: bool = True  # paper opt 1: async write-back
    max_iters: int = 1000
    # 'kernel': gather_reduce_cores, one launch per phase (reference 'pallas').
    # 'oracle': materialize-then-reduce (reference 'xla').
    backend: str = "kernel"
    # not ported yet: both must stay at these values (see module docstring)
    dynamic_tile_skip: bool = False
    direction: str = "pull"

    def __post_init__(self):
        if self.backend not in _BACKENDS:
            raise ValueError(f"backend must be one of {_BACKENDS}, got {self.backend!r}")
        if self.direction not in ("auto", "push", "pull"):
            raise ValueError(
                f"direction must be 'auto', 'push' or 'pull', got {self.direction!r}"
            )
        if self.dynamic_tile_skip:
            raise NotImplementedError("dynamic_tile_skip is not ported yet")
        if self.direction != "pull":
            raise NotImplementedError(f"direction={self.direction!r} is not ported yet")


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
    and move to ``device`` (uint32 fields as int32 bits)."""
    dev = resolve_device(device)
    padded = pg.padded_vertices
    out = {}
    for k, v in problem.init_labels(g, padded).items():
        v = np.asarray(v)
        if v.ndim == 1 and v.shape[0] == padded:
            if pg.perm is not None:
                # perm is a bijection on [0, V); slots >= V keep their init
                moved = v.copy()
                moved[pg.perm[: pg.num_vertices]] = v[: pg.num_vertices]
                v = moved
            v = v.reshape(pg.p, pg.vertices_per_core)
        out[k] = _to_tensor(v, dev)
    return out


def labels_from_numpy(tree: Dict[str, np.ndarray], device="cuda"):
    """State carry-over: a reference ``prepare_labels`` tree, as numpy arrays
    (already permuted and shaped (p, Vl)), to the port's label tensors."""
    dev = resolve_device(device)
    return {k: _to_tensor(np.asarray(v), dev) for k, v in tree.items()}


def unpad_labels(labels, pg: PartitionedGraph, u32_fields=()) -> Dict[str, np.ndarray]:
    """Back to original vertex ids (undo stride permutation + padding) as
    numpy; ``u32_fields`` come back as uint32."""
    out = {}
    for k, v in labels.items():
        v = u32.from_bits(v) if k in u32_fields else v.detach().cpu().numpy()
        if v.ndim == 2 and v.shape == (pg.p, pg.vertices_per_core):
            flat = v.reshape(pg.padded_vertices)
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
}


def _edge_constants(problem: Problem, pg: PartitionedGraph, opts: EngineOptions, device):
    """Per-phase edge tensors on ``device``, phase-major so that a phase's
    slice is contiguous, uploaded once per graph (``pg.device_array``)."""
    if opts.backend == "kernel":
        # channel_arrays(problem) is the weight-streaming rule: weights only
        # for edge_op 'add'; without them the kernel adds unit weight
        arrs = pg.channel_arrays(problem)
        return {
            k: pg.device_array(f, device, dtype=dt, phase_major=True)
            if arrs[k] is not None else None
            for k, (f, dt) in _KERNEL_FIELDS.items()
        }
    return {
        "src": pg.device_array("src_gidx", device, dtype=torch.int64, phase_major=True),
        "dst": pg.device_array("dst_lidx", device, dtype=torch.int64, phase_major=True),
        "valid": pg.device_array("valid", device, phase_major=True),
        "w": pg.device_array("weights", device, phase_major=True)
        if problem.edge_op == "add" else None,
    }


def phase_consts_at(consts, m: int):
    """Phase ``m``'s slice of every (phase-major) edge constant."""
    return {k: (v[m] if v is not None else None) for k, v in consts.items()}


def channel_phase_reduce(problem: Problem, pg: PartitionedGraph, gathered, cm):
    """The fused gather-map-reduce of one phase over all cores: one
    ``gather_reduce_cores`` launch, then the level-2 split-row fold or the
    row-packing undo. Returns (p, Vl)."""
    reduced = gather_reduce_cores(
        gathered, cm["word"], cm["counts"], cm["word_hi"], cm["w"],
        num_rows=pg.packed_rows_per_core, vb=pg.tile_vb, src_bits=pg.src_bits,
        kind=problem.reduce_kind, edge_op=problem.edge_op, identity=problem.identity,
    )  # (p, R*vb) level-1 reductions in packed (virtual-)row space
    if cm["split_map"] is not None:
        return combine_split_rows(
            reduced, cm["split_map"], kind=problem.reduce_kind, identity=problem.identity
        )
    if cm["row_pos"] is not None:
        return torch.gather(reduced, 1, cm["row_pos"])
    return reduced


def _segment_reduce(kind, contrib, dst, num_segments, identity, is_u32):
    """Per-core segment reduce of (n, E) contributions at rows ``dst``. Empty
    segments hold ``identity`` (what the reference's segment ops fill; 0 for
    sums)."""
    n = contrib.shape[0]
    idx = (dst + num_segments * torch.arange(n, device=dst.device).view(n, 1)).reshape(-1)
    if is_u32:
        out = torch.full((n * num_segments,), int(identity) & u32.U32_MAX,
                         dtype=torch.int64, device=contrib.device)
        out.scatter_reduce_(0, idx, u32.widen(contrib).reshape(-1), "amin")
        return u32.narrow(out).view(n, num_segments)
    if kind == "min":
        out = torch.full((n * num_segments,), identity, dtype=contrib.dtype, device=contrib.device)
        out.scatter_reduce_(0, idx, contrib.reshape(-1), "amin")
        return out.view(n, num_segments)
    # sums accumulate in float64: on the card index_add_ adds in no fixed
    # order, and a hub row's float32 rounding would then rival the
    # reassociation differences the oracle is meant to bound
    out = torch.zeros(n * num_segments, dtype=torch.float64, device=contrib.device)
    out.index_add_(0, idx, contrib.reshape(-1).to(torch.float64))
    return out.to(contrib.dtype).view(n, num_segments)


def channel_phase_reduce_oracle(problem: Problem, pg: PartitionedGraph, gathered, cm):
    """Oracle form of the phase reduce (the reference's
    ``channel_phase_reduce_xla``): materialize (p, E_pad) contributions from
    the flat bucket arrays, then segment-reduce. Returns (p, Vl)."""
    contrib = problem.edge_map(gathered[cm["src"]], cm["w"])
    contrib = torch.where(cm["valid"], contrib, problem.stored_identity)
    return _segment_reduce(
        problem.reduce_kind, contrib, cm["dst"], pg.vertices_per_core,
        problem.identity, problem.payload_u32,
    )


def _gather_local(problem: Problem, pg: PartitionedGraph, labels, m: int):
    """Single-process crossbar: every core's phase-m sub-interval is a slice
    of the (p, Vl) payload; concatenating them IS the gathered block (G,)."""
    payload = problem.src_transform(labels)
    sub = payload[:, m * pg.sub_size : (m + 1) * pg.sub_size]
    return sub.reshape(pg.gathered_size)


def make_iteration(problem: Problem, pg: PartitionedGraph, opts: EngineOptions, device="cuda"):
    """Build one engine iteration (the l-phase loop + apply semantics) on the
    static schedule: ``iteration(labels) -> new labels``."""
    dev = resolve_device(device)
    consts = _edge_constants(problem, pg, opts, dev)
    reduce_fn = channel_phase_reduce if opts.backend == "kernel" else channel_phase_reduce_oracle
    mf = problem.merge_field
    is_min = problem.reduce_kind == "min"
    minimum = u32.minimum if problem.payload_u32 else torch.minimum

    def reduce_at_phase(m, labels):
        gathered = _gather_local(problem, pg, labels, m)
        return reduce_fn(problem, pg, gathered, phase_consts_at(consts, m))

    if is_min and opts.immediate_updates:

        def iteration(labels):
            for m in range(pg.l):
                labels = dict(labels)
                labels[mf] = minimum(labels[mf], reduce_at_phase(m, labels))
            return labels

        return iteration

    # synchronous path: accumulate contributions, apply at iteration end
    def iteration(labels):
        lab = labels[mf]
        if is_min:
            acc = torch.full_like(lab, problem.stored_identity)
        else:
            acc = torch.full(lab.shape, problem.identity, dtype=torch.float32, device=lab.device)
        for m in range(pg.l):
            reduced = reduce_at_phase(m, labels)
            acc = minimum(acc, reduced) if is_min else acc + reduced
        if is_min:
            new = dict(labels)
            new[mf] = minimum(lab, acc)
            return new
        return problem.finalize(labels, acc)

    return iteration


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
    iteration = make_iteration(problem, pg, opts, device=dev)
    it, changed = 0, True
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
