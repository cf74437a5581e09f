"""The fixed-order segment sum and the take whose gradient it is.

``segment_sum(x, seg, num_segments)`` is ``jax.ops.segment_sum``: out[s]
is the sum of the rows x[i] with seg[i] == s, ids outside [0, num_segments)
dropped, added in a fixed order: ascending i within each segment (a segment
of more than ``kernel.CHUNK`` rows: its chunks of ``CHUNK`` rows in
ascending order, their sums again in chunks, see ``tree_levels``), in
float32 for float32 and bf16 (rounded once at the end) and in float64 for
float64. The order is the layout's alone, so two calls give the same bits
on the card, where ``index_add`` does not. Its gradient is the gather
``grad[seg]`` (0 for a dropped id), by plain indexing, which is
deterministic.

``take(table, ids)`` is ``table[ids]``; its gradient into the table is the
fixed-order segment sum of the rows' gradients over ``ids`` (a take is a bag
of one id: the layout is the bag backward's sort and run starts). DIN's
takes and the MoE dispatch go through it.

The layout is a stable sort of the ids, the start of each segment's run
(``searchsorted``) and the run of every ``kernel.MARK``-th sorted position
(the sorted id there), built on the ids' device with no host read: the
kernel computes the tree of every run from them in one launch, and the
plain version on the CPU derives the tree's levels from ``start`` on the
host (``tree_levels``). A
caller that sums over the same ids more than once builds it once
(``segment_layout``) and passes it: GAT's softmax layout carries one per
batch (``kernels.segment_softmax.ops.EdgeTiles``), and the other GNNs keep
one on the batch (``models.gnn.common.edge_layout``). Both functions take
the torch-function protocol (a dry run's ``launch.sharded.ShardedForms``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
from torch.overrides import handle_torch_function, has_torch_function

from repro_torch.kernels.fake import is_fake
from repro_torch.kernels.segment_sum import kernel

__all__ = ["SegmentLayout", "segment_layout", "tree_levels", "segment_sum", "take",
           "segment_sum_plain"]


@dataclasses.dataclass(frozen=True)
class SegmentLayout:
    """The order a segment sum adds in: ``order`` (n,) int64, the row at each
    sorted position (None: the rows are already in segment order), and
    ``start`` (num_segments + 1,) int64, each segment's first position; run
    s is positions [start[s], start[s + 1]). ``covers_all``: the caller
    knows every row lies in a run (no id outside [0, num_segments)); False
    makes the sum's gradient mask its gather. ``max_run``: a bound on every
    run the caller knows (a run of at most ``CHUNK`` rows is one fold).
    ``marks``: the run holding every ``kernel.MARK``-th position (an id
    outside [0, num_segments) there: in no run), where a run may exceed
    ``CHUNK`` rows; the kernel finds a long run's chunks by them (None:
    ``kernel.run_marks`` derives them from ``start`` on the card)."""

    order: Optional[torch.Tensor]
    start: torch.Tensor
    num_rows: int
    covers_all: bool = False
    max_run: Optional[int] = None
    marks: Optional[torch.Tensor] = None

    @property
    def num_segments(self) -> int:
        return int(self.start.shape[0]) - 1

    @property
    def device(self) -> torch.device:
        return self.start.device

    @functools.cached_property
    def levels(self) -> tuple:
        """The tree's levels (``tree_levels``), derived on the host at first
        use: the plain version's; the kernel never reads them."""
        return tree_levels(self.start, self.max_run)

    def to(self, device) -> "SegmentLayout":
        move = lambda t: None if t is None else t.to(device)  # noqa: E731
        return dataclasses.replace(self, order=move(self.order), start=move(self.start),
                                   marks=move(self.marks))


def tree_levels(start: torch.Tensor, max_run: Optional[int] = None) -> tuple:
    """The levels of the tree a segment sum folds in, from the runs'
    ``start``: per level the (k + 1,) int64 run starts; a level's runs sum
    the previous level's outputs (the first level's, rows through the
    layout's order), and the last level's runs are the segments. Every run
    longer than ``CHUNK`` is cut into chunks of ``CHUNK`` in run order, the
    chunks' sums a run of the next level, until no run is longer: one host
    read for the longest run, one more a level added. ``max_run`` at most
    ``CHUNK``: one level and no host read."""
    c = kernel.CHUNK
    if max_run is not None and max_run <= c:
        return (start,)
    lens = start[1:] - start[:-1]
    longest = int(lens.max()) if lens.numel() else 0
    levels = []
    cur = start
    s = lens.shape[0]
    while longest > c:
        nc = (lens + c - 1) // c  # chunks a run
        cs = torch.cat([cur.new_zeros(1), torch.cumsum(nc, 0)])  # the next level's starts
        k = int(cs[-1])
        run_of = torch.repeat_interleave(torch.arange(s, device=cur.device), nc, output_size=k)
        j = torch.arange(k, device=cur.device) - cs[run_of]
        levels.append(torch.cat([cur[run_of] + j * c, cur[-1:]]))
        cur, lens, longest = cs, nc, -(-longest // c)
    levels.append(cur)
    return tuple(levels)


def segment_layout(seg: torch.Tensor, num_segments: int, *, max_run: Optional[int] = None,
                   covers_all: bool = False) -> SegmentLayout:
    """The layout of segment ids ``seg`` (any shape, flattened) on their
    device: a stable sort and each segment's run start by ``searchsorted``,
    the bag backward's runs (``sorted_runs``), and, where a run may exceed
    ``CHUNK`` rows, the sorted ids at every ``MARK``-th position, with no
    host read; an id < 0 sorts first and one >= num_segments last, in no
    run. ``max_run`` and ``covers_all`` as ``SegmentLayout``'s."""
    from repro_torch.kernels.embedding_bag.kernel import sorted_runs

    flat = seg.reshape(-1)
    keys, order, start = sorted_runs(flat, num_segments)
    marks = None
    if max_run is None or max_run > kernel.CHUNK:
        marks = keys[::kernel.MARK].to(torch.int64).contiguous()
    return SegmentLayout(order=order, start=start, num_rows=flat.shape[0], covers_all=covers_all,
                         max_run=max_run, marks=marks)


def _gather(g: torch.Tensor, seg: torch.Tensor, covers_all: bool) -> torch.Tensor:
    """grad[seg] by plain indexing, 0 for ids outside [0, len(g))."""
    idx = seg.reshape(-1).long()
    if covers_all:
        return g[idx]
    n = g.shape[0]
    inside = (idx >= 0) & (idx < n)
    rows = g[idx.clamp(0, n - 1)]
    return torch.where(inside.view((-1,) + (1,) * (g.dim() - 1)), rows, 0)


def _sum(x: torch.Tensor, seg: torch.Tensor, num_segments: int, layout) -> torch.Tensor:
    if layout is None and not is_fake(x):
        layout = segment_layout(seg, num_segments)
    if layout is not None and (layout.num_segments != num_segments or
                               layout.num_rows != x.shape[0]):
        raise ValueError(f"layout of {layout.num_rows} rows in {layout.num_segments} segments, "
                         f"sum of {x.shape[0]} rows into {num_segments}")
    flat = x.reshape(x.shape[0], -1).contiguous()
    out = kernel.segment_sum_rows(flat, seg, layout, num_segments)
    return out.reshape((num_segments,) + tuple(x.shape[1:])), layout


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seg, num_segments, layout):
        out, layout = _sum(x, seg, num_segments, layout)
        ctx.save_for_backward(seg)
        ctx.covers_all = layout is not None and layout.covers_all
        return out

    @staticmethod
    def backward(ctx, g):
        (seg,) = ctx.saved_tensors
        return _gather(g, seg, ctx.covers_all), None, None, None


def segment_sum(x: torch.Tensor, seg: torch.Tensor, num_segments: int,
                layout: Optional[SegmentLayout] = None) -> torch.Tensor:
    """x (E, ...) float32, bf16 (float64 on the CPU) summed over ``seg`` (E,)
    -> (num_segments, ...) in x's type, in the fixed order of ``layout``
    (``segment_layout(seg, num_segments)``, built here when None).
    Differentiable in x."""
    if has_torch_function((x, seg)):
        return handle_torch_function(segment_sum, (x, seg), x, seg, num_segments,
                                     layout=layout)
    return _SegmentSum.apply(x, seg, num_segments, layout)


class _Take(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids, layout):
        ctx.save_for_backward(ids)
        ctx.layout = layout
        ctx.rows = table.shape[0]
        return table.index_select(0, ids.reshape(-1)).reshape(
            tuple(ids.shape) + tuple(table.shape[1:]))

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        flat = g.reshape((-1,) + tuple(g.shape[ids.dim():]))
        n = ctx.rows if ctx.layout is None else ctx.layout.num_segments
        grad, _ = _sum(flat, ids.reshape(-1), n, ctx.layout)
        if n < ctx.rows:  # the rows past the layout's segments: no gradient
            grad = torch.cat([grad, grad.new_zeros((ctx.rows - n,) + tuple(grad.shape[1:]))])
        return grad, None, None


def take(table: torch.Tensor, ids: torch.Tensor,
         layout: Optional[SegmentLayout] = None) -> torch.Tensor:
    """``table[ids]`` (ids in [0, len(table)), any shape) -> ids.shape +
    table.shape[1:]; the table's gradient is ``segment_sum`` of the rows'
    gradients over ``ids`` (``layout``: theirs, built in the backward when
    None). A layout of fewer segments than the table's rows leaves the rows
    past them (and the ids naming them) out: those rows get no gradient (the
    MoE dispatch's zero row of the empty slots)."""
    if has_torch_function((table, ids)):
        return handle_torch_function(take, (table, ids), table, ids, layout=layout)
    return _Take.apply(table, ids, layout)


def segment_sum_plain(x: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """The plain version on any device: the same layout and order, each level
    through ``kernel.fold_runs_plain`` (no kernel, no autograd)."""
    flat = x.reshape(x.shape[0], -1).contiguous()
    y = kernel.sum_levels(flat, segment_layout(seg, num_segments), kernel.fold_runs_plain)
    return y.reshape((num_segments,) + tuple(x.shape[1:]))
