"""The dry run's forms of the port's ops on DTensors.

The models and kernels are written for plain tensors. A dry run
(``launch.dryrun``) traces them on DTensors placed on a production mesh,
where DTensor (torch 2.11) either refuses some of their ops or shards them
by its own cheapest-move rule, which can replicate the work. ``ShardedForms``
is a ``TorchFunctionMode`` that the dry run holds over a trace: an op with a
DTensor operand that has a form here runs as that form, every other call as
written. Nothing here runs outside a dry run.

The forms:

  * ``x @ w`` (x of 3 or more dims): one 2-D product with every split
    placed (``matmul``): x keeps its batch split, ``w`` its split on the
    other mesh dims. Each rank multiplies its share.
  * ``table[ids]``, ``index_select``: ``F.embedding`` on a 2-D table.
  * ``zeros.index_add(0, idx, src)``: each rank adds its rows into a
    whole-size buffer, reduce-scattered (``segment_sum``).
  * ``gather`` along the last dim: on 2-D rows, the masked partial reduced.
  * ``reshape``, ``view``: a split of a dim the reshape merges or splits
    that DTensor's view cannot keep (uneven: K/V heads fewer than the
    ranks) is gathered first, in the forward and in the backward.
  * the kernels (their entry points take the torch-function protocol):
    ``local_map`` over each rank's local tensors, with the splits each
    kernel's math allows kept (``run_local``).

``torch.autograd.grad`` runs its engine with every torch-function mode off,
so a checkpointed block's recompute would miss the forms: while the mode is
held (``with ShardedForms():``) the models' ``checkpoint`` calls get a
``context_fn`` that holds it over the recompute too.

Where the operand that sets a kernel's work is not split over a mesh dim
(gathered by the form, or too small to split), every rank of that dim does
the same work: the form says so to every active ``Replicated`` recorder, and
the dry run writes it into the cell's record.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List

import torch
from torch.overrides import TorchFunctionMode

__all__ = ["ShardedForms", "Replicated", "run_local", "matmul", "take_rows",
           "segment_sum", "rows_only", "reduce_partial"]

_ACTIVE: List["Replicated"] = []


class Replicated:
    """Collects, while active, the kernels whose work a form replicated:
    ``{name: factor}``, the factor the largest seen (the number of ranks that
    do the same work)."""

    def __init__(self) -> None:
        self.factors: Dict[str, int] = {}

    def __enter__(self) -> "Replicated":
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE.remove(self)


def _note_replicated(name: str, factor: int) -> None:
    if factor > 1:
        for rec in _ACTIVE:
            rec.factors[name] = max(rec.factors.get(name, 1), factor)


def _dtensor_type():
    from torch.distributed.tensor import DTensor

    return DTensor


def _is_dt(x) -> bool:
    return isinstance(x, _dtensor_type())


def run_local(fn, args, keep_dims, name: str = ""):
    """``fn(*args)`` on each rank's local tensors of the DTensors in ``args``
    (``local_map``): arg i keeps a ``Shard(d)`` placement for d in
    ``keep_dims[i]`` (the dims its math lets split, such as a batch) and is
    redistributed to ``Replicate`` on every other mesh dim; a plain tensor
    or other value passes through. The outputs take the first DTensor's
    placements. Differentiable. The mesh dims that do not split the first
    DTensor, as placed, replicate ``fn``'s work: reported to ``Replicated``
    under ``name``."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh, first, in_pl = None, None, []
    for a, dims in zip(args, keep_dims):
        if not _is_dt(a):
            in_pl.append(None)
            continue
        mesh = a.device_mesh if mesh is None else mesh
        pl = [p if isinstance(p, Shard) and p.dim in dims else Replicate()
              for p in a.placements]
        if first is None:
            first = pl
            # the ranks that do the same work: every mesh dim that does not
            # split this operand, as placed
            _note_replicated(name, math.prod(mesh.size(i) for i, p in enumerate(pl)
                                             if not isinstance(p, Shard)))
        in_pl.append(pl)
    return local_map(fn, out_placements=first, in_placements=tuple(in_pl), device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def reduce_partial(x):
    """A DTensor with its pending (partial) reductions done, its splits kept."""
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial() else p
                                          for p in x.placements])


def rows_only(x):
    """A DTensor split along its first dim at most (every other split and
    pending reduction resolved)."""
    from torch.distributed.tensor import Replicate, Shard

    return x.redistribute(x.device_mesh, [p if isinstance(p, Shard) and p.dim == 0
                                          else Replicate() for p in x.placements])


def matmul(x, w):
    """``x @ w`` for a DTensor ``x`` of 3 or more dims and a 2-D ``w``, the
    rows multiplied as one 2-D product with every split placed: on each mesh
    dim, ``x``'s batch split (dim 0) is kept and ``w`` gathered (FSDP's
    all-gather); else ``w``'s split is kept, ``x`` split to match where
    ``w`` splits the contraction (a partial sum) and gathered where ``w``
    splits its columns (Megatron's sequence all-gather). Each rank does its
    share."""
    from torch.distributed.tensor import Replicate, Shard

    last = x.dim() - 1
    w_pl = list(w.placements) if _is_dt(w) else [Replicate()] * len(x.placements)
    xp, wp = [], []
    for px, pw in zip(x.placements, w_pl):
        if isinstance(px, Shard) and px.dim == 0:
            xp.append(px)
            wp.append(Replicate())
        elif isinstance(pw, Shard) and pw.dim == 0:
            xp.append(Shard(last))
            wp.append(pw)
        else:
            xp.append(Replicate())
            wp.append(pw if isinstance(pw, Shard) else Replicate())
    x = x.redistribute(x.device_mesh, xp)
    if _is_dt(w):
        w = w.redistribute(w.device_mesh, wp)
    lead = tuple(x.shape[:-1])
    return (x.reshape(-1, x.shape[-1]) @ w).reshape(*lead, w.shape[-1])


def take_rows(table, ids):
    """``table[ids]`` as ``F.embedding`` on the table's rows (trailing dims
    flattened), which DTensor shards for split ids and a row- or column-split
    table; a row-split table's rows come back as a masked partial, reduced
    here once."""
    import torch.nn.functional as F

    trailing = tuple(table.shape[1:])
    flat = table
    if table.dim() != 2:
        # rows_only after the reshape too: its backward brings the gradient to
        # split rows before the reshape's own backward
        flat = rows_only(table).reshape(table.shape[0], -1)
        flat = rows_only(flat) if _is_dt(flat) else flat
    out = F.embedding(ids, flat)
    out = rows_only(out) if _is_dt(out) else out
    return out.reshape(*ids.shape, *trailing)


def segment_sum(values, index, num_rows: int):
    """``zeros((num_rows, ...)).index_add(0, index, values)`` for a DTensor
    ``values``: each rank adds its share of the rows into a whole-size
    buffer, a partial sum over the mesh dims that split the rows, reduce-
    scattered to rows split the same way (DTensor's own ``index_add`` rule
    gathers the index but not the values); ``index`` is laid out as
    ``values``' rows."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    values = rows_only(values)
    mesh, pl = values.device_mesh, list(values.placements)
    idx_pl = [Shard(0) if isinstance(p, Shard) else Replicate() for p in pl]
    out_pl = [Partial() if isinstance(p, Shard) else Replicate() for p in pl]

    def add(v, i):
        out = torch.zeros((num_rows,) + tuple(v.shape[1:]), dtype=v.dtype, device=v.device)
        return out.index_add(0, i, v)

    partial = local_map(add, out_placements=out_pl, in_placements=(pl, idx_pl),
                        device_mesh=mesh, redistribute_inputs=True)(values, index)
    return partial.redistribute(mesh, [Shard(0) if isinstance(p, Partial) else p
                                       for p in partial.placements])


# ---------------------------------------------------------------------------
# the forms, by the function they stand in for
# ---------------------------------------------------------------------------


def _reshape(x, *shape):
    """A split that DTensor's view cannot keep (the dims the reshape merges or
    splits, split unevenly) is gathered first; every other split is kept."""
    from torch.distributed.tensor import Replicate, Shard

    if not _is_dt(x):
        return NotImplemented
    shape = list(shape[0] if len(shape) == 1 and isinstance(shape[0], (tuple, list, torch.Size))
                 else shape)
    if -1 in shape:
        known = math.prod(v for v in shape if v != -1)
        shape[shape.index(-1)] = x.numel() // known if known else 0
    old = list(x.shape)
    lo = 0
    while lo < min(len(old), len(shape)) and old[lo] == shape[lo]:
        lo += 1
    hi = 0
    while hi < min(len(old), len(shape)) - lo and old[-1 - hi] == shape[-1 - hi]:
        hi += 1
    splits: Dict[int, int] = {}
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard):
            splits[p.dim] = splits.get(p.dim, 1) * x.device_mesh.size(i)
    place = [p if not isinstance(p, Shard) or p.dim < lo or p.dim >= len(old) - hi
             or (p.dim == lo and shape[lo] % splits[p.dim] == 0) else Replicate()
             for p in x.placements]
    if place != list(x.placements):
        x = x.redistribute(x.device_mesh, place)
    return _grad_placed_as(x.reshape(shape))


def _grad_placed_as(y):
    """``y``, whose gradient is brought to ``y``'s own placements before it
    flows on (a reshape's backward meets the same limits as its forward)."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(y.to_local(), y.device_mesh, y.placements, run_check=False,
                              shape=y.shape, stride=y.stride())


def _matmul(x, w, *a, **k):
    if a or k or not _is_dt(x) or x.dim() < 3 or w.dim() != 2:
        return NotImplemented
    return matmul(x, w)


def _getitem(table, idx):
    if not (isinstance(idx, torch.Tensor) and not idx.dtype.is_floating_point
            and idx.dtype != torch.bool):
        return NotImplemented
    return take_rows(table, idx)


def _index_select(table, dim, ids):
    if dim != 0:
        return NotImplemented
    return take_rows(table, ids)


def _index_add(self, dim, index, source, *, alpha=1):
    if dim != 0 or alpha != 1 or not _is_dt(source):
        return NotImplemented
    return self + segment_sum(source, index, self.shape[0])


def _gather(inp, dim, index, *a, **k):
    if a or k or not _is_dt(inp) or dim not in (-1, inp.dim() - 1):
        return NotImplemented
    rows = inp.reshape(-1, inp.shape[-1])
    got = reduce_partial(torch.gather(rows, -1, index.reshape(-1, index.shape[-1])))
    return got.reshape(index.shape)


def _flash(q, k, v, **kw):
    """Each rank's batch and heads: the heads take every mesh dim that does
    not split the batch when they divide it (K/V heads repeated to it where
    they are fewer); else the sequence is gathered (the kernel takes no
    causal offset), which replicates the attention over those dims."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.kernels.flash_attention.ops import flash_attention

    def attend(q_, k_, v_):
        return flash_attention(q_, k_, v_, **kw)

    mesh = q.device_mesh
    batch = [isinstance(p, Shard) and p.dim == 0 for p in q.placements]
    m = math.prod(mesh.size(i) for i, b in enumerate(batch) if not b)
    hq, hkv = q.shape[1], k.shape[1]
    if m == 1 or hq % m or (hkv % m and m % hkv):
        return run_local(attend, (q, k, v), ((0,), (0,), (0,)), name="flash_attention")
    heads = [Shard(0) if b else Shard(1) for b in batch]
    if hkv % m:  # fewer K/V heads than ranks: each rank's repeated to its q heads
        whole = [Shard(0) if b else Replicate() for b in batch]
        rep = local_map(lambda t: t.repeat_interleave(m // hkv, dim=1), out_placements=whole,
                        in_placements=(whole,), device_mesh=mesh, redistribute_inputs=True)
        k, v = rep(k), rep(v)
    return local_map(attend, out_placements=heads, in_placements=(heads, heads, heads),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)


def _embedding_bag(table, ids, mode="sum"):
    """Each rank's bags against the gathered table."""
    from repro_torch.kernels.embedding_bag.ops import embedding_bag

    return run_local(lambda i, t: embedding_bag(t, i, mode), (ids, table), ((0,), ()),
                     name="embedding_bag")


def _segment_softmax(scores, dt, dst, valid):
    """On the gathered edges: the layout is the whole batch's."""
    from repro_torch.kernels.segment_softmax.ops import segment_softmax_edges

    return run_local(lambda s, d, v: segment_softmax_edges(s, dt, d, v), (scores, dst, valid),
                     ((), (), ()), name="segment_softmax")


def _rules() -> dict:
    from repro_torch.kernels.embedding_bag.ops import embedding_bag
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.segment_softmax.ops import segment_softmax_edges

    return {
        torch.Tensor.__matmul__: _matmul, torch.Tensor.matmul: _matmul, torch.matmul: _matmul,
        torch.Tensor.reshape: _reshape, torch.reshape: _reshape, torch.Tensor.view: _reshape,
        torch.Tensor.__getitem__: _getitem,
        torch.Tensor.index_select: _index_select, torch.index_select: _index_select,
        torch.Tensor.index_add: _index_add,
        torch.gather: _gather, torch.Tensor.gather: _gather,
        flash_attention: _flash, embedding_bag: _embedding_bag,
        segment_softmax_edges: _segment_softmax,
    }


def _has_dtensor(args, kwargs) -> bool:
    dt = _dtensor_type()
    return any(isinstance(a, dt) for a in args) or any(isinstance(a, dt)
                                                       for a in kwargs.values())


class ShardedForms(TorchFunctionMode):
    """While active, a call with a DTensor operand whose function has a form
    here runs as that form (see the module's docstring)."""

    def __init__(self) -> None:
        super().__init__()
        self.rules = _rules()
        self._saved: list = []

    def __enter__(self):
        from torch.utils.checkpoint import checkpoint

        from repro_torch.models import layers, transformer

        def recompute_contexts():
            return contextlib.nullcontext(), ShardedForms()

        def checkpoint_under_forms(fn, *args, **kwargs):
            return checkpoint(fn, *args, context_fn=recompute_contexts, **kwargs)

        for mod in (transformer, layers):
            self._saved.append((mod, mod.checkpoint))
            mod.checkpoint = checkpoint_under_forms
        return super().__enter__()

    def __exit__(self, *exc):
        while self._saved:
            mod, fn = self._saved.pop()
            mod.checkpoint = fn
        return super().__exit__(*exc)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        rule = self.rules.get(func)
        if rule is not None and _has_dtensor(args, kwargs):
            out = rule(*args, **kwargs)
            if out is not NotImplemented:
                return out
        return func(*args, **kwargs)
