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
    whole-size buffer, reduce-scattered (``segment_sum``). The port's
    fixed-order ``kernels.segment_sum.segment_sum`` and ``take`` (the
    torch-function protocol) run as the ``index_add`` and the row take they
    stand in for, so a dry run's counts are those forms'.
  * ``gather`` along the last dim: on 2-D rows, the masked partial reduced.
  * ``reshape``, ``view``: a split of a dim the reshape merges or splits
    that DTensor's view cannot keep (uneven: K/V heads fewer than the
    ranks) is gathered first, in the forward and in the backward.
  * ``expand`` of a replicated dim of size 1 to a size the ranks divide
    (DIN retrieval's one user against every candidate): split over every
    mesh dim as it is made (``_expand``).
  * the kernels (their entry points take the torch-function protocol):
    ``local_map`` over each rank's local tensors, with the splits each
    kernel's math allows kept (``run_local``).
  * the MoE dispatch (``moe_ffn_grouped``, ``moe_ffn``; the torch-function
    protocol): placed as ``expert_sharding`` says (``moe_dispatch``).
    Grouped, one dispatch group a data shard: the router product on each
    rank's share of the router's columns, the logits and the group's tokens
    gathered over the expert dims, the slots routed once a group, each rank
    running only its experts' (1, E/tp, C, d) slots; the outputs a partial
    sum over the expert dims, which the next constraint reduce-scatters.
    Ungrouped (a token count the groups do not divide): the same on all
    tokens, repeated on every rank of the other dims (``moe_experts``).
  * ``softmax_xent``, ``masked_softmax_xent`` (the torch-function
    protocol): the vocab-parallel cross-entropy (``vocab_parallel_rows``);
    the logits never gathered, the rows kept split.
  * ``decode_gqa_attention``: as written (DTensor splits it as the cache is
    split), its work recorded as repeated on the mesh dims that split no
    dim of the cache (``decode_attention``; a batch that does not divide).

``torch.autograd.grad`` runs its engine with every torch-function mode off,
so a checkpointed block's recompute would miss the forms: while the mode is
held (``with ShardedForms():``) the models' ``checkpoint`` calls get a
``context_fn`` that holds it over the recompute too.

Where the operand that sets a kernel's work is not split over a mesh dim
(gathered by the form, or too small to split), every rank of that dim does
the same work: the form says so to every active ``Replicated`` recorder, and
the dry run writes it into the cell's record. The forms that repeat aten
work (the MoE and decode-attention forms) also charge the FLOPs the dry
run's counter sees while they run to their name (``replicated_work``,
``note_flops``), so a record splits a rank's FLOPs into what is split and
what is repeated.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List

import torch
from torch.overrides import TorchFunctionMode

__all__ = ["ShardedForms", "Replicated", "run_local", "matmul", "take_rows",
           "segment_sum", "rows_only", "reduce_partial", "moe_dispatch",
           "vocab_parallel_rows", "vocab_parallel_xent", "replicated_work", "note_flops"]

_ACTIVE: List["Replicated"] = []
_WORK: List[str] = []  # the replicating forms running now, innermost last


class Replicated:
    """Collects, while active, the kernels whose work a form replicated:
    ``factors`` ``{name: factor}``, the factor the largest seen (the number
    of ranks that do the same work), and ``flops`` ``{name: FLOPs}``, the
    aten FLOPs counted while a form of that name ran (``replicated_work``)."""

    def __init__(self) -> None:
        self.factors: Dict[str, int] = {}
        self.flops: Dict[str, int] = {}

    def __enter__(self) -> "Replicated":
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE.remove(self)


def _note_replicated(name: str, factor: int) -> None:
    if factor > 1:
        for rec in _ACTIVE:
            rec.factors[name] = max(rec.factors.get(name, 1), factor)


@contextlib.contextmanager
def replicated_work(name: str, factor: int):
    """Record ``name`` as work ``factor`` ranks repeat, and charge to it the
    FLOPs counted while the block runs (``note_flops``)."""
    _note_replicated(name, factor)
    if factor <= 1:
        yield
        return
    _WORK.append(name)
    try:
        yield
    finally:
        _WORK.pop()


def note_flops(n: int) -> None:
    """Charge ``n`` FLOPs of one op to the replicating form running now, if
    any (the dry run's counter calls it for every op it counts)."""
    if _WORK and n:
        for rec in _ACTIVE:
            rec.flops[_WORK[-1]] = rec.flops.get(_WORK[-1], 0) + n


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
    here once; the table's columns are gathered over the mesh dims that split
    the ids."""
    import torch.nn.functional as F

    from torch.distributed.tensor import Replicate, Shard

    trailing = tuple(table.shape[1:])
    flat = table
    if table.dim() != 2:
        # rows_only after the reshape too: its backward brings the gradient to
        # split rows before the reshape's own backward
        flat = rows_only(table).reshape(table.shape[0], -1)
        flat = rows_only(flat) if _is_dt(flat) else flat
    if _is_dt(flat) and _is_dt(ids):
        # a column split on a mesh dim that splits the ids is gathered (FSDP's
        # weight all-gather): else DTensor gathers the ids, the cheaper move
        # for this op, and the rows come out whole on every rank of that dim
        flat = flat.redistribute(flat.device_mesh, [
            Replicate() if isinstance(pt, Shard) and pt.dim == 1 and isinstance(pi, Shard)
            else pt for pt, pi in zip(flat.placements, ids.placements)])
        gathered = _take_gathered(flat, ids)
        if gathered is not None:
            return gathered.reshape(*ids.shape, *trailing)
    out = F.embedding(ids, flat)
    out = rows_only(out) if _is_dt(out) else out
    return out.reshape(*ids.shape, *trailing)


def _collective(op: str, x, group, *args):
    """A ``_c10d_functional`` collective of ``x`` over ``group``, waited: the
    ops themselves, whose names both torch releases the port meets share
    (the Python wrappers moved and may hold the result in an async
    wrapper)."""
    ns = torch.ops._c10d_functional
    name = group.group_name
    if op == "all_reduce":
        out = ns.all_reduce(x, *args, name)
    else:
        out = getattr(ns, op)(x.contiguous(), *args, group.size(), name)
    return torch.ops._c10d_functional.wait_tensor(out)


def _free(t) -> None:
    """Release a whole-size buffer this module made once it is used, as FSDP
    releases an all-gathered parameter: its storage emptied, whatever still
    refers to it (a trace's tensors sit in reference cycles until the next
    collection, and so held a gathered table beside the next layer's sums)."""
    t.untyped_storage().resize_(0)


class _GatheredTake(torch.autograd.Function):
    """``F.embedding(ids, all-gather of the row shards over group)`` keeping
    only the ids for the backward: the gradient, a whole-size partial sum of
    the rows, is reduce-scattered back to this rank's shard."""

    @staticmethod
    def forward(ctx, tab, ids, group):
        import torch.nn.functional as F

        ctx.save_for_backward(ids)
        ctx.rows, ctx.group = tab.shape[0], group
        whole = _collective("all_gather_into_tensor", tab, group)
        out = F.embedding(ids, whole)
        _free(whole)
        return out

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        (ids,) = ctx.saved_tensors
        whole = torch.ops.aten.embedding_dense_backward(
            g, ids, ctx.rows * dist.get_world_size(ctx.group), -1, False)
        mine = _collective("reduce_scatter_tensor", whole, ctx.group, "sum")
        _free(whole)
        return mine, None, None


class _TakeGatheredIds(torch.autograd.Function):
    """The same take with the ids gathered instead: each rank takes every id
    that falls in its rows (``row0`` on), the rows a partial sum reduce-
    scattered to each rank's own ids; the gradient all-gathered and added
    into this rank's rows."""

    @staticmethod
    def forward(ctx, tab, ids, group, row0):
        import torch.nn.functional as F

        every = _collective("all_gather_into_tensor", ids.reshape(-1), group)
        local = every.long() - row0
        _free(every)
        mine = (local >= 0) & (local < tab.shape[0])
        local = local.clamp(0, tab.shape[0] - 1)
        rows = torch.where(mine[:, None], F.embedding(local, tab), 0)
        ctx.save_for_backward(local, mine)
        ctx.rows, ctx.group = tab.shape[0], group
        out = _collective("reduce_scatter_tensor", rows, group, "sum")
        _free(rows)
        return out.reshape(*ids.shape, tab.shape[1])

    @staticmethod
    def backward(ctx, g):
        local, mine = ctx.saved_tensors
        every = _collective("all_gather_into_tensor", g.reshape(-1, g.shape[-1]), ctx.group)
        whole = torch.where(mine[:, None], every, 0)
        _free(every)
        grad = torch.ops.aten.embedding_dense_backward(whole, local, ctx.rows, -1, False)
        _free(whole)
        return grad, None, None, None


def _take_gathered(flat, ids):
    """``F.embedding(ids, flat)`` where every mesh dim that splits the
    table's rows also splits the ids (a graph's node rows taken by its
    edges, candidates' rows of an item table), each collective over those
    dims at once: the rows gathered and each rank taking its own ids, the
    gradient reduce-scattered back (``_GatheredTake``), or, when the ids are
    fewer than the rows, the ids gathered, each rank taking those in its
    rows, the rows reduce-scattered (``_TakeGatheredIds``); either keeps one
    whole-size buffer of the smaller kind. DTensor's own embedding rule goes
    one mesh dim at a time in the backward and keeps whole-size and
    half-size buffers on three dims. None where the placements are not of
    that kind."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = flat.device_mesh
    if any(isinstance(p, Shard) and p.dim != 0 for p in flat.placements) or \
            any(p.is_partial() for p in ids.placements):
        return None
    dims = [i for i, p in enumerate(flat.placements) if isinstance(p, Shard)]
    ranks = math.prod(mesh.size(i) for i in dims) if dims else 1
    if not dims or any(ids.placements[i] != Shard(0) for i in dims) or \
            flat.shape[0] % ranks or ids.shape[0] % ranks:
        return None
    group = _flat_group(mesh, dims)
    tab_grad = [p if i in dims else Partial() if isinstance(ids.placements[i], Shard)
                else Replicate() for i, p in enumerate(flat.placements)]
    if flat.shape[0] <= ids.numel():
        def take(tab, i):
            return _GatheredTake.apply(tab, i, group)
    else:
        row0 = _shard_offset(flat.shape[0], mesh, dims)

        def take(tab, i):
            return _TakeGatheredIds.apply(tab, i, group, row0)

    return local_map(take, out_placements=list(ids.placements),
                     in_placements=(list(flat.placements), list(ids.placements)),
                     in_grad_placements=(tab_grad, list(ids.placements)), device_mesh=mesh,
                     redistribute_inputs=True)(flat, ids)


def _flat_group(mesh, dims):
    """The process group of the mesh dims ``dims`` taken as one, ranks in
    mesh order (outer first, as DTensor chunks a dim split over several).
    Made with every mode off: the mesh's own bookkeeping runs tensor ops."""
    from torch.utils._python_dispatch import _disable_current_modes

    if len(dims) == 1:
        return mesh.get_group(dims[0])
    with _disable_current_modes():
        sub = mesh[tuple(mesh.mesh_dim_names[i] for i in dims)]
        return sub._flatten().get_group(0)


class _ReduceScatter(torch.autograd.Function):
    """A reduce-scatter SUM over ``group`` whose backward all-gathers the
    gradient; it keeps nothing for the backward (the whole-size partial sum
    it reduces dies here, not with the step's graph)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = _collective("reduce_scatter_tensor", x, group, "sum")
        _free(x)
        return out

    @staticmethod
    def backward(ctx, g):
        return _collective("all_gather_into_tensor", g, ctx.group), None


def segment_sum(values, index, num_rows: int):
    """``zeros((num_rows, ...)).index_add(0, index, values)`` for a DTensor
    ``values``: each rank adds its share of the rows into a whole-size
    buffer, a partial sum over the mesh dims that split the rows, reduce-
    scattered in one collective over those dims taken together (DTensor's
    own redistribute goes one mesh dim at a time, and on three dims keeps a
    half-size buffer between the first two steps) to rows split the same
    way (DTensor's own ``index_add`` rule gathers the index but not the
    values); ``index`` is laid out as ``values``' rows."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    values = rows_only(values)
    mesh, pl = values.device_mesh, list(values.placements)
    split = [i for i, p in enumerate(pl) if isinstance(p, Shard)]
    idx_pl = [Shard(0) if isinstance(p, Shard) else Replicate() for p in pl]
    whole = bool(split) and num_rows % math.prod(mesh.size(i) for i in split) == 0
    group = _flat_group(mesh, split) if whole else None

    def add(v, i):
        out = torch.zeros((num_rows,) + tuple(v.shape[1:]), dtype=v.dtype, device=v.device)
        out.index_add_(0, i, v)
        return out if group is None else _ReduceScatter.apply(out, group)

    if whole:
        return local_map(add, out_placements=idx_pl, in_placements=(pl, idx_pl),
                         device_mesh=mesh, redistribute_inputs=True)(values, index)
    out_pl = [Partial() if isinstance(p, Shard) else Replicate() for p in pl]
    partial = local_map(add, out_placements=out_pl, in_placements=(pl, idx_pl),
                        device_mesh=mesh, redistribute_inputs=True)(values, index)
    return partial.redistribute(mesh, [Shard(0) if isinstance(p, Partial) else p
                                       for p in partial.placements])


def _shard_offset(size: int, mesh, dims) -> int:
    """The first index this rank holds of a dim of ``size`` split evenly over
    the mesh dims ``dims`` (outer first, as DTensor chunks)."""
    coord = mesh.get_coordinate()
    idx = 0
    for i in sorted(dims):
        idx = idx * mesh.size(i) + coord[i]
    return idx * (size // math.prod(mesh.size(i) for i in dims))


def moe_dispatch(x, router_w, w1, w3, w2, cfg, capacity: int, expert_sharding,
                 groups: int = 1):
    """The MoE FFN on a DTensor ``x`` (T, d), placed by ``expert_sharding``:
    the (G, E, C, d) buffers' ``(mesh, placements)`` when ``groups`` > 1
    (the mesh dims splitting G hold one dispatch group a rank, those
    splitting E its experts), else the (E, C, d) buffers'. Returns (out (T,
    d): rows split over the group dims, a partial sum over the expert dims;
    aux, a partial sum). The slots are the plain dispatch's
    (``models.layers.route_logits`` on the group's tokens, the same
    capacity); FLOPs split over the group and expert dims, and the mesh dims
    that split neither repeat the router product and the dispatch
    (``Replicated``: ``moe_experts``)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.models.layers import _mm, combine_experts, route_logits

    mesh, place = expert_sharding
    ndim = mesh.ndim
    gdims = {i for i, p in enumerate(place)
             if groups > 1 and isinstance(p, Shard) and p.dim == 0}
    edims = {i for i, p in enumerate(place)
             if isinstance(p, Shard) and p.dim == (1 if groups > 1 else 0)}
    n_expert_ranks = math.prod(mesh.size(i) for i in edims)
    repeat = math.prod(mesh.size(i) for i in range(ndim) if i not in gdims | edims)

    def placed(on_g, on_e, other=Replicate):
        return [on_g() if i in gdims else on_e() if i in edims else other()
                for i in range(ndim)]

    rows = placed(lambda: Shard(0), Replicate)
    w_pl = placed(Replicate, lambda: Shard(0))
    e0 = _shard_offset(cfg.num_experts, mesh, edims)
    with replicated_work("moe_experts", repeat):
        x = x.redistribute(mesh, rows)  # the group's tokens
        router_w = router_w.redistribute(mesh, placed(Replicate, lambda: Shard(1)))
        # the router product on this rank's columns, the logits gathered
        logits = _mm(x, router_w).to(torch.float32).redistribute(mesh, rows)

        def dispatch(xl, lg, a, b, c):
            tok, gate, me, ce = route_logits(lg, cfg, capacity, xl.dtype)
            mine = slice(e0 * capacity, (e0 + a.shape[0]) * capacity)
            out = combine_experts(xl, tok[mine], gate[mine], a, b, c, capacity)
            aux = cfg.router_aux_weight * cfg.num_experts * torch.sum(me * ce)
            return out, aux / (groups * n_expert_ranks)

        partial_e = placed(lambda: Shard(0), Partial)
        w_grad = placed(Partial, lambda: Shard(0))
        return local_map(
            dispatch, out_placements=(partial_e, placed(Partial, Partial)),
            in_placements=(rows, rows, w_pl, w_pl, w_pl),
            in_grad_placements=(partial_e, partial_e, w_grad, w_grad, w_grad),
            device_mesh=mesh, redistribute_inputs=True)(x, logits, w1, w3, w2)


class _SumAcross(torch.autograd.Function):
    """An all-reduce SUM over ``group`` whose result every rank uses as its
    own: the gradient passes through (each rank differentiates only its own
    terms)."""

    @staticmethod
    def forward(ctx, x, group):
        return _collective("all_reduce", x, group, "sum")

    @staticmethod
    def backward(ctx, g):
        return g, None


def vocab_parallel_rows(logits, labels):
    """The per-row cross-entropy of DTensor logits (..., V) whose vocab (or
    class) dim may be split: each rank takes its shard's row max,
    all-reduced MAX, its sum of exponentials, all-reduced SUM, and the gold
    logit where its shard holds the label (a masked local take, all-reduced
    SUM). The rows keep their split; the logits are never gathered, in the
    forward or the backward."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    logits = reduce_partial(logits)
    mesh, last = logits.device_mesh, logits.dim() - 1
    vdims = [i for i, p in enumerate(logits.placements) if isinstance(p, Shard) and p.dim == last]
    rows = [p if isinstance(p, Shard) and p.dim < last else Replicate()
            for p in logits.placements]
    lg_pl = [Shard(last) if i in vdims else p for i, p in enumerate(rows)]
    groups = [mesh.get_group(i) for i in vdims]
    v0 = _shard_offset(logits.shape[-1], mesh, vdims)

    def xent(lg, lab):
        lg = lg.to(torch.float32)
        m = lg.amax(dim=-1).detach()
        for g in groups:
            m = _collective("all_reduce", m, g, "max")
        s = torch.exp(lg - m[..., None]).sum(dim=-1)
        idx = lab.long() - v0
        mine = (idx >= 0) & (idx < lg.shape[-1])
        gold = torch.gather(lg, -1, idx.clamp(0, lg.shape[-1] - 1)[..., None])[..., 0]
        gold = torch.where(mine, gold, torch.zeros_like(gold))
        for g in groups:
            s, gold = _SumAcross.apply(s, g), _SumAcross.apply(gold, g)
        return m + torch.log(s) - gold

    return local_map(xent, out_placements=rows, in_placements=(lg_pl, rows), device_mesh=mesh,
                     redistribute_inputs=True)(logits, labels)


def vocab_parallel_xent(logits, labels):
    """``losses.softmax_xent`` on DTensor logits: the mean of
    ``vocab_parallel_rows``, a partial sum over the mesh dims that split the
    rows."""
    return vocab_parallel_rows(logits, labels).mean()


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


def _expand(x, *sizes):
    """A replicated DTensor broadcast along one dim of size 1 to a size the
    ranks divide: each rank's share of the broadcast, split over every mesh
    dim (a view, nothing moves). Replicated, its consumers would split it
    one mesh dim at a time, each step copying a chunk of the broadcast."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not _is_dt(x) or any(not isinstance(p, Replicate) for p in x.placements):
        return NotImplemented
    sizes = list(sizes[0] if len(sizes) == 1 and isinstance(sizes[0], (tuple, list, torch.Size))
                 else sizes)
    if len(sizes) != x.dim():
        return NotImplemented
    grown = [i for i, (old, new) in enumerate(zip(x.shape, sizes)) if new not in (-1, old)]
    mesh = x.device_mesh
    if len(grown) != 1 or x.shape[grown[0]] != 1 or sizes[grown[0]] % mesh.size():
        return NotImplemented
    d = grown[0]
    local = list(x.shape)
    local[d] = sizes[d] // mesh.size()
    # each rank's gradient sums its share of the broadcast: a partial sum
    out = x.to_local(grad_placements=[Partial()] * mesh.ndim).expand(local)
    glob = list(x.shape)
    glob[d] = sizes[d]
    return DTensor.from_local(out, mesh, [Shard(d)] * mesh.ndim, run_check=False,
                              shape=torch.Size(glob), stride=out.stride())


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
    """A plain base (the models' ``zeros``, the same on every rank) is added
    as this rank's rows of it: DTensor would split a replicated operand one
    mesh dim at a time, copying a chunk of it at each step."""
    from torch.distributed.tensor import DTensor, Shard

    if dim != 0 or alpha != 1 or not _is_dt(source):
        return NotImplemented
    summed = segment_sum(source, index, self.shape[0])
    mesh = summed.device_mesh
    dims = [i for i, p in enumerate(summed.placements) if p == Shard(0)]
    ranks = math.prod(mesh.size(i) for i in dims)
    if not _is_dt(self) and dims and self.shape[0] % ranks == 0 and \
            all(i in dims or not p.is_shard() and not p.is_partial()
                for i, p in enumerate(summed.placements)):
        n = self.shape[0] // ranks
        r0 = _shard_offset(self.shape[0], mesh, dims)
        self = DTensor.from_local(self[r0:r0 + n], mesh, summed.placements, run_check=False,
                                  shape=self.shape, stride=self.stride())
    return self + summed


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


def _segment_sum(x, seg, num_segments, layout=None):
    """As ``zeros.index_add(0, seg, x)``, under the forms (``_index_add``)."""
    if not _is_dt(x):
        return NotImplemented
    with ShardedForms():
        zeros = torch.zeros((num_segments,) + tuple(x.shape[1:]), dtype=x.dtype,
                            device=x.device)
        return zeros.index_add(0, seg, x)


def _take(table, ids, layout=None):
    """As ``table[ids]`` (``take_rows``)."""
    if not (_is_dt(table) or _is_dt(ids)):
        return NotImplemented
    return take_rows(table, ids)


def _segment_softmax(scores, dt, dst, valid, layout=None):
    """On the gathered edges: the layouts are the whole batch's."""
    from repro_torch.kernels.segment_softmax.ops import segment_softmax_edges

    return run_local(lambda s, d, v: segment_softmax_edges(s, dt, d, v, layout),
                     (scores, dst, valid),
                     ((), (), ()), name="segment_softmax")


def _moe_grouped(x, router_w, w1, w3, w2, cfg, capacity, groups, expert_sharding=None):
    from torch.distributed.tensor import Shard

    if expert_sharding is None or not _is_dt(x):
        return NotImplemented
    mesh, place = expert_sharding
    split = math.prod(mesh.size(i) for i, p in enumerate(place) if p == Shard(0))
    if split != groups:  # one group a rank of the dims that split G, or no form
        return NotImplemented
    return moe_dispatch(x, router_w, w1, w3, w2, cfg, capacity, expert_sharding, groups)


def _moe(x, router_w, w1, w3, w2, cfg, capacity, expert_sharding=None):
    if expert_sharding is None or not _is_dt(x):
        return NotImplemented
    return moe_dispatch(x, router_w, w1, w3, w2, cfg, capacity, expert_sharding)


def _softmax_xent(logits, labels):
    if not _is_dt(logits):
        return NotImplemented
    return vocab_parallel_xent(logits, labels)


def _masked_softmax_xent(logits, labels, mask):
    if not _is_dt(logits):
        return NotImplemented
    per = vocab_parallel_rows(logits, labels) * mask
    return per.sum() / torch.clamp(mask.sum(), min=1.0)


def _decode_attention(q, k_cache, v_cache, length_mask, scale=None):
    """As written, the forms held over it; the mesh dims that split no dim of
    the cache repeat its work."""
    from torch.distributed.tensor import Shard

    from repro_torch.models.layers import _decode_gqa_attention

    if not _is_dt(k_cache):
        return NotImplemented
    mesh = k_cache.device_mesh
    repeat = math.prod(mesh.size(i) for i, p in enumerate(k_cache.placements)
                       if not isinstance(p, Shard))
    with replicated_work("decode_attention", repeat), ShardedForms():
        return _decode_gqa_attention(q, k_cache, v_cache, length_mask, scale)


def _rules() -> dict:
    from repro_torch.kernels.embedding_bag.ops import embedding_bag
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.segment_softmax.ops import segment_softmax_edges
    from repro_torch.kernels.segment_sum import segment_sum, take
    from repro_torch.models.layers import decode_gqa_attention, moe_ffn, moe_ffn_grouped
    from repro_torch.train.losses import masked_softmax_xent, softmax_xent

    return {
        torch.Tensor.__matmul__: _matmul, torch.Tensor.matmul: _matmul, torch.matmul: _matmul,
        torch.Tensor.reshape: _reshape, torch.reshape: _reshape, torch.Tensor.view: _reshape,
        torch.Tensor.__getitem__: _getitem, torch.Tensor.expand: _expand,
        torch.Tensor.index_select: _index_select, torch.index_select: _index_select,
        torch.Tensor.index_add: _index_add,
        torch.gather: _gather, torch.Tensor.gather: _gather,
        flash_attention: _flash, embedding_bag: _embedding_bag,
        segment_softmax_edges: _segment_softmax, segment_sum: _segment_sum, take: _take,
        moe_ffn_grouped: _moe_grouped, moe_ffn: _moe, softmax_xent: _softmax_xent,
        masked_softmax_xent: _masked_softmax_xent,
        decode_gqa_attention: _decode_attention,
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
