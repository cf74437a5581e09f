"""Embedding lookup as the GraphScale vertex-label crossbar, with table rows
as labels.

Counterpart of ``repro.dist.embedding``. Every shard sends each of its ids
to the shard that owns the row (exchange #1, the request wires), each shard
gathers locally, and the rows travel back (exchange #2, the response wires).
Request queues are ``capacity`` deep per destination shard, like the paper's
crossbar FIFOs: ids past a queue's capacity are DROPPED (zero rows, counted)
rather than serialized. Padding ids (< 0) return zero rows.

The exchange is an argument of ``crossbar_lookup_local``: ``exchange(send)``
takes this shard's (num_shards, capacity, ...) send buffer and returns its
receive buffer, ``recv[s] = send_of_shard_s[me]`` (an all-to-all over the
first axis). ``make_exchange(table_group)`` builds it over
``torch.distributed``: one all-to-all over a process group, or, given a
sequence of groups (the mesh axes the table shards over, outermost first),
the two-level crossbar proper, one all-to-all per level, which composes to
the flat all-to-all over their product. Its backward is the same exchange
(an all-to-all is its own transpose), so gradients reach ``table``. Under
gloo a CUDA buffer goes through the host (``core.distributed``'s
transport rule). With no group (``make_crossbar_lookup()``, all one H100
needs) the exchange is the identity and the lookup a masked take with a
capacity of ceil(2n), so nothing is dropped.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch
import torch.distributed as dist

__all__ = ["crossbar_lookup_local", "make_exchange", "make_crossbar_lookup"]


def crossbar_lookup_local(
    table: torch.Tensor,  # (rows_local, d) THIS shard's table rows
    ids: torch.Tensor,  # (n,) integer global row ids; < 0 = padding
    exchange,  # all-to-all over the shards' first axis (identity at one shard)
    num_shards: int,
    capacity: int,  # request-queue depth per destination shard
) -> tuple[torch.Tensor, torch.Tensor]:
    """One shard's side of the two-level crossbar.

    Returns ``(rows (n, d), dropped)``: row i is the table row for ids[i], or
    zeros when ids[i] is padding or overflowed its shard's request queue;
    ``dropped`` is the int32 count of overflowed (real) ids."""
    dev, d = ids.device, table.shape[1]
    rows_local = table.shape[0]
    ids = ids.long()
    valid = ids >= 0
    shard = torch.where(valid, ids // rows_local, 0)  # owning shard
    local_row = torch.where(valid, ids % rows_local, 0)

    # rank of each id within its destination shard's request queue
    onehot = (shard[:, None] == torch.arange(num_shards, device=dev)[None, :]) & valid[:, None]
    rank = torch.cumsum(onehot.long(), dim=0).gather(1, shard[:, None])[:, 0] - 1
    served = valid & (rank < capacity)
    dropped = (valid & ~served).sum().to(torch.int32)

    # request wires: (num_shards, capacity) local row ids, -1 = empty slot;
    # unserved ids land in one extra slot that is cut off
    slots = num_shards * capacity
    req = torch.full((slots + 1,), -1, dtype=torch.int32, device=dev)
    req.scatter_(0, torch.where(served, shard * capacity + rank, slots), local_row.to(torch.int32))
    recv = exchange(req[:slots].view(num_shards, capacity))

    # local gather + response wires
    rows = table.index_select(0, recv.clamp(min=0).reshape(-1)).view(num_shards, capacity, d)
    zero = torch.zeros((), dtype=table.dtype, device=dev)
    rows = torch.where((recv >= 0)[..., None], rows, zero)
    resp = exchange(rows)

    # resp[s, k] = the row for MY k-th request to shard s
    at = shard * capacity + rank.clamp(0, capacity - 1)
    out = resp.reshape(slots, d).index_select(0, at)
    return torch.where(served[:, None], out, zero), dropped


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    staged = x.device.type == "cuda" and dist.get_backend(group) == "gloo"
    src = x.detach().to("cpu") if staged else x.detach().contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.to(x.device) if staged else out


class _AllToAll(torch.autograd.Function):
    """All-to-all over the first axis; its own transpose, so the backward is
    the same exchange of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_to_all(grad.contiguous(), ctx.group), None


def _as_tuple(groups) -> Tuple:
    return tuple(groups) if isinstance(groups, (list, tuple)) else (groups,)


def make_exchange(table_group):
    """``(exchange, num_shards)`` over ``table_group``: a process group, or a
    sequence of groups, one a mesh axis, outermost first. Shard s of the
    table is the rank whose ranks within the groups are s's digits in the
    mixed radix of the group sizes (row-major). Every rank must send a
    buffer of the same shape."""
    groups = _as_tuple(table_group)
    sizes = tuple(dist.get_world_size(g) for g in groups)

    def exchange(send):
        x = send.reshape(*sizes, *send.shape[1:])
        for k, g in enumerate(groups):  # one all-to-all per crossbar level
            x = x.movedim(k, 0).contiguous()
            x = _AllToAll.apply(x, g) if x.requires_grad else _all_to_all(x, g)
            x = x.movedim(0, k)
        return x.reshape(send.shape)

    return exchange, math.prod(sizes)


def make_crossbar_lookup(table_group: Union[None, object, Sequence] = None,
                         capacity_factor: float = 2.0):
    """Build ``lookup(table, ids) -> rows`` (shape ``ids.shape + (d,)``).

    ``table_group``: None runs the crossbar at one shard over the whole
    ``table``; a group or a sequence of groups (``make_exchange``) shards the
    rows over their ranks, and each rank then passes its own shard of the
    table and its own ids (the same number on every rank; its share of the
    batch, or the whole batch where the batch is not split).
    ``capacity_factor``: request-queue depth as a multiple of the uniform
    per-shard load; ids landing beyond it return zero rows. Differentiable
    in ``table``."""
    if table_group is None:
        exchange, num_shards = (lambda x: x), 1
    else:
        exchange, num_shards = make_exchange(table_group)

    def lookup(table, ids):
        flat = ids.reshape(-1)
        capacity = max(1, math.ceil(flat.shape[0] * capacity_factor / num_shards))
        out, _ = crossbar_lookup_local(table, flat, exchange, num_shards, capacity)
        return out.reshape(*ids.shape, table.shape[-1])

    return lookup
