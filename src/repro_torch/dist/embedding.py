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
first axis). ``make_crossbar_lookup`` runs one shard, all one H100 needs:
the exchange is the identity and the lookup a masked take with a capacity
of ceil(2n), so nothing is dropped. An exchange over ``torch.distributed``
comes with the multi-card engine.
"""
from __future__ import annotations

import math

import torch

__all__ = ["crossbar_lookup_local", "make_crossbar_lookup"]


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


def make_crossbar_lookup(capacity_factor: float = 2.0):
    """Build ``lookup(table, ids) -> rows`` (shape ``ids.shape + (d,)``)
    running the crossbar at one shard over the whole ``table``.

    ``capacity_factor``: request-queue depth as a multiple of the uniform
    per-shard load; ids landing beyond it return zero rows."""

    def lookup(table, ids):
        flat = ids.reshape(-1)
        capacity = max(1, math.ceil(flat.shape[0] * capacity_factor))
        out, _ = crossbar_lookup_local(table, flat, lambda x: x, 1, capacity)
        return out.reshape(*ids.shape, table.shape[-1])

    return lookup
