"""GAT on the GraphScale dst-partitioned layout, over ``torch.distributed``.

Counterpart of ``repro.dist.gat_parallel``. Vertices are dst-partitioned over
the ranks with l = 1 (the whole interval fits the scratch pad). Each layer
makes ONE exchange, an all-gather of the projected payload (xp ++ per-head
source attention scores); everything downstream (the attention softmax, the
message aggregation, the loss) is local to the destination's rank, because
every in-edge of a vertex lives in its core's bucket. The softmax runs on
the segment-softmax op (``models.gnn.common.segment_softmax_xla``: the
kernel on the card, one launch a layer a rank).

Numerics match the dense single-device GAT to float32 tolerance;
``wire_dtype`` optionally narrows the exchanged payload (e.g. bf16 wires,
float32 math).

Gradients: the all-gather's backward sums the gradient over the ranks and
keeps this rank's rows; the loss's numerator is summed over the ranks with
an identity backward; the parameters enter through a replication whose
backward sums their gradients over the ranks, so every rank's
``backward()`` leaves the gradient of the global loss on its replica.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as Fn
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.core.distributed import _all_reduce_sum, crossbar_exchange
from repro_torch.models.gnn.common import flat_softmax_tiles, mlp, segment_softmax_xla

__all__ = ["make_gat_graphscale_loss"]


class _SumOverRanks(torch.autograd.Function):
    """A value summed over the ranks; the gradient of each rank's term is
    the sum's own gradient (identity backward)."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Replicated(torch.autograd.Function):
    """Parameters used identically on every rank: identity forward, their
    gradients summed over the ranks backward (one all-reduce for all)."""

    @staticmethod
    def forward(ctx, group, *params):
        ctx.group = group
        return tuple(p.view_as(p) for p in params)

    @staticmethod
    def backward(ctx, *grads):
        flat = torch.cat([g.reshape(-1) for g in grads])
        flat = _all_reduce_sum(flat, ctx.group)
        out, at = [], 0
        for g in grads:
            out.append(flat[at : at + g.numel()].view_as(g))
            at += g.numel()
        return (None, *out)


def _gat_layer_dist(w, a_src, a_dst, x, e_src, e_dst, e_val, tiles, group, final,
                    wire_dtype):
    """One distributed GAT layer on this rank's (Vl, ...) shard. ``e_src``
    indexes the gathered payload, ``e_dst`` the local interval."""
    vl = x.shape[0]
    xp = torch.einsum("nd,dhf->nhf", x, w)  # (Vl, H, hd)
    s_src = (xp * a_src[None]).sum(-1)  # (Vl, H)
    s_dst = (xp * a_dst[None]).sum(-1)
    h, hd = xp.shape[1], xp.shape[2]

    # the layer's ONE exchange: projected rows ++ src attention scores
    payload = torch.cat([xp.reshape(vl, h * hd), s_src], dim=-1)
    if wire_dtype is not None:
        payload = payload.to(wire_dtype)
    gathered = crossbar_exchange(payload, group).to(x.dtype)
    xp_g = gathered[:, : h * hd].reshape(-1, h, hd)  # (V, H, hd) scratch pad
    ssrc_g = gathered[:, h * hd :]  # (V, H)

    e = Fn.leaky_relu(ssrc_g[e_src] + s_dst[e_dst], negative_slope=0.2)  # (E, H)
    # every in-edge of a dst is local -> the softmax needs no second exchange
    att = segment_softmax_xla(e, e_dst, e_val, vl, tiles=tiles)
    msgs = xp_g[e_src] * att[..., None]  # (E, H, hd)
    flat = torch.where(e_val[:, None], msgs.reshape(msgs.shape[0], -1), 0.0)
    out = torch.zeros((vl, h * hd), dtype=flat.dtype, device=flat.device)
    out = out.index_add(0, e_dst, flat).reshape(vl, h, hd)
    if final:
        return out.mean(dim=1)  # average heads (GAT output layer)
    return Fn.elu(out.reshape(vl, -1))  # concat heads


def make_gat_graphscale_loss(
    group,
    vpc: int,
    n_heads: int,
    head_dim: int,
    wire_dtype: Optional[torch.dtype] = None,
    tiles=None,
):
    """Build ``loss(params, feat, sg, dl, vm, labels, lmask) -> scalar``,
    called on every rank with that rank's shard.

    ``params`` is ``gnn.archs.init(GNNConfig(name='gat'), ...)`` (the same on
    every rank); ``feat`` is this rank's (1, Vl, F) or (Vl, F) features
    (``gnn_parallel.shard_features``); ``sg``/``dl``/``vm`` are this core's
    (1, l=1, E_pad) edge arrays of the partition; ``labels``/``lmask`` are
    (Vl,). The masked softmax cross-entropy is summed over the ranks to the
    global mean. Differentiable in ``params``. ``n_heads`` and ``head_dim``
    are the reference's arguments; the shapes come from ``params``.
    ``tiles``: this rank's softmax layout (``flat_softmax_tiles`` of its
    edges), given when it is built ahead (a trace on fake tensors cannot
    read the edges); by default built from the edges at the first call."""
    tiles_of = {}

    def loss_fn(params, feat, sg, dl, vm, labels, lmask):
        x0 = feat[0] if feat.dim() == 3 else feat  # (Vl, F)
        if x0.shape[0] != vpc:
            raise ValueError(f"feature shard has {x0.shape[0]} rows, vpc is {vpc}")
        if sg.shape[1] != 1:
            raise ValueError("GAT layout uses l == 1 (interval fits scratch)")
        e_src, e_dst, e_val = sg[0, 0].long(), dl[0, 0].long(), vm[0, 0]
        if tiles is not None:
            layout = tiles
        else:
            key = (dl.data_ptr(), dl.device)
            if key not in tiles_of:  # the layout of this edge set, built once
                tiles_of[key] = flat_softmax_tiles(e_dst, e_val, vpc)
            layout = tiles_of[key]

        leaves, spec = tree_flatten(params)
        rp = tree_unflatten(list(_Replicated.apply(group, *leaves)), spec)

        x = mlp(rp["encoder"], x0)  # (Vl, H*hd)
        x = _gat_layer_dist(rp["l1_w"], rp["l1_asrc"], rp["l1_adst"], x, e_src, e_dst, e_val,
                            layout, group, final=False, wire_dtype=wire_dtype)
        out = _gat_layer_dist(rp["l2_w"], rp["l2_asrc"], rp["l2_adst"], x, e_src, e_dst,
                              e_val, layout, group, final=True, wire_dtype=wire_dtype)

        lg = out.to(torch.float32)
        lse = torch.logsumexp(lg, dim=-1)
        gold = torch.gather(lg, -1, labels.long()[:, None])[:, 0]
        num = _SumOverRanks.apply(((lse - gold) * lmask).sum(), group)
        den = _all_reduce_sum(lmask.sum().detach(), group)
        return num / torch.clamp(den, min=1.0)

    return loss_fn
