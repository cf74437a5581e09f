"""Wrapper: lay per-edge scores into a static tile layout, run the segment
softmax there, and bring the weights back to edge order.

Counterpart of ``repro.kernels.segment_softmax.ops``. The layout comes from
``prepare_tiles`` (host numpy); ``device_tiles`` puts what the op reads on
the scores' device once. ``segment_softmax_edges`` is GAT's differentiable
form: (E, H) scores, the kernel (or, on the CPU, its plain version) forward,
and torch ops backward, ``ds = w * (g - segsum(w * g)[dst])`` (the reference
trains through the jnp form and has no backward kernel), its ``segsum`` the
port's fixed-order segment sum (``kernels.segment_sum``) over the caller's
destination layout (a GNN batch's ``edge_layout``), so the backward has the
same bits on every run.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch
from torch.overrides import handle_torch_function, has_torch_function

from repro_torch.kernels.csr_gather_reduce.ops import TileLayout, prepare_tiles
from repro_torch.kernels.segment_softmax import kernel
from repro_torch.kernels.segment_softmax.ref import segment_softmax_reference
from repro_torch.kernels.segment_sum import SegmentLayout, segment_sum

__all__ = ["EdgeTiles", "DeviceTiles", "build_edge_tiles", "device_tiles",
           "segment_softmax_tiled", "segment_softmax", "segment_softmax_edges"]


@dataclasses.dataclass(frozen=True)
class EdgeTiles:
    """A softmax layout over edges in any order: ``tiles.gather_idx`` holds
    original edge ids (the dst sort composed in)."""

    tiles: TileLayout
    build_seconds: float

    @property
    def padding_share(self) -> float:
        return self.tiles.tile_padding_ratio


@dataclasses.dataclass(frozen=True)
class DeviceTiles:
    """What the op reads, on one device: slot -> edge id (0 on padding), the
    row in block and validity of every slot, and the (slot, edge) pairs of
    the valid slots, which carry the weights back to edge order."""

    gather_idx: torch.Tensor  # (R*T*Eb,) int64
    dstb: torch.Tensor  # (R, T, Eb) int32
    valid: torch.Tensor  # (R, T, Eb) bool
    live_slot: torch.Tensor  # (n,) int64
    live_edge: torch.Tensor  # (n,) int64
    vb: int

    @property
    def device(self) -> torch.device:
        return self.dstb.device


def build_edge_tiles(dst: np.ndarray, valid: np.ndarray, num_nodes: int, *, vb: int,
                     eb: int) -> EdgeTiles:
    """Tile edges given in any order: sort by destination (stable), bin with
    ``prepare_tiles`` over ``num_nodes`` rows rounded up to ``vb`` with
    degree-aware row packing and no row split, and compose the sort into
    ``gather_idx``."""
    t0 = time.perf_counter()
    dst = np.asarray(dst)
    order = np.argsort(dst, kind="stable")
    num_rows = -(-max(num_nodes, 1) // vb) * vb
    t = prepare_tiles(np.zeros(dst.shape[0], np.int32), dst[order], np.asarray(valid)[order],
                      num_rows=num_rows, vb=vb, eb=eb, balance_rows=True,
                      split_threshold=None)
    t = dataclasses.replace(t, gather_idx=np.where(t.valid, order[t.gather_idx], 0))
    return EdgeTiles(tiles=t, build_seconds=time.perf_counter() - t0)


def device_tiles(tiles, device) -> DeviceTiles:
    """A ``TileLayout`` (its gather_idx into the caller's edge order) or an
    ``EdgeTiles`` on ``device``."""
    if isinstance(tiles, EdgeTiles):
        tiles = tiles.tiles
    assert tiles.gather_idx is not None
    gidx = np.asarray(tiles.gather_idx).reshape(-1).astype(np.int64)
    valid = np.asarray(tiles.valid)
    live = np.nonzero(valid.reshape(-1))[0]
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return DeviceTiles(
        gather_idx=on(gidx), dstb=on(np.asarray(tiles.dstb, np.int32)), valid=on(valid),
        live_slot=on(live.astype(np.int64)), live_edge=on(gidx[live]), vb=tiles.vb,
    )


def segment_softmax_tiled(scores: torch.Tensor, dt: DeviceTiles) -> torch.Tensor:
    """(E,) or (E, H) scores in edge order -> weights in tile order, (R, T,
    Eb) or (H, R, T, Eb)."""
    shape = dt.dstb.shape
    s = scores.float()
    if s.shape[0] == 0:  # padding slots read edge 0: give them one
        s = s.new_zeros((1,) + tuple(s.shape[1:]))
    if s.dim() == 1:
        tiled = s[dt.gather_idx].view(shape)
    else:
        tiled = s.t()[:, dt.gather_idx].reshape(s.shape[1], *shape)
    return kernel.segment_softmax_tiles(tiled, dt.dstb, dt.valid, vb=dt.vb)


def _to_edges(w_tiled: torch.Tensor, dt: DeviceTiles, num_edges: int) -> torch.Tensor:
    """Weights in tile order -> edge order (E[, H]); edges in no slot get 0."""
    if w_tiled.dim() == 3:
        out = torch.zeros(num_edges, dtype=w_tiled.dtype, device=w_tiled.device)
        out[dt.live_edge] = w_tiled.reshape(-1)[dt.live_slot]
        return out
    h = w_tiled.shape[0]
    out = torch.zeros(num_edges, h, dtype=w_tiled.dtype, device=w_tiled.device)
    out[dt.live_edge] = w_tiled.reshape(h, -1)[:, dt.live_slot].t()
    return out


def segment_softmax(
    scores: torch.Tensor,  # (E,) or (E, H)
    dst: torch.Tensor,  # (E,)
    valid: torch.Tensor,  # (E,) bool
    num_rows: int,
    *,
    tiles=None,  # TileLayout | EdgeTiles | DeviceTiles
    use_reference: bool = False,
) -> torch.Tensor:
    """Per-segment softmax in edge order. ``use_reference`` runs the plain
    segment form (per head); else the tiled op over ``tiles``."""
    if use_reference:
        if scores.dim() == 1:
            return segment_softmax_reference(scores, dst, valid, num_rows)
        return torch.stack([segment_softmax_reference(scores[:, i], dst, valid, num_rows)
                            for i in range(scores.shape[1])], dim=1)
    if tiles is None:
        raise ValueError("the tiled op needs a tile layout (prepare_tiles)")
    dt = tiles if isinstance(tiles, DeviceTiles) else device_tiles(tiles, scores.device)
    return _to_edges(segment_softmax_tiled(scores, dt), dt, scores.shape[0])


class _EdgeSoftmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, scores, dt, dst, valid, layout):
        w = _to_edges(segment_softmax_tiled(scores, dt), dt, scores.shape[0])
        ctx.save_for_backward(w, dst)
        ctx.layout = layout
        ctx.num_rows = layout.num_segments if layout is not None \
            else int(dt.dstb.shape[0]) * dt.vb
        return w

    @staticmethod
    def backward(ctx, g):
        w, dst = ctx.saved_tensors
        idx = dst.long()
        wg = w * g  # 0 on masked edges
        seg = segment_sum(wg, idx, ctx.num_rows, ctx.layout)
        return w * (g - seg[idx]), None, None, None, None


def segment_softmax_edges(scores: torch.Tensor, dt: DeviceTiles, dst: torch.Tensor,
                          valid: torch.Tensor,
                          layout: Optional[SegmentLayout] = None) -> torch.Tensor:
    """GAT's edge softmax: (E[, H]) float32 scores -> weights, differentiable
    in ``scores``. ``dst`` and ``valid`` are the edges' rows and mask, as
    ``dt`` was built from; ``layout``: the segment-sum layout of ``dst``
    (``segment_layout``) the backward adds in, built there when None. Takes
    the torch-function protocol (a dry run's ``launch.sharded.ShardedForms``)."""
    if has_torch_function((scores, dst, valid)):
        return handle_torch_function(segment_softmax_edges, (scores, dst, valid), scores, dt,
                                     dst, valid, layout=layout)
    return _EdgeSoftmax.apply(scores, dt, dst, valid, layout)
