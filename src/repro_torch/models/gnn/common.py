"""Shared GNN substrate: static-shape graph batches, segment message passing,
MLP helpers.

Counterpart of ``repro.models.gnn.common``. Message passing is a take plus a
segment reduce over an edge index, the same gather/scatter substrate as the
graph engine: sums through the port's fixed-order segment sum
(``kernels.segment_sum``: the hand-written Hopper kernel on the card, its
plain version on the CPU, the same bits on every run) over a destination
layout kept on the batch (``edge_layout``), max through ``scatter_reduce``;
the takes of node rows by edge (``edge_take``) through the port's take, whose
gradient is that sum over the source or destination layout. GAT's edge softmax
(``segment_softmax``) runs on the port's segment-softmax op: the hand-written
Hopper kernel on the card, its plain version on the CPU, over a tile layout
built once per batch on the host. ``segment_softmax_xla`` is the same op
for flat (dst-sorted, valid) edge arrays, the reference's function of that
name (the distributed GAT layer's softmax).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

__all__ = ["GraphBatch", "aggregate", "edge_layout", "edge_take", "init_mlp", "mlp",
           "segment_softmax", "softmax_tiles", "flat_softmax_tiles", "segment_softmax_xla"]


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    """Padded static-shape (batched) graph of tensors.

    For batched small graphs (TU/molecule), ``graph_id`` maps nodes to their
    graph; single-graph tasks use graph_id == 0. Padding nodes/edges are
    masked. ``edge_dist`` carries precomputed pairwise distances (SchNet).
    GAT's softmax tile layout and the destination layout of the segment sums
    are built on first use and kept on the batch (``softmax_tiles``,
    ``edge_layout``).
    """

    node_feat: torch.Tensor  # (N, F)
    edge_src: torch.Tensor  # (E,) int32
    edge_dst: torch.Tensor  # (E,) int32
    node_mask: torch.Tensor  # (N,) bool
    edge_mask: torch.Tensor  # (E,) bool
    graph_id: torch.Tensor  # (N,) int32
    n_graphs: int
    edge_feat: Optional[torch.Tensor] = None  # (E, Fe)
    edge_dist: Optional[torch.Tensor] = None  # (E,)

    @property
    def num_nodes(self) -> int:
        return int(self.node_feat.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.edge_src.shape[0])

    @property
    def device(self) -> torch.device:
        return self.node_feat.device

    def to(self, device) -> "GraphBatch":
        """The same batch with every tensor on ``device``; a softmax layout
        already built on the host is kept (its device copy is made anew)."""
        return self.map_tensors(lambda t: t.to(device))

    def map_tensors(self, fn) -> "GraphBatch":
        """The same batch with ``fn`` applied to every tensor field; a
        softmax layout already built on the host is kept."""
        moved = dataclasses.replace(self, **{
            f.name: fn(getattr(self, f.name))
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        })
        host = self.__dict__.get("_softmax_host")
        if host is not None:
            object.__setattr__(moved, "_softmax_host", host)
        return moved


def aggregate(
    messages: torch.Tensor,  # (E, D)
    dst: torch.Tensor,  # (E,)
    num_nodes: int,
    kind: str = "sum",
    mask: Optional[torch.Tensor] = None,
    layout=None,
) -> torch.Tensor:
    """Per-destination reduce. Empty rows give 0 for every kind (max: the
    segment max of no message is -inf, which is mapped to 0). Sum and mean
    add in the fixed order of ``layout`` (``segment_layout`` of ``dst``;
    built per call when None)."""
    from repro_torch.kernels.segment_sum import segment_sum

    idx = dst.long()
    if mask is not None:
        m = mask.reshape(mask.shape + (1,) * (messages.dim() - 1))
        fill = float("-inf") if kind == "max" else 0.0
        messages = torch.where(m, messages, torch.full((), fill, dtype=messages.dtype,
                                                       device=messages.device))
    shape = (num_nodes,) + tuple(messages.shape[1:])
    if kind in ("sum", "mean"):
        s = segment_sum(messages, idx, num_nodes, layout)
        if kind == "sum":
            return s
        ones = mask if mask is not None else torch.ones_like(idx, dtype=torch.float32)
        c = segment_sum(ones.to(torch.float32), idx, num_nodes, layout)
        return s / torch.clamp(c, min=1.0)[:, None]
    if kind == "max":
        out = torch.full(shape, float("-inf"), dtype=messages.dtype, device=messages.device)
        index = idx.reshape((-1,) + (1,) * (messages.dim() - 1)).expand_as(messages)
        out = out.scatter_reduce(0, index, messages, "amax", include_self=True)
        return torch.where(torch.isfinite(out), out, torch.zeros((), dtype=out.dtype,
                                                                  device=out.device))
    raise ValueError(kind)


def init_mlp(generator: torch.Generator, sizes, dtype=torch.float32, device=None,
             layer_norm: bool = False) -> Dict[str, Any]:
    """Weights ~ N(0, 1/fan_in), zero biases, drawn on the generator's device
    and moved to ``device``; ``layer_norm`` adds a unit scale and zero bias
    over the last size."""
    dev = device if device is not None else generator.device
    ws = [
        (torch.randn(a, b, generator=generator, device=generator.device) * a ** -0.5)
        .to(dtype=dtype, device=dev)
        for a, b in zip(sizes[:-1], sizes[1:])
    ]
    p: Dict[str, Any] = {"w": ws, "b": [torch.zeros(b, dtype=dtype, device=dev) for b in sizes[1:]]}
    if layer_norm:
        p["ln_scale"] = torch.ones(sizes[-1], dtype=dtype, device=dev)
        p["ln_bias"] = torch.zeros(sizes[-1], dtype=dtype, device=dev)
    return p


def mlp(p, x, act=torch.relu, final_act: bool = False):
    """``act`` between the layers (and after the last with ``final_act``),
    then the layer norm when ``p`` has one: population variance, eps 1e-6."""
    n = len(p["w"])
    for i, (w, b) in enumerate(zip(p["w"], p["b"])):
        x = x @ w + b
        if i < n - 1 or final_act:
            x = act(x)
    if "ln_scale" in p:
        mu = x.mean(-1, keepdim=True)
        var = x.var(-1, keepdim=True, unbiased=False)
        x = (x - mu) * torch.rsqrt(var + 1e-6) * p["ln_scale"] + p["ln_bias"]
    return x


# GAT's softmax layout: rows per block (at most the kernel's 8192) and slots
# per tile. Rows are packed by degree (LPT) and hub rows are never split: a
# split row would be normalized per virtual row.
SOFTMAX_EB = 256


def softmax_vb(num_nodes: int) -> int:
    """Row-block height of a batch's softmax layout: the power of two in
    (N/16, N/8] within [64, 8192], so 8-16 row blocks a head until the
    kernel's 8192 rows cap it; tall blocks let a hub row share its block
    with many light rows."""
    vb = 64
    while vb < 8192 and vb * 16 <= num_nodes:
        vb *= 2
    return vb


def softmax_tiles(b: GraphBatch):
    """The batch's softmax tile layout on its device, built on the host at
    first use (``prepare_tiles`` over the dst-sorted edges, the sort composed
    into ``gather_idx``) and kept on the batch (``GraphBatch`` is frozen, so
    through ``object.__setattr__``)."""
    from repro_torch.kernels.segment_softmax.ops import build_edge_tiles, device_tiles

    host = b.__dict__.get("_softmax_host")
    if host is None:
        host = build_edge_tiles(b.edge_dst.cpu().numpy(), b.edge_mask.cpu().numpy(),
                                b.num_nodes, vb=softmax_vb(b.num_nodes), eb=SOFTMAX_EB)
        object.__setattr__(b, "_softmax_host", host)
    cached = b.__dict__.get("_softmax_device")
    if cached is None or cached.device != b.device:
        cached = device_tiles(host, b.device)
        object.__setattr__(b, "_softmax_device", cached)
    return cached


def edge_layout(b: GraphBatch, by: str = "dst"):
    """The segment-sum layout of the batch's edges by destination (``by``
    "dst") or source ("src") on its device, built at first use and kept on
    the batch: it orders the sums over those ids (masked edges add their
    masked zeros), the gradients of the takes by them and GAT's edge
    softmax's backward. None for a traced batch (DTensors or fake tensors),
    whose sums and takes a dry run's forms place."""
    from repro_torch.kernels.segment_sum import segment_layout

    ids = b.edge_dst if by == "dst" else b.edge_src
    if type(ids) is not torch.Tensor:
        return None
    key = f"_{by}_layout"
    cached = b.__dict__.get(key)
    if cached is None or cached.device != b.device:
        # the batch's edge ids index its nodes (its edge takes read them)
        cached = segment_layout(ids, b.num_nodes, covers_all=True)
        object.__setattr__(b, key, cached)
    return cached


def edge_take(x: torch.Tensor, b: GraphBatch, by: str = "src") -> torch.Tensor:
    """``x[b.edge_src]`` (or ``edge_dst``): the port's take, whose gradient
    into x is the fixed-order segment sum over ``edge_layout(b, by)``."""
    from repro_torch.kernels.segment_sum import take

    ids = b.edge_src if by == "src" else b.edge_dst
    return take(x, ids.long(), edge_layout(b, by))


def segment_softmax(scores: torch.Tensor, b: GraphBatch) -> torch.Tensor:
    """Softmax of (E,) or (E, H) edge scores over each destination's valid
    in-edges, in edge order; masked edges get 0. Differentiable."""
    from repro_torch.kernels.segment_softmax.ops import segment_softmax_edges

    return segment_softmax_edges(scores, softmax_tiles(b), b.edge_dst, b.edge_mask,
                                 edge_layout(b))


def flat_softmax_tiles(dst: torch.Tensor, valid: torch.Tensor, num_rows: int, device=None):
    """The softmax tile layout of flat edge arrays (``dst`` rows in
    [0, num_rows), ``valid`` mask) on ``device`` (``dst``'s when None),
    built on the host as ``softmax_tiles`` builds a batch's."""
    from repro_torch.kernels.segment_softmax.ops import build_edge_tiles, device_tiles

    host = build_edge_tiles(dst.cpu().numpy(), valid.cpu().numpy(), num_rows,
                            vb=softmax_vb(num_rows), eb=SOFTMAX_EB)
    return device_tiles(host, dst.device if device is None else device)


def segment_softmax_xla(scores: torch.Tensor, dst: torch.Tensor, valid: torch.Tensor,
                        num_rows: int, tiles=None, layout=None) -> torch.Tensor:
    """Softmax of (E,) or (E, H) edge scores over each row's valid in-edges,
    for flat edge arrays; masked edges get 0. Runs on the segment-softmax op
    (the kernel on the card, its plain version on the CPU) over ``tiles``
    (``flat_softmax_tiles``; built here when None); its backward adds over
    ``layout`` (``segment_layout(dst, num_rows)``; built there when None).
    Differentiable."""
    from repro_torch.kernels.segment_softmax.ops import segment_softmax_edges

    if tiles is None:
        tiles = flat_softmax_tiles(dst, valid, num_rows)
    return segment_softmax_edges(scores, tiles, dst, valid, layout)
