"""GNN architectures on the segment-ops substrate, in PyTorch.

Counterpart of ``repro.models.gnn.archs``:
  gin-tu        [arXiv:1810.00826]  5 layers, hidden 64, sum agg, learnable eps
  gat-cora      [arXiv:1710.10903]  2 layers, hidden 8 x 8 heads, attn agg
  schnet        [arXiv:1706.08566]  3 interactions, hidden 64, rbf 300, cutoff 10
  meshgraphnet  [arXiv:2010.03409]  15 layers, hidden 128, sum agg, 2-layer MLPs
  gcn           [arXiv:1609.02907]  sym-normalized SpMM conv
  sage          [arXiv:1706.02216]  GraphSAGE mean aggregator

Uniform interface: ``init(cfg, in_dim, out_dim, generator, device)`` /
``apply(params, batch, cfg)`` -> (N, out_dim) node outputs; graph-level
tasks pool with ``graph_readout``. The parameters are a plain dict with the
reference's tree layout: a homogeneous layer stack keeps the reference's
leading ``n_layers`` axis on every leaf (its ``jax.vmap``-stacked tree) and
runs as a Python loop, so ``params_from_reference`` carries weights across
leaf for leaf. GAT's edge softmax runs on the port's segment-softmax op
(``common.segment_softmax``); all message passing routes through
``aggregate``, whose sums (and GCN's degrees) are the port's fixed-order
segment sum over the batch's destination layout (``common.edge_layout``),
and node rows are taken by edge through ``common.edge_take``, whose gradient
is that sum.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as Fn

from repro_torch.device import resolve_device
from repro_torch.kernels.segment_sum import segment_sum
from repro_torch.models.gnn.common import (
    GraphBatch, aggregate, edge_layout, edge_take, init_mlp, mlp, segment_softmax,
)

__all__ = ["GNNConfig", "init", "apply", "graph_readout", "params_from_reference"]


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str  # 'gin' | 'gat' | 'schnet' | 'meshgraphnet' | 'gcn' | 'sage'
    n_layers: int
    d_hidden: int
    n_heads: int = 1
    aggregator: str = "sum"
    mlp_layers: int = 2
    rbf: int = 0  # schnet radial basis size
    cutoff: float = 10.0
    eps_learnable: bool = True
    dtype: Any = torch.float32
    # kept from the reference's config; eager torch has no scan to unroll
    # and no per-layer rematerialization, so neither has an effect here
    scan_unroll: bool = False
    remat: bool = False


# ---------------------------------------------------------------------------


def _stack(layers):
    """A list of per-layer trees -> one tree with a leading layer axis."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([lp[k] for lp in layers]) for k in first}
    if isinstance(first, list):
        return [_stack([lp[i] for lp in layers]) for i in range(len(first))]
    return torch.stack(layers)


def _layer(tree, i):
    """Layer ``i`` of a stacked tree."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_layer(v, i) for v in tree]
    return tree[i]


def _layers(params):
    """The per-layer trees of the stack, in order."""
    stacked = leaf = params["layers"]
    while isinstance(leaf, (dict, list)):
        leaf = next(iter(leaf.values())) if isinstance(leaf, dict) else leaf[0]
    return [_layer(stacked, i) for i in range(int(leaf.shape[0]))]


def init(cfg: GNNConfig, in_dim: int, out_dim: int, generator: torch.Generator,
         device="cuda") -> Dict[str, Any]:
    """Random parameters from ``generator`` (drawn on its device), on
    ``device``, in the reference's tree layout; GAT's attention vectors
    start at zero, as the reference's do."""
    dev = resolve_device(device)
    h, dt = cfg.d_hidden, cfg.dtype

    def normal(*shape, scale):
        return (torch.randn(*shape, generator=generator, device=generator.device)
                * scale).to(dtype=dt, device=dev)

    if cfg.name == "gat":
        # layer sizes differ (concat heads) -> explicit 2 layers, no stack
        hd, nh = h, cfg.n_heads
        return {
            "encoder": init_mlp(generator, [in_dim, hd * nh], dt, dev),
            "l1_w": normal(hd * nh, nh, hd, scale=(h * nh) ** -0.5),
            "l1_asrc": torch.zeros(nh, hd, dtype=dt, device=dev),
            "l1_adst": torch.zeros(nh, hd, dtype=dt, device=dev),
            "l2_w": normal(hd * nh, 1, out_dim, scale=(hd * nh) ** -0.5),
            "l2_asrc": torch.zeros(1, out_dim, dtype=dt, device=dev),
            "l2_adst": torch.zeros(1, out_dim, dtype=dt, device=dev),
        }
    if cfg.name == "gin":
        def layer():
            return {"mlp": init_mlp(generator, [h, h, h], dt, dev),
                    "eps": torch.zeros((), dtype=dt, device=dev)}
    elif cfg.name == "schnet":
        def layer():
            return {"filter": init_mlp(generator, [cfg.rbf, h, h], dt, dev),
                    "in_proj": init_mlp(generator, [h, h], dt, dev),
                    "out_mlp": init_mlp(generator, [h, h, h], dt, dev)}
    elif cfg.name == "meshgraphnet":
        def layer():
            sizes = [h] * cfg.mlp_layers
            return {"edge_mlp": init_mlp(generator, [3 * h] + sizes, dt, dev, layer_norm=True),
                    "node_mlp": init_mlp(generator, [2 * h] + sizes, dt, dev, layer_norm=True)}
    elif cfg.name == "gcn":
        def layer():
            return {"w": init_mlp(generator, [h, h], dt, dev)}
    elif cfg.name == "sage":
        def layer():
            return {"w_self": init_mlp(generator, [h, h], dt, dev),
                    "w_neigh": init_mlp(generator, [h, h], dt, dev)}
    else:
        raise ValueError(cfg.name)

    params = {
        "encoder": init_mlp(generator, [in_dim, h, h], dt, dev,
                            layer_norm=(cfg.name == "meshgraphnet")),
        "layers": _stack([layer() for _ in range(cfg.n_layers)]),
        "decoder": init_mlp(generator, [h, h, out_dim], dt, dev),
    }
    if cfg.name == "meshgraphnet":
        params["edge_encoder"] = init_mlp(generator, [1, h, h], dt, dev, layer_norm=True)
    return params


def params_from_reference(tree, cfg: GNNConfig, device="cuda") -> Dict[str, Any]:
    """The reference's ``init`` params (leaves as numpy arrays, stacked
    layers with their leading axis) as the port's params on ``device``."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        return torch.from_numpy(np.array(x, copy=True)).to(device=dev, dtype=cfg.dtype)

    return conv(tree)


# ---------------------------------------------------------------------------


def _gin_apply(params, b: GraphBatch, cfg: GNNConfig):
    h = mlp(params["encoder"], b.node_feat)
    for lp in _layers(params):
        agg = aggregate(edge_take(h, b), b.edge_dst, b.num_nodes, "sum", b.edge_mask,
                        layout=edge_layout(b))
        h = mlp(lp["mlp"], (1.0 + lp["eps"]) * h + agg, final_act=True)
    return mlp(params["decoder"], h)


def _gat_layer(x, w, a_src, a_dst, b: GraphBatch, final: bool):
    # x (N, Din); w (Din, H, hd); scores via additive attention per head
    xp = torch.einsum("nd,dhf->nhf", x, w)  # (N, H, hd)
    s_src = (xp * a_src[None]).sum(-1)  # (N, H)
    s_dst = (xp * a_dst[None]).sum(-1)
    e = Fn.leaky_relu(edge_take(s_src, b) + edge_take(s_dst, b, "dst"),
                      negative_slope=0.2)  # (E, H)
    att = segment_softmax(e, b)  # (E, H), the segment-softmax kernel per head
    msgs = edge_take(xp, b) * att[..., None]  # (E, H, hd)
    out = aggregate(msgs.reshape(msgs.shape[0], -1), b.edge_dst, b.num_nodes, "sum",
                    b.edge_mask, layout=edge_layout(b))
    out = out.reshape(x.shape[0], att.shape[1], -1)  # (N, H, hd)
    if final:
        return out.mean(dim=1)  # average heads (GAT output layer)
    return Fn.elu(out.reshape(x.shape[0], -1))  # concat heads


def _gat_apply(params, b: GraphBatch, cfg: GNNConfig):
    x = mlp(params["encoder"], b.node_feat)
    x = _gat_layer(x, params["l1_w"], params["l1_asrc"], params["l1_adst"], b, final=False)
    return _gat_layer(x, params["l2_w"], params["l2_asrc"], params["l2_adst"], b, final=True)


def _schnet_rbf(dist, n_rbf, cutoff):
    centers = torch.linspace(0.0, cutoff, n_rbf, dtype=torch.float32, device=dist.device)
    gamma = 10.0
    return torch.exp(-gamma * torch.square(dist[:, None] - centers[None, :]))


def _schnet_apply(params, b: GraphBatch, cfg: GNNConfig):
    h = mlp(params["encoder"], b.node_feat)
    dist = b.edge_dist if b.edge_dist is not None else \
        torch.ones(b.num_edges, dtype=torch.float32, device=b.device)
    rbf = _schnet_rbf(dist, cfg.rbf, cfg.cutoff)  # (E, rbf)
    for lp in _layers(params):
        w = mlp(lp["filter"], rbf)  # (E, h) continuous-filter weights
        msgs = edge_take(mlp(lp["in_proj"], h), b) * w
        agg = aggregate(msgs, b.edge_dst, b.num_nodes, "sum", b.edge_mask,
                        layout=edge_layout(b))
        h = h + mlp(lp["out_mlp"], agg)  # residual interaction block
    return mlp(params["decoder"], h)


def _mgn_apply(params, b: GraphBatch, cfg: GNNConfig):
    h = mlp(params["encoder"], b.node_feat)
    ef = b.edge_dist[:, None] if b.edge_dist is not None else \
        torch.ones(b.num_edges, 1, dtype=cfg.dtype, device=b.device)
    e = mlp(params["edge_encoder"], ef)
    for lp in _layers(params):
        e = e + mlp(lp["edge_mlp"], torch.cat([e, edge_take(h, b), edge_take(h, b, "dst")],
                                              dim=-1))
        agg = aggregate(e, b.edge_dst, b.num_nodes, cfg.aggregator, b.edge_mask,
                        layout=edge_layout(b))
        h = h + mlp(lp["node_mlp"], torch.cat([h, agg], dim=-1))
    return mlp(params["decoder"], h)


def _gcn_apply(params, b: GraphBatch, cfg: GNNConfig):
    h = mlp(params["encoder"], b.node_feat)
    src, dst = b.edge_src.long(), b.edge_dst.long()
    ones = b.edge_mask.to(torch.float32)
    deg = segment_sum(ones, dst, b.num_nodes, edge_layout(b)) + 1.0
    deg_src = segment_sum(ones, src, b.num_nodes, edge_layout(b, "src")) + 1.0
    # symmetric normalization 1/sqrt(d_i d_j) with implicit self loop
    norm = torch.rsqrt(deg_src[src] * deg[dst])
    for lp in _layers(params):
        agg = aggregate(edge_take(h, b) * norm[:, None], b.edge_dst, b.num_nodes, "sum",
                        b.edge_mask,
                        layout=edge_layout(b))
        agg = agg + h * torch.rsqrt(deg)[:, None]  # self loop
        h = torch.relu(mlp(lp["w"], agg))
    return mlp(params["decoder"], h)


def _sage_apply(params, b: GraphBatch, cfg: GNNConfig):
    h = mlp(params["encoder"], b.node_feat)
    for lp in _layers(params):
        agg = aggregate(edge_take(h, b), b.edge_dst, b.num_nodes, "mean", b.edge_mask,
                        layout=edge_layout(b))
        h = torch.relu(mlp(lp["w_self"], h) + mlp(lp["w_neigh"], agg))
        # L2 normalize (GraphSAGE 3.1)
        h = h / torch.clamp(torch.linalg.vector_norm(h, dim=-1, keepdim=True), min=1e-6)
    return mlp(params["decoder"], h)


_APPLY = {
    "gin": _gin_apply,
    "gat": _gat_apply,
    "schnet": _schnet_apply,
    "meshgraphnet": _mgn_apply,
    "gcn": _gcn_apply,
    "sage": _sage_apply,
}


def apply(params, batch: GraphBatch, cfg: GNNConfig) -> torch.Tensor:
    out = _APPLY[cfg.name](params, batch, cfg)
    return torch.where(batch.node_mask[:, None], out, torch.zeros((), dtype=out.dtype,
                                                                  device=out.device))


def graph_readout(node_out: torch.Tensor, batch: GraphBatch, kind: str = "sum"):
    return aggregate(node_out, batch.graph_id, batch.n_graphs, kind, batch.node_mask)
