"""Train / infer step builders for the GNN family.

Counterpart of the GNN builders of ``repro.train.steps``. Each builder
returns a plain function: ``train_step(state, batch, labels) -> (new state,
{"loss"})`` with the gradients from ``torch.autograd`` and the update from
``optim.adamw_update``, and ``infer(params, batch)``. ``TrainState`` is a
plain dict {'params', 'opt'}; the step returns a new one and changes none
of its tensors. The LM and DIN builders come with the LM and DIN training
slices.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.models.gnn import archs as gnn
from repro_torch.models.gnn.common import GraphBatch
from repro_torch.train import losses
from repro_torch.train.optim import AdamWConfig, adamw_update, init_adamw, tree_flatten

__all__ = ["init_train_state", "make_gnn_loss", "make_gnn_train_step", "make_gnn_infer",
           "value_and_grad"]


def init_train_state(params, opt_cfg: AdamWConfig):
    return {"params": params, "opt": init_adamw(params, opt_cfg)}


def _apply_update(state, grads, opt_cfg, grad_transform=None):
    if grad_transform is not None:
        grads = grad_transform(grads)
    new_p, new_opt = adamw_update(state["params"], grads, state["opt"], opt_cfg)
    return {"params": new_p, "opt": new_opt}


def value_and_grad(loss_fn: Callable, params, *args):
    """(loss, grads shaped like ``params``): ``loss_fn(params, *args)`` on
    leaves that require grad; a leaf the loss does not reach gets zeros."""
    leaves, rebuild = tree_flatten(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        loss = loss_fn(rebuild(live), *args)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [g if g is not None else torch.zeros_like(p) for g, p in zip(grads, live)]
    return loss.detach(), rebuild(grads)


# task kinds: 'node_class' | 'graph_class' | 'node_reg'
def make_gnn_loss(cfg: gnn.GNNConfig, task: str = "node_class",
                  loss_nodes: Optional[int] = None):
    """``loss_fn(params, batch, labels)`` of the train step."""
    def loss_fn(params, batch: GraphBatch, labels):
        out = gnn.apply(params, batch, cfg)
        if task == "graph_class":
            pooled = gnn.graph_readout(out, batch, "sum")
            return losses.softmax_xent(pooled, labels)
        if task == "node_reg":
            mask = batch.node_mask.to(torch.float32)[:, None]
            return losses.mse(out * mask, labels * mask)
        mask = batch.node_mask
        out_l, lab_l = out, labels
        if loss_nodes is not None:
            out_l, lab_l, mask = out[:loss_nodes], labels[:loss_nodes], mask[:loss_nodes]
        return losses.masked_softmax_xent(out_l, lab_l, mask.to(torch.float32))

    return loss_fn


def make_gnn_train_step(
    cfg: gnn.GNNConfig,
    opt_cfg: AdamWConfig,
    task: str = "node_class",
    loss_nodes: Optional[int] = None,  # minibatch: loss only on seed nodes
    grad_transform: Optional[Callable] = None,
):
    loss_fn = make_gnn_loss(cfg, task, loss_nodes)

    def train_step(state, batch: GraphBatch, labels):
        loss, grads = value_and_grad(loss_fn, state["params"], batch, labels)
        new_state = _apply_update(state, grads, opt_cfg, grad_transform)
        return new_state, {"loss": loss}

    return train_step


def make_gnn_infer(cfg: gnn.GNNConfig, task: str = "node_class"):
    @torch.no_grad()
    def infer(params, batch: GraphBatch):
        out = gnn.apply(params, batch, cfg)
        if task == "graph_class":
            return gnn.graph_readout(out, batch, "sum")
        return out

    return infer
