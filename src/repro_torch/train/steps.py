"""Train / serve step builders for the LM, GNN and DIN families.

Counterpart of ``repro.train.steps``. Each builder returns a plain
function: ``train_step(state, batch[, labels]) -> (new state, {"loss"})``
with the gradients from ``torch.autograd`` and the update from
``optim.adamw_update``; ``prefill(params, tokens)``, ``decode(params,
cache, tokens, pos)``, ``infer(params, batch)``, ``serve(params, batch)``
and ``retrieve(params, batch)`` run without autograd. ``TrainState`` is a
plain dict {'params', 'opt'}; the step returns a new one and changes none
of its tensors. DIN's profile bag differentiates through the embedding-bag
op's backward (a kernel on the card, ``kernels.embedding_bag.ops``).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.models import transformer as tfm
from repro_torch.models.gnn import archs as gnn
from repro_torch.models.gnn.common import GraphBatch
from repro_torch.models.recsys import din as din_mod
from repro_torch.train import losses
from repro_torch.train.optim import (
    AdamWConfig, adamw_update, init_adamw, tree_flatten, tree_map,
)

__all__ = ["init_train_state", "make_lm_loss", "make_lm_train_step", "make_lm_prefill",
           "make_lm_decode_step", "make_gnn_loss", "make_gnn_train_step", "make_gnn_infer",
           "make_din_loss", "make_din_train_step", "make_din_serve", "make_din_retrieval",
           "value_and_grad", "mask_vocab_padding"]


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


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------


def mask_vocab_padding(logits: torch.Tensor, vocab_real) -> torch.Tensor:
    """``logits`` (..., V) with the columns from ``vocab_real`` on set to -1e30
    (a padded vocab); elementwise, so a vocab-split DTensor keeps its split."""
    vocab = logits.shape[-1]
    if vocab_real is None or vocab_real >= vocab:
        return logits
    pad_mask = torch.arange(vocab, device=logits.device) >= vocab_real
    return torch.where(pad_mask, torch.tensor(-1e30, dtype=logits.dtype, device=logits.device),
                       logits)


def make_lm_loss(cfg: tfm.LMConfig):
    """``loss_fn(params, tokens, labels)``: next-token cross-entropy plus the
    MoE aux loss; the padding columns of a padded vocab get -1e30."""
    def loss_fn(params, tokens, labels):
        logits, aux = tfm.forward(params, tokens, cfg)
        logits = mask_vocab_padding(logits, cfg.vocab_real)
        return losses.softmax_xent(logits, labels) + aux

    return loss_fn


def make_lm_train_step(
    cfg: tfm.LMConfig,
    opt_cfg: AdamWConfig,
    grad_accum: int = 1,
    grad_transform: Optional[Callable] = None,
):
    """``train_step(state, {"tokens", "labels"})``; with ``grad_accum`` > 1 the
    batch splits into that many micro-batches whose losses and float32
    grads are averaged, as the reference's scan does."""
    loss_fn = make_lm_loss(cfg)

    def train_step(state, batch):
        if grad_accum == 1:
            loss, grads = value_and_grad(loss_fn, state["params"], batch["tokens"],
                                         batch["labels"])
        else:
            mb = batch["tokens"].shape[0] // grad_accum
            toks = batch["tokens"].reshape(grad_accum, mb, -1)
            labs = batch["labels"].reshape(grad_accum, mb, -1)
            loss = torch.zeros((), dtype=torch.float32, device=toks.device)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), state["params"])
            for t, l in zip(toks, labs):
                lo, g = value_and_grad(loss_fn, state["params"], t, l)
                loss = loss + lo
                grads = tree_map(torch.add, grads, g)
            loss = loss / grad_accum
            grads = tree_map(lambda g: g / grad_accum, grads)
        new_state = _apply_update(state, grads, opt_cfg, grad_transform)
        return new_state, {"loss": loss}

    return train_step


def make_lm_prefill(cfg: tfm.LMConfig):
    @torch.no_grad()
    def prefill(params, tokens):
        logits, _ = tfm.forward(params, tokens, cfg)
        return logits

    return prefill


def make_lm_decode_step(cfg: tfm.LMConfig):
    @torch.no_grad()
    def decode(params, cache, tokens, pos):
        return tfm.decode_step(params, cache, tokens, pos, cfg)

    return decode


# ---------------------------------------------------------------------------
# GNN family — task kinds: 'node_class' | 'graph_class' | 'node_reg'
# ---------------------------------------------------------------------------
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


# ---------------------------------------------------------------------------
# RecSys (DIN)
# ---------------------------------------------------------------------------


def make_din_loss(cfg: din_mod.DINConfig, lookup_fn: Optional[Callable] = None):
    """``loss_fn(params, batch)``: binary cross-entropy of the click logits
    against ``batch["labels"]``."""
    def loss_fn(params, batch):
        logits = din_mod.score(params, batch, cfg, lookup_fn=lookup_fn)
        return losses.binary_xent(logits, batch["labels"])

    return loss_fn


def make_din_train_step(
    cfg: din_mod.DINConfig,
    opt_cfg: AdamWConfig,
    grad_transform: Optional[Callable] = None,
    lookup_fn: Optional[Callable] = None,
):
    """``train_step(state, batch)`` on a ``recsys_batch`` of tensors (labels
    included); the item rows by ``lookup_fn`` when given, else a take."""
    loss_fn = make_din_loss(cfg, lookup_fn)

    def train_step(state, batch):
        loss, grads = value_and_grad(loss_fn, state["params"], batch)
        new_state = _apply_update(state, grads, opt_cfg, grad_transform)
        return new_state, {"loss": loss}

    return train_step


def make_din_serve(cfg: din_mod.DINConfig, lookup_fn: Optional[Callable] = None):
    @torch.no_grad()
    def serve(params, batch):
        return din_mod.score(params, batch, cfg, lookup_fn=lookup_fn)

    return serve


def make_din_retrieval(cfg: din_mod.DINConfig, chunk: Optional[int] = None):
    @torch.no_grad()
    def retrieve(params, batch):
        return din_mod.score_candidates(params, batch, cfg, chunk=chunk)

    return retrieve
