"""DIN — Deep Interest Network [arXiv:1706.06978], in PyTorch.

Counterpart of ``repro.models.recsys.din``: embed_dim=18, seq_len=100,
attention MLP 80-40, output MLP 200-80, target attention over the user's
behaviour sequence (unnormalized attention weights, per the paper). The
parameters are a plain dict with the reference's tree layout, so
``params_from_reference`` carries the reference's weights across.

The multi-hot user profile goes through the port's EmbeddingBag op
(``kernels.embedding_bag.embedding_bag``): the hand-written Hopper kernel on
the card, the plain version on the CPU. The item-table take goes through
``lookup_fn`` when one is given (``dist.embedding.make_crossbar_lookup``,
the serving router's path), else ``index_select``; the MLPs are plain
matmuls.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.embedding_bag import embedding_bag
from repro_torch.models.gnn.common import init_mlp, mlp

__all__ = ["DINConfig", "init", "params_from_reference", "batch_to", "score",
           "score_candidates"]


@dataclasses.dataclass(frozen=True)
class DINConfig:
    name: str = "din"
    embed_dim: int = 18
    seq_len: int = 100
    attn_mlp: tuple = (80, 40)
    out_mlp: tuple = (200, 80)
    item_vocab: int = 1_000_000
    cate_vocab: int = 1_000
    profile_bag_len: int = 32  # multi-hot profile feature (EmbeddingBag)
    dtype: Any = torch.float32
    lookup: str = "take"  # 'take' | 'crossbar' (GraphScale exchange)


def init(cfg: DINConfig, generator: torch.Generator, device="cuda") -> Dict[str, Any]:
    """Random parameters from ``generator`` (drawn on its device), on
    ``device``: N(0, 0.01^2) tables, N(0, 1/fan_in) MLP weights, PReLU 0.25."""
    dev = resolve_device(device)
    d = cfg.embed_dim
    elem = 2 * d  # item ++ cate

    def table(rows):
        t = torch.randn(rows, d, generator=generator, device=generator.device) * 0.01
        return t.to(dtype=cfg.dtype, device=dev)

    return {
        "item_table": table(cfg.item_vocab),
        "cate_table": table(cfg.cate_vocab),
        "attn": init_mlp(generator, [4 * elem, *cfg.attn_mlp, 1], cfg.dtype, dev),
        # input: attention-pooled history (elem) ++ target (elem) ++ profile bag (d)
        "out": init_mlp(generator, [2 * elem + d, *cfg.out_mlp, 1], cfg.dtype, dev),
        "prelu": torch.full((len(cfg.out_mlp),), 0.25, dtype=cfg.dtype, device=dev),
    }


def params_from_reference(tree, device="cuda") -> Dict[str, Any]:
    """The reference's ``din.init`` params, leaves as numpy arrays
    (``item_table``, ``cate_table``, ``attn``/``out`` w/b lists, ``prelu``),
    as the port's params on ``device``."""
    dev = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    return {
        "item_table": t(tree["item_table"]),
        "cate_table": t(tree["cate_table"]),
        **{k: {"w": [t(w) for w in tree[k]["w"]], "b": [t(b) for b in tree[k]["b"]]}
           for k in ("attn", "out")},
        "prelu": t(tree["prelu"]),
    }


def batch_to(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays (``data.synthetic``) as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v), device=device) for k, v in batch.items()}


def _take(table, ids):
    return table.index_select(0, ids.reshape(-1)).reshape(*ids.shape, table.shape[1])


def _embed_elem(params, item_ids, cate_ids, lookup_fn=None):
    """Item rows through ``lookup_fn`` (the crossbar exchange) when given,
    else a plain take; category rows by take. -> (..., 2d)."""
    items = item_ids.clamp(min=0)
    it = lookup_fn(params["item_table"], items) if lookup_fn is not None \
        else _take(params["item_table"], items)
    ct = _take(params["cate_table"], cate_ids.clamp(min=0))
    return torch.cat([it, ct], dim=-1)


def _attention_pool(params, hist, target, hist_mask):
    """DIN local activation unit: a = MLP([h, t, h-t, h*t]); weighted sum.
    hist (B, L, e); target (B, e) -> (B, e)."""
    t = target[:, None, :].to(hist.dtype)
    feats = torch.cat([hist, t.expand_as(hist), hist - t, hist * t], dim=-1)
    a = mlp(params["attn"], feats)[..., 0]  # (B, L), NOT softmax-normalized (paper)
    a = torch.where(hist_mask, a, torch.zeros((), dtype=a.dtype, device=a.device))
    return torch.einsum("bl,ble->be", a, hist)


def _masked_history(params, batch, lookup_fn):
    hist = _embed_elem(params, batch["hist_items"], batch["hist_cates"], lookup_fn)
    hist_mask = batch["hist_items"] >= 0
    hist = torch.where(hist_mask[..., None], hist, torch.zeros((), dtype=hist.dtype,
                                                                 device=hist.device))
    return hist, hist_mask


def _out_mlp(params, x):
    """The output MLP with PReLU activations -> logits (...,)."""
    n = len(params["out"]["w"])
    for i, (w, b) in enumerate(zip(params["out"]["w"], params["out"]["b"])):
        x = x @ w + b
        if i < n - 1:
            x = torch.where(x >= 0, x, params["prelu"][i] * x)
    return x[..., 0]


def score(params, batch: Dict[str, torch.Tensor], cfg: DINConfig, lookup_fn=None) -> torch.Tensor:
    """batch: hist_items/hist_cates (B, L) [-1 pad], target_item/target_cate
    (B,), profile_bag (B, P) [-1 pad], tensors on the params' device.
    Returns logits (B,)."""
    hist, hist_mask = _masked_history(params, batch, lookup_fn)  # (B, L, e)
    target = _embed_elem(params, batch["target_item"], batch["target_cate"], lookup_fn)
    user = _attention_pool(params, hist, target, hist_mask)  # (B, e)
    prof = embedding_bag(params["cate_table"], batch["profile_bag"], mode="sum")
    return _out_mlp(params, torch.cat([user, target, prof], dim=-1))


def score_candidates(
    params,
    batch: Dict[str, torch.Tensor],
    cfg: DINConfig,
    chunk: int | None = None,
    lookup_fn=None,
) -> torch.Tensor:
    """Retrieval scoring: ONE user vs n_candidates items. batch:
    hist_items/hist_cates (1, L), profile_bag (1, P), cand_items/cand_cates
    (C,). Returns (C,) scores.

    ``chunk=None`` scores all candidates in one pass; an integer chunk (which
    must divide C) scores them ``chunk`` at a time to bound memory.
    ``lookup_fn`` routes both the history and the candidate item-table reads
    (see ``_embed_elem``)."""
    c = batch["cand_items"].shape[0]
    hist, hist_mask = _masked_history(params, batch, lookup_fn)  # (1, L, e)
    prof = embedding_bag(params["cate_table"], batch["profile_bag"], mode="sum")  # (1, d)

    def score_block(items, cates):
        n = items.shape[0]
        target = _embed_elem(params, items, cates, lookup_fn)  # (n, e)
        h = hist.expand(n, *hist.shape[1:])
        m = hist_mask.expand(n, *hist_mask.shape[1:])
        user = _attention_pool(params, h, target, m)  # (n, e)
        x = torch.cat([user, target, prof.expand(n, prof.shape[-1])], dim=-1)
        return _out_mlp(params, x)

    if chunk is None:
        return score_block(batch["cand_items"], batch["cand_cates"])
    if c % chunk:
        raise ValueError(f"chunk={chunk} must divide n_candidates={c}")
    return torch.cat([score_block(batch["cand_items"][i:i + chunk],
                                  batch["cand_cates"][i:i + chunk])
                      for i in range(0, c, chunk)])
