"""AdamW with decoupled weight decay, global-norm clipping and a
warmup-cosine schedule, applied as plain functions on parameter trees.

Counterpart of ``repro.train.optim``. A tree is nested dicts and lists of
tensors; its leaves are taken in the reference's order (dict keys sorted,
list items in order), so the global norm sums them as the reference does.
The optimizer state mirrors the params (``AdamWState``); nothing goes
through ``torch.optim``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import torch

__all__ = ["AdamWConfig", "AdamWState", "init_adamw", "adamw_update", "warmup_cosine",
           "global_norm", "tree_flatten", "tree_map"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    # master weights / moments dtype (params may be bf16)
    state_dtype: Any = torch.float32


class AdamWState(NamedTuple):
    step: torch.Tensor  # () int32
    mu: Any
    nu: Any


def tree_flatten(tree, is_leaf=None) -> Tuple[List[Any], Callable[[list], Any]]:
    """(leaves in the reference's order, a function rebuilding the tree from
    a list of leaves in that order).

    ``jax.tree``'s rules: dict keys sorted, list, tuple and NamedTuple items
    in order, each rebuilt as its own type; ``None`` is an empty subtree (no
    leaf, rebuilt as None); anything else (a tensor, a Python scalar, a
    tuple subclass that is not a NamedTuple) is a leaf. ``is_leaf(node)``
    true makes ``node`` a leaf."""
    leaves: list = []

    def walk(t):
        if is_leaf is not None and is_leaf(t):
            leaves.append(t)
            return lambda it: next(it)
        if t is None:
            return lambda it: None
        if isinstance(t, dict):
            keys = sorted(t)
            subs = [walk(t[k]) for k in keys]
            return lambda it: {k: s(it) for k, s in zip(keys, subs)}
        if type(t) in (list, tuple) or (isinstance(t, tuple) and hasattr(t, "_fields")):
            subs = [walk(v) for v in t]
            kind = type(t)
            if kind is list:
                return lambda it: [s(it) for s in subs]
            if kind is tuple:
                return lambda it: tuple(s(it) for s in subs)
            return lambda it: kind(*(s(it) for s in subs))
        leaves.append(t)
        return lambda it: next(it)

    build = walk(tree)
    return leaves, lambda new: build(iter(new))


def tree_map(fn, tree, *rest):
    leaves, rebuild = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return rebuild([fn(*xs) for xs in zip(leaves, *others)])


def global_norm(tree) -> torch.Tensor:
    leaves, _ = tree_flatten(tree)
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32))) for x in leaves))


def warmup_cosine(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an int32 tensor), in float32."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * cos


def init_adamw(params, cfg: AdamWConfig) -> AdamWState:
    zeros = lambda p: torch.zeros(p.shape, dtype=cfg.state_dtype, device=p.device)  # noqa: E731
    leaves, _ = tree_flatten(params)
    dev = leaves[0].device if leaves else None
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, cfg: AdamWConfig):
    """One AdamW step -> (new params, new state); nothing is updated in
    place. The bias corrections are float32 powers of the step count."""
    step = state.step + 1
    if cfg.clip_norm is not None:
        gn = global_norm(grads)
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-9), max=1.0)
        grads = tree_map(lambda g: g * scale, grads)
    lr = warmup_cosine(cfg, step)
    b1c = 1 - cfg.b1 ** step.to(torch.float32)
    b2c = 1 - cfg.b2 ** step.to(torch.float32)

    def upd(p, g, m, v):
        g32 = g.to(cfg.state_dtype)
        m = cfg.b1 * m + (1 - cfg.b1) * g32
        v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g32)
        mhat = m / b1c
        vhat = v / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.to(cfg.state_dtype)
        return (p.to(cfg.state_dtype) - lr * delta).to(p.dtype), m, v

    flat_p, rebuild = tree_flatten(params)
    flat_g, _ = tree_flatten(grads)
    flat_m, _ = tree_flatten(state.mu)
    flat_v, _ = tree_flatten(state.nu)
    out = [upd(p, g, m, v) for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v)]
    return rebuild([o[0] for o in out]), AdamWState(
        step=step, mu=rebuild([o[1] for o in out]), nu=rebuild([o[2] for o in out]))
