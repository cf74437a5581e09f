"""Gradient compression for slow-axis data parallelism: int8 linear
quantization and top-k sparsification, with the error-feedback accumulator
that makes lossy sync converge (the residual of every round re-enters the
next gradient, so nothing is permanently lost).

Counterpart of ``repro.dist.compression``. The reference's named mesh axis
is a ``torch.distributed`` process group here, and its ``pmean`` a sum over
the group divided by the group's size. ``torch.round`` rounds half to even
as ``jnp.round`` does, so ``int8_compress`` gives the reference's bits, and
``topk_sparsify`` keeps every entry tied at the threshold, as the
reference's does.

On the wire: int8 sends the quantized payload itself (one byte an entry and
a float32 scale a tensor, ``all_gather``-ed; each rank dequantizes every
rank's payload and sums them in rank order, so all ranks hold the same
bits). Top-k sends its sparsified tensor dense in float32 (an
``all_reduce``), as the reference's ``pmean`` does; ``wire_bytes`` counts
what one rank sends. Under gloo a CUDA tensor goes through the host.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch.core.distributed import _all_gather, _all_reduce_sum
from repro_torch.train.optim import tree_flatten, tree_map

__all__ = [
    "int8_compress",
    "int8_decompress",
    "topk_sparsify",
    "compressed_psum",
    "make_error_feedback",
    "wire_bytes",
]

MODES = ("int8", "topk")


def int8_compress(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric linear quantization to int8: returns ``(q, scale)`` with
    ``x ~= q * scale`` and |error| <= scale / 2 (round half to even). The
    scale is max|x| / 127 in x's type, then float32, at least 1e-20."""
    peak = x.abs().max()
    # a tensor divisor: CUDA multiplies by the reciprocal of a Python-number
    # divisor, which is not the reference's quotient
    scale = (peak / torch.tensor(127.0, dtype=peak.dtype, device=peak.device)).to(torch.float32)
    scale = torch.clamp(scale, min=1e-20)
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def topk_sparsify(x: torch.Tensor, frac: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep the ``ceil(frac * n)`` largest-magnitude entries (ties keep
    everything at the threshold, so the mask can exceed k). Returns
    ``(sparse, mask)`` with ``sparse[mask] == x[mask]`` and zeros elsewhere."""
    flat = x.reshape(-1).abs()
    n = flat.shape[0]
    k = max(1, math.ceil(frac * n))
    thresh = torch.sort(flat).values[n - k]
    mask = x.abs() >= thresh
    return torch.where(mask, x, torch.zeros((), dtype=x.dtype, device=x.device)), mask


def _int8_mean(q: torch.Tensor, scale: torch.Tensor, group) -> torch.Tensor:
    """The mean over the group of every rank's dequantized payload: the int8
    words and the scales gathered, summed in rank order."""
    n = dist.get_world_size(group)
    qs = _all_gather(q.reshape(1, -1), group)
    ss = _all_gather(scale.reshape(1), group)
    total = qs[0].to(torch.float32) * ss[0]
    for r in range(1, n):
        total = total + qs[r].to(torch.float32) * ss[r]
    return (total / n).reshape(q.shape)


def _dense_mean(x: torch.Tensor, group) -> torch.Tensor:
    return _all_reduce_sum(x.contiguous(), group) / dist.get_world_size(group)


def compressed_psum(x: torch.Tensor, group, mode: str = "int8") -> torch.Tensor:
    """Stateless compressed all-reduce: quantize locally, mean across
    ``group``. For converging training prefer ``make_error_feedback`` (the
    residual matters); this is the one-shot form for metrics and eval
    reductions."""
    if mode == "int8":
        q, s = int8_compress(x)
        return _int8_mean(q, s, group)
    if mode == "topk":
        return _dense_mean(topk_sparsify(x, 0.1)[0], group)
    raise ValueError(f"unknown compression mode {mode!r}")


def make_error_feedback(mode: str = "int8", frac: float = 0.1):
    """Error-feedback compressed gradient sync (EF-SGD).

    Returns ``(init, apply)``:
      * ``init(params) -> ef``: zero float32 residuals mirroring the grads;
      * ``apply(grads, ef, group) -> (synced, ef')``: compress ``grads +
        ef``, mean the lossy payload across ``group``, carry this rank's
        quantization residual into the next step.
    """
    if mode not in MODES:
        raise ValueError(f"unknown compression mode {mode!r}")

    def init(params):
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                        params)

    def one(g, e, group):
        corrected = g.to(torch.float32) + e
        if mode == "int8":
            q, s = int8_compress(corrected)
            sent = int8_decompress(q, s)
            return _int8_mean(q, s, group), corrected - sent
        sent = topk_sparsify(corrected, frac)[0]
        return _dense_mean(sent, group), corrected - sent

    def apply(grads, ef, group):
        flat_g, rebuild = tree_flatten(grads)
        flat_e, _ = tree_flatten(ef)
        pairs = [one(g, e, group) for g, e in zip(flat_g, flat_e)]
        return rebuild([p[0] for p in pairs]), rebuild([p[1] for p in pairs])

    return init, apply


def wire_bytes(tree, mode: str) -> int:
    """Bytes one rank sends in one sync of ``tree``'s tensors: int8, one a
    entry and a 4-byte scale a tensor; top-k, 4 an entry (dense float32)."""
    if mode not in MODES:
        raise ValueError(f"unknown compression mode {mode!r}")
    leaves, _ = tree_flatten(tree)
    if mode == "int8":
        return sum(t.numel() + 4 for t in leaves)
    return sum(4 * t.numel() for t in leaves)
