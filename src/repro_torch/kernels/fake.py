"""The kernels under fake tensors, and the work each call does.

A dry run (``launch.dryrun``) traces a step on fake tensors
(``FakeTensorMode``): shapes, dtypes and devices, no storage. A fake CUDA
tensor reaches a kernel's CUDA branch, where the launcher would read
``data_ptr()``; each launcher therefore checks ``is_fake`` first and, for
fake operands, returns an empty output of the kernel's shape and type (its
output rule) without building or launching anything, and without counting
a launch. A real CUDA tensor always reaches the kernel.

``torch.utils.flop_counter.FlopCounterMode`` sees the aten ops around a
kernel but not the kernel, a ctypes call. So while a ``KernelWork``
context is active (``recording()``), every kernel call, real or fake,
reports its own operation count and the bytes it must move (each operand
read once, each output written once) through ``note``. With none active a
launch does neither test nor count beyond ``recording()`` and, for a plain
tensor, ``is_fake``'s type check.

The fixed-order segment sum (``kernels.segment_sum``) stands in for an
``index_add`` and notes nothing: its output rule (``segment_sum_rule``) is
that ``index_add`` on the fake operands, so a dry run's FLOPs (none for it)
and bytes stay those of the op it replaced, on every mesh.
"""
from __future__ import annotations

from typing import Dict, List

import torch

__all__ = ["is_fake", "note", "recording", "KernelWork", "nbytes", "segment_sum_rule"]

_ACTIVE: List["KernelWork"] = []  # the recorders now active, innermost last


def is_fake(t: torch.Tensor) -> bool:
    if type(t) is torch.Tensor:  # a real tensor: no subclass, no mode's wrapper
        return False
    from torch._subclasses.fake_tensor import is_fake as _is_fake

    return _is_fake(t)


def segment_sum_rule(x: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """The segment sum's output on fake operands x (E, d), seg (E,): the
    ``zeros.index_add_`` it stands in for (a fake checks no index)."""
    out = torch.zeros((num_segments,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    return out.index_add_(0, seg.reshape(-1), x)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def recording() -> bool:
    """A ``KernelWork`` is active: kernel calls report their work."""
    return bool(_ACTIVE)


def note(name: str, flops: float, moved_bytes: float) -> None:
    """One kernel call's operations and bytes, to every active recorder."""
    for rec in _ACTIVE:
        rec.add(name, flops, moved_bytes)


class KernelWork:
    """Collects ``note``'s reports while active (``with KernelWork() as w``):
    ``w.flops``, ``w.bytes`` and per kernel ``w.calls``."""

    def __init__(self) -> None:
        self.flops = 0.0
        self.bytes = 0.0
        self.calls: Dict[str, int] = {}

    def add(self, name: str, flops: float, moved_bytes: float) -> None:
        self.flops += flops
        self.bytes += moved_bytes
        self.calls[name] = self.calls.get(name, 0) + 1

    def __enter__(self) -> "KernelWork":
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE.remove(self)
