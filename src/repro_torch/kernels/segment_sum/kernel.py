"""The fixed-order segment sum on the card.

No TPU kernel is replaced: the reference's segment sums are
``jax.ops.segment_sum`` and the gradients XLA takes of ``jnp.take``, which
add in a fixed order on a TPU, where the port's ``index_add_`` adds with
atomics in an order that changes from run to run. One level of the sum is

    out[k] = sum of x[order[p]] for p in [starts[k], starts[k + 1]),
             in ascending p, from +0.0, in float32 (float64 for float64)

(``order`` None: x's own rows). ``segment_sum_rows`` runs a layout's levels
(``ops.SegmentLayout``: a run longer than ``CHUNK`` rows is summed in chunks
of ``CHUNK``, the chunk sums again at the next level), each level one launch
of the hand-written Hopper kernel in ``csrc/segment_sum.cu`` (built by
``nvcc`` at first use) on CUDA tensors, which raises if the build or the
launch fails; on CPU tensors ``fold_runs_plain``, the plain PyTorch version,
adds in the same order, bit for bit, and the kernel is checked against it on
the card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.fake import is_fake, segment_sum_rule

__all__ = ["CHUNK", "segment_sum_rows", "sum_levels", "fold_runs", "fold_runs_plain",
           "vector_width", "LAUNCHES", "reset_launch_counts"]

SOURCE = "segment_sum.cu"
CHUNK = 256  # the most rows one level sums into one output row

# kernel launches (one a level) by the sum's type, 'f32' or 'bf16';
# incremented only where the CUDA kernel is launched
LAUNCHES: dict = {}

_KERNEL_TYPES = (torch.float32, torch.bfloat16)


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def fold_runs_plain(x: torch.Tensor, order, starts: torch.Tensor,
                    out_dtype: torch.dtype) -> torch.Tensor:
    """One level in plain PyTorch: x (n, d) -> (len(starts) - 1, d) in
    ``out_dtype``. The j-th rows of all runs are added in one step, for j
    up to the longest run (the runs sorted longest first, so the runs still
    open are a prefix), which is the kernel's order within each run."""
    lens = starts[1:] - starts[:-1]
    k, d = lens.shape[0], x.shape[1]
    acc = torch.zeros((k, d), dtype=_acc_dtype(x.dtype), device=x.device)
    if k == 0 or d == 0 or x.shape[0] == 0:
        return acc.to(out_dtype)
    by_len = torch.argsort(lens, descending=True, stable=True)
    first = starts[:-1][by_len]
    longest = int(lens[by_len[0]])
    # open[j]: the runs longer than j
    per_len = torch.bincount(lens, minlength=longest + 1)
    open_runs = (k - torch.cumsum(per_len, 0))[:longest].tolist()
    for j, n in enumerate(open_runs):
        pos = first[:n] + j
        rows = pos if order is None else order[pos]
        acc[:n] += x[rows].to(acc.dtype)
    out = torch.empty_like(acc)
    out[by_len] = acc
    return out.to(out_dtype)


def vector_width(x: torch.Tensor, out: torch.Tensor) -> int:
    """Elements a load: 4 or 2 where d and both base addresses allow it,
    else 1."""
    d = x.shape[1]
    for vec in (4, 2):
        if d % vec == 0 and x.data_ptr() % (vec * x.element_size()) == 0 and \
                out.data_ptr() % (vec * out.element_size()) == 0:
            return vec
    return 1


def _launch(x, order, starts, out_dtype, key):
    from repro_torch.kernels.build import KernelLaunchError, load_library

    k, d = starts.shape[0] - 1, x.shape[1]
    out = torch.empty((k, d), dtype=out_dtype, device=x.device)
    if k == 0 or d == 0:
        return out
    lib, _ = load_library(SOURCE)
    fn = lib.segment_sum_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):  # the launch goes to the current device
        err = fn(x.data_ptr(), order.data_ptr() if order is not None else None,
                 starts.data_ptr(), out.data_ptr(), k, d, int(x.dtype == torch.bfloat16),
                 int(out_dtype == torch.bfloat16), vector_width(x, out),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise KernelLaunchError(f"segment_sum launch failed: CUDA error {err}")
    LAUNCHES[key] = LAUNCHES.get(key, 0) + 1
    return out


def fold_runs(x: torch.Tensor, order, starts: torch.Tensor,
              out_dtype: torch.dtype) -> torch.Tensor:
    """One level: the kernel on CUDA tensors (float32 or bf16 in and out),
    the plain version on CPU tensors."""
    if x.device.type == "cuda":
        if x.dtype not in _KERNEL_TYPES or out_dtype not in _KERNEL_TYPES:
            raise ValueError(f"the kernel sums float32 or bfloat16, got {x.dtype} -> "
                             f"{out_dtype}")
        for name, t in (("order", order), ("starts", starts)):
            if t is not None and (t.dtype != torch.int64 or t.device != x.device
                                  or not t.is_contiguous()):
                raise ValueError(f"{name} must be contiguous int64 on {x.device}")
        if not x.is_contiguous():
            raise ValueError("x must be contiguous")
        key = "bf16" if torch.bfloat16 in (x.dtype, out_dtype) else "f32"
        return _launch(x, order, starts, out_dtype, key)
    if x.device.type == "cpu":
        return fold_runs_plain(x, order, starts, out_dtype)
    raise ValueError(f"unsupported device {x.device}")


def segment_sum_rows(x: torch.Tensor, seg: torch.Tensor, layout,
                     num_segments: int) -> torch.Tensor:
    """x (E, d) -> (num_segments, d) in x's type, over ``layout``
    (``ops.SegmentLayout`` of ``seg``, on x's device; None only for a fake
    x): each level one ``fold_runs``, the levels before the last kept in
    float32 (float64 for float64). A fake x (a dry run's trace) takes the
    output rule, ``fake.segment_sum_rule``, and no kernel work is noted:
    the trace counts the ``index_add`` this stands in for."""
    if is_fake(x):
        return segment_sum_rule(x, seg, num_segments)
    return sum_levels(x, layout, fold_runs)


def sum_levels(x: torch.Tensor, layout, fold) -> torch.Tensor:
    """x (E, d) through each level of ``layout`` by ``fold`` (``fold_runs``
    or ``fold_runs_plain``): the order through the first level, the levels
    before the last kept in float32 (float64 for float64)."""
    y = x
    for i, starts in enumerate(layout.starts):
        last = i == len(layout.starts) - 1
        y = fold(y, layout.order if i == 0 else None, starts,
                 x.dtype if last else _acc_dtype(x.dtype))
    return y
