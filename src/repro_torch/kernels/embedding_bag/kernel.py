"""The embedding bag on the card: per bag, the sum or mean of table rows,
and its backward.

Counterpart of ``repro.kernels.embedding_bag.kernel.embedding_bag_pallas``:
table (N, D) float32 x ids (B, L) int32 -> (B, D) float32, an id < 0 is
padding and mean divides by max(count, 1). ``embedding_bag_cuda`` launches
the hand-written Hopper kernel in ``csrc/embedding_bag.cu`` (built by
``nvcc`` at first use) on CUDA tensors and raises if the build or the
launch fails; any B is accepted. ``embedding_bag_backward_cuda`` launches
``csrc/embedding_bag_backward.cu``, the table's gradient summed in (b, i)
order (the reference has no backward kernel: it differentiates its XLA
bag). ``ops.embedding_bag`` is the entry point for both.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.fake import is_fake, nbytes, note, recording

__all__ = ["embedding_bag_cuda", "embedding_bag_backward_cuda", "backward_runs",
           "launch_backward", "LAUNCHES", "reset_launch_counts", "vector_width"]

SOURCE = "embedding_bag.cu"
BACKWARD_SOURCE = "embedding_bag_backward.cu"

# kernel launches per mode: 'sum', 'mean' (forward), 'sum_backward',
# 'mean_backward'; incremented only where a CUDA kernel is launched
LAUNCHES: dict = {}


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def vector_width(table: torch.Tensor, out: torch.Tensor) -> int:
    """Floats per load: 4 or 2 where D and both base addresses allow it (a
    row starts at id * D * 4 B), else 1. D = 18 gives 2."""
    d = table.shape[1]
    for vec in (4, 2):
        if d % vec == 0 and table.data_ptr() % (4 * vec) == 0 and out.data_ptr() % (4 * vec) == 0:
            return vec
    return 1


def embedding_bag_cuda(table: torch.Tensor, ids: torch.Tensor, mode: str) -> torch.Tensor:
    """Launch the kernel on checked CUDA operands (see ``ops.embedding_bag``)."""
    from repro_torch.kernels.build import KernelLaunchError, load_library

    b, length = ids.shape
    d = table.shape[1]
    out = torch.empty((b, d), dtype=table.dtype, device=table.device)
    if b == 0 or d == 0:
        return out  # nothing to launch
    # an add a (bag, slot, column); mean divides each output once; a row
    # read an id slot (at most the table)
    if recording():
        note("embedding_bag", b * length * d + (b * d if mode == "mean" else 0),
             min(b * length * d * 4, nbytes(table)) + nbytes(ids, out))
    if is_fake(table):  # the output rule: a dry run's trace
        return out
    lib, _ = load_library(SOURCE)
    fn = lib.embedding_bag_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(table.device):  # the launch goes to the current device
        err = fn(table.data_ptr(), ids.data_ptr(), out.data_ptr(), b, length, d,
                 vector_width(table, out), int(mode == "mean"),
                 torch.cuda.current_stream(table.device).cuda_stream)
    if err != 0:
        raise KernelLaunchError(f"embedding_bag launch failed: CUDA error {err}")
    LAUNCHES[mode] = LAUNCHES.get(mode, 0) + 1
    return out


def backward_runs(ids: torch.Tensor, num_rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(order, start): the positions b * L + i of the flattened ids, stably
    sorted by id, so each row's occurrences lie together in (b, i) order; and
    the (num_rows + 1) run starts, row n's run being [start[n], start[n + 1]).
    Padding (< 0) sorts first and lies in no run."""
    flat = ids.reshape(-1)
    keys, order = torch.sort(flat, stable=True)
    start = torch.searchsorted(keys, torch.arange(num_rows + 1, dtype=flat.dtype,
                                                  device=flat.device))
    return order, start


def embedding_bag_backward_cuda(grad_out: torch.Tensor, ids: torch.Tensor, num_rows: int,
                                mode: str) -> torch.Tensor:
    """The table's (num_rows, D) float32 gradient of ``embedding_bag_cuda``
    from the bags' gradient ``grad_out`` (B, D) float32 (contiguous, on the
    ids' card): for each row, the terms of every (b, i) naming it, in (b, i)
    order from +0 (``ref.embedding_bag_backward_reference``)."""
    b, length = ids.shape
    if grad_out.dtype != torch.float32 or grad_out.dim() != 2 or grad_out.shape[0] != b:
        raise ValueError(f"grad_out must be ({b}, D) float32, got {tuple(grad_out.shape)} "
                         f"{grad_out.dtype}")
    if not (grad_out.is_contiguous() and ids.is_contiguous()) or ids.dtype != torch.int32:
        raise ValueError("kernel operands must be contiguous, the ids int32")
    if b * length >= 1 << 31:
        raise ValueError(f"B * L = {b * length} ids: the kernel indexes them in 32 bits")
    if num_rows == 0 or grad_out.shape[1] == 0:  # nothing to launch
        return torch.empty((num_rows, grad_out.shape[1]), dtype=torch.float32,
                           device=grad_out.device)
    order, start = backward_runs(ids, num_rows)
    counts = (ids >= 0).sum(dim=1, dtype=torch.int32) if mode == "mean" else None
    return launch_backward(grad_out, order, start, counts, length, mode)


def launch_backward(grad_out: torch.Tensor, order: torch.Tensor, start: torch.Tensor,
                    counts: torch.Tensor | None, length: int, mode: str) -> torch.Tensor:
    """The backward kernel alone on ``backward_runs``' (order, start) and, for
    mean, the (B,) int32 counts of real ids a bag: -> (len(start) - 1, D)."""
    from repro_torch.kernels.build import KernelLaunchError, load_library

    num_rows, d = start.shape[0] - 1, grad_out.shape[1]
    grad = torch.empty((num_rows, d), dtype=torch.float32, device=grad_out.device)
    if recording():
        note("embedding_bag_backward", order.numel() * d,
             nbytes(grad_out, order, start, counts, grad))
    if is_fake(grad_out):  # the output rule: a dry run's trace
        return grad
    lib, _ = load_library(BACKWARD_SOURCE)
    fn = lib.embedding_bag_backward_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(grad_out.device):
        err = fn(grad_out.data_ptr(), order.data_ptr(), start.data_ptr(),
                 counts.data_ptr() if counts is not None else None, grad.data_ptr(),
                 num_rows, length, d, int(mode == "mean"),
                 torch.cuda.current_stream(grad_out.device).cuda_stream)
    if err != 0:
        raise KernelLaunchError(f"embedding_bag backward launch failed: CUDA error {err}")
    key = f"{mode}_backward"
    LAUNCHES[key] = LAUNCHES.get(key, 0) + 1
    return grad
