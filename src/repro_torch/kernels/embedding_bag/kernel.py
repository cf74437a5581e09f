"""The embedding bag on the card: per bag, the sum or mean of table rows.

Counterpart of ``repro.kernels.embedding_bag.kernel.embedding_bag_pallas``:
table (N, D) float32 x ids (B, L) int32 -> (B, D) float32, an id < 0 is
padding and mean divides by max(count, 1). ``embedding_bag_cuda`` launches
the hand-written Hopper kernel in ``csrc/embedding_bag.cu`` (built by
``nvcc`` at first use) on CUDA tensors and raises if the build or the
launch fails; any B is accepted. ``ops.embedding_bag`` is the entry point.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["embedding_bag_cuda", "LAUNCHES", "reset_launch_counts", "vector_width"]

SOURCE = "embedding_bag.cu"

# kernel launches per mode ('sum', 'mean'); incremented only where the CUDA
# kernel is launched
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
    from repro_torch.kernels.build import load_library

    lib, _ = load_library(SOURCE)
    b, length = ids.shape
    d = table.shape[1]
    out = torch.empty((b, d), dtype=table.dtype, device=table.device)
    if b == 0 or d == 0:
        return out  # nothing to launch
    fn = lib.embedding_bag_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(table.device):  # the launch goes to the current device
        err = fn(table.data_ptr(), ids.data_ptr(), out.data_ptr(), b, length, d,
                 vector_width(table, out), int(mode == "mean"),
                 torch.cuda.current_stream(table.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"embedding_bag launch failed: CUDA error {err}")
    LAUNCHES[mode] = LAUNCHES.get(mode, 0) + 1
    return out
