"""The fixed-order segment sum on the card.

No TPU kernel is replaced: the reference's segment sums are
``jax.ops.segment_sum`` and the gradients XLA takes of ``jnp.take``, which
add in a fixed order on a TPU, where the port's ``index_add_`` adds with
atomics in an order that changes from run to run. A layout
(``ops.SegmentLayout``) gives the runs: run s is the sorted positions
[start[s], start[s + 1]), row ``order[p]`` of x at position p (``order``
None: row p). One fold is

    out[k] = sum of x[order[p]] for p in [starts[k], starts[k + 1]),
             in ascending p, from +0.0, in float32 (float64 for float64)

and a segment sum folds in the tree of ``CHUNK``: a run of more than
``CHUNK`` rows is folded in chunks of ``CHUNK`` from its start, the chunk
sums again in chunks, until at most ``CHUNK`` are left, folded last; the
levels before the last stay in float32 (float64 for float64).

``segment_sum_rows`` is one launch of the hand-written Hopper kernel in
``csrc/segment_sum.cu`` (built by ``nvcc`` at first use) on CUDA tensors,
which computes the whole tree of every run from the layout's (order,
start, marks) alone and raises if the build or the launch fails; on CPU tensors ``sum_levels``
folds the tree's levels (``ops.tree_levels``, found on the host) one at a
time with ``fold_runs_plain``, the plain PyTorch version, in the same
order, bit for bit, and the kernel is checked against it on the card.
``fold_runs`` is one fold of runs of any length, each walked whole: the
embedding bag's backward.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.fake import is_fake, segment_sum_rule

__all__ = ["CHUNK", "MARK", "segment_sum_rows", "sum_levels", "fold_runs", "fold_runs_plain",
           "run_marks", "vector_width", "copy_width", "LAUNCHES", "reset_launch_counts"]

SOURCE = "segment_sum.cu"
CHUNK = 256  # the most rows one fold of the tree adds (the kernel's kChunk)
_KERNEL_CHUNK = 256

# kernel launches (one a sum) by the sum's type, 'f32' or 'bf16';
# incremented only where the CUDA kernel is launched
LAUNCHES: dict = {}

_KERNEL_TYPES = (torch.float32, torch.bfloat16)

# (device index, stream) -> int32 ticket counters of the long runs' tree
# (``ticket_rows`` rows of d / vec lanes); the kernel's last arrival at each
# puts it back to 0, so they stay zero between launches on a stream
_TICKETS: dict = {}
TICKET_LEVELS = 3  # a tree of < 2^31 positions has at most 3 levels of groups
MARK = 64  # the layout marks the run of every MARK-th position (the kernel's kMark)


def ticket_rows(n_ctiles: int) -> int:
    """Ticket rows for ``n_ctiles`` 256-position tiles: a level's groups of
    CHUNK values each on two rows a tile of CHUNK^level (the kernel's
    ``tbase``)."""
    return sum(2 * ((n_ctiles - 1) // _KERNEL_CHUNK ** lv + 1)
               for lv in range(TICKET_LEVELS)) if n_ctiles else 0


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
    """Elements a load: 8 (bfloat16), 4 or 2 where d and both base
    addresses allow it (16 B at most), else 1. d = 18 float32 gives 2."""
    d = x.shape[1]
    for vec in ((8, 4, 2) if x.element_size() == 2 else (4, 2)):
        if d % vec == 0 and x.data_ptr() % (vec * x.element_size()) == 0 and \
                out.data_ptr() % (vec * out.element_size()) == 0:
            return vec
    return 1


def copy_width(x: torch.Tensor) -> int:
    """Bytes a staging copy: the largest of 16, 8, 4 and 2 dividing a row's
    bytes and x's base address (cp.async takes 16, 8 or 4)."""
    row = x.shape[1] * x.element_size()
    for g in (16, 8, 4):
        if row % g == 0 and x.data_ptr() % g == 0:
            return g
    return 2


def _tickets(device: torch.device, stream, n: int) -> torch.Tensor:
    key = (device.index, stream.cuda_stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _TICKETS[key] = t
    return t


def run_marks(start: torch.Tensor, n_pos: int) -> torch.Tensor:
    """The run holding every ``MARK``-th position of the runs ``start``
    (-1 before the first run, ``len(start) - 1`` past the last), on
    ``start``'s device, with no host read: what ``ops.segment_layout`` keeps
    from its sort, for a layout built without it."""
    pos = torch.arange(0, n_pos, MARK, dtype=start.dtype, device=start.device)
    return torch.searchsorted(start, pos, right=True) - 1


def _check(x, order, starts, marks=None):
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.shape[0] >= 2 ** 31:
        raise ValueError(f"the kernel indexes fewer than 2^31 rows, got {x.shape[0]}")
    for name, t in (("order", order), ("starts", starts), ("marks", marks)):
        if t is not None and (t.dtype != torch.int64 or t.device != x.device
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous int64 on {x.device}")
    if CHUNK != _KERNEL_CHUNK:
        raise ValueError(f"the kernel's chunk is {_KERNEL_CHUNK} rows, CHUNK is {CHUNK}")


def _launch(x, order, starts, marks=None, div: int = 1):
    """One launch: (len(starts) - 1, d) in x's type. ``marks``: the run of
    every ``MARK``-th position where a run may exceed ``CHUNK`` rows (the
    tree's tile part, its scratch and counters), else None: every run folded
    whole."""
    from repro_torch.kernels.build import KernelLaunchError, load_library

    k, d = starts.shape[0] - 1, x.shape[1]
    out = torch.empty((k, d), dtype=x.dtype, device=x.device)
    if k == 0 or d == 0:
        return out
    if order is None:  # the rows are already in run order
        order = torch.arange(x.shape[0], device=x.device)
    n_pos = order.shape[0]
    vec = vector_width(x, out)
    if n_pos >= 2 ** 31 - 1 or k * (d // vec) >= 2 ** 31 - 1:
        raise ValueError(f"the kernel takes fewer than 2^31 positions and run lanes, got "
                         f"{n_pos} positions, {k} runs of {d // vec} column vectors")
    n_ctiles = -(-n_pos // CHUNK) if marks is not None and n_pos > CHUNK else 0
    stream = torch.cuda.current_stream(x.device)
    scratch = tickets = None
    if n_ctiles:
        scratch = torch.empty((2 * n_ctiles, d), dtype=torch.float32, device=x.device)
        tickets = _tickets(x.device, stream, ticket_rows(n_ctiles) * (d // vec))
    lib, _ = load_library(SOURCE)
    fn = lib.segment_sum_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 4 \
        + [ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):  # the launch goes to the current device
        err = fn(x.data_ptr(), order.data_ptr(), starts.data_ptr(),
                 marks.data_ptr() if n_ctiles else None, out.data_ptr(),
                 scratch.data_ptr() if n_ctiles else None,
                 tickets.data_ptr() if n_ctiles else None,
                 k, n_pos, marks.shape[0] if n_ctiles else 0, div, d,
                 int(x.dtype == torch.bfloat16), vec, copy_width(x), n_ctiles,
                 stream.cuda_stream)
    if err != 0:
        raise KernelLaunchError(f"segment_sum launch failed: CUDA error {err}")
    key = "bf16" if x.dtype == torch.bfloat16 else "f32"
    LAUNCHES[key] = LAUNCHES.get(key, 0) + 1
    return out


def fold_runs(x: torch.Tensor, order, starts: torch.Tensor, out_dtype: torch.dtype,
              div: int = 1) -> torch.Tensor:
    """One fold of runs of any length, each walked whole in order (the
    embedding bag's backward), row ``order[p] // div`` at position p: the
    kernel on CUDA tensors (float32 in and out), the plain version on CPU
    tensors."""
    if x.device.type == "cuda":
        if x.dtype != torch.float32 or out_dtype != torch.float32:
            raise ValueError(f"the kernel walks float32 runs, got {x.dtype} -> {out_dtype}")
        _check(x, order, starts)
        return _launch(x, order, starts, div=div)
    if x.device.type == "cpu":
        rows = order if order is None or div == 1 else order // div
        return fold_runs_plain(x, rows, starts, out_dtype)
    raise ValueError(f"unsupported device {x.device}")


def segment_sum_rows(x: torch.Tensor, seg: torch.Tensor, layout,
                     num_segments: int) -> torch.Tensor:
    """x (E, d) -> (num_segments, d) in x's type, in the tree order of
    ``layout`` (``ops.SegmentLayout`` of ``seg``, on x's device; None only
    for a fake x): on CUDA tensors (float32 or bf16) one kernel launch, on
    CPU tensors the tree's levels by ``fold_runs_plain``. A fake x (a dry
    run's trace) takes the output rule, ``fake.segment_sum_rule``, and no
    kernel work is noted: the trace counts the ``index_add`` this stands in
    for."""
    if is_fake(x):
        return segment_sum_rule(x, seg, num_segments)
    if x.device.type == "cuda":
        if x.dtype not in _KERNEL_TYPES:
            raise ValueError(f"the kernel sums float32 or bfloat16, got {x.dtype}")
        marks = None
        if layout.max_run is None or layout.max_run > CHUNK:  # a run may exceed CHUNK
            n_pos = layout.num_rows if layout.order is None else layout.order.shape[0]
            marks = layout.marks if layout.marks is not None else run_marks(layout.start, n_pos)
        _check(x, layout.order, layout.start, marks)
        return _launch(x, layout.order, layout.start, marks)
    if x.device.type == "cpu":
        return sum_levels(x, layout, fold_runs_plain)
    raise ValueError(f"unsupported device {x.device}")


def sum_levels(x: torch.Tensor, layout, fold) -> torch.Tensor:
    """x (E, d) through each level of ``layout``'s tree (``layout.levels``)
    by ``fold`` (``fold_runs_plain``): the order through the first level,
    the levels before the last kept in float32 (float64 for float64)."""
    y = x
    for i, starts in enumerate(layout.levels):
        last = i == len(layout.levels) - 1
        y = fold(y, layout.order if i == 0 else None, starts,
                 x.dtype if last else _acc_dtype(x.dtype))
    return y
