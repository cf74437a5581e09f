"""Preemption-safe training loop: checkpoint policy, retry and straggler
monitor.

Counterpart of ``repro.dist.fault_tolerance``. ``run_with_recovery`` is the
training loop's contract: a deterministic ``step_fn(state, i)`` (the data cursor a
pure function of ``i``, as the synthetic pipelines and
``data.pipeline.ShardedLoader`` guarantee) resumed from the newest complete
checkpoint (``dist.checkpoint``; a ``.tmp`` half-write never counts) ends in
the state an uninterrupted run reaches. A step that raises is retried with
the same ``(state, i)`` up to ``max_retries`` times, then the error is
raised. A device fault is never retried: a kernel's failed launch
(``kernels.build.KernelLaunchError``), a CUDA, cuBLAS or cuDNN error, or the
card running out of memory raises at once.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.dist.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.kernels.build import KernelLaunchError

__all__ = ["CheckpointPolicy", "StepMonitor", "run_with_recovery", "is_device_fault"]


@dataclasses.dataclass(frozen=True)
class CheckpointPolicy:
    directory: str
    every_steps: int = 100  # save after steps i with (i+1) % every == 0
    keep: int = 3  # newest checkpoints retained
    max_retries: int = 3  # per-step retries on a raised (transient) failure
    retry_backoff_s: float = 0.0


class StepMonitor:
    """Flags straggler steps: duration > deadline_factor * running median.
    The first ``min_history`` steps are never flagged (no baseline yet)."""

    def __init__(self, deadline_factor: float = 3.0, min_history: int = 3):
        self.deadline_factor = deadline_factor
        self.min_history = min_history
        self._durations: list = []
        self._stragglers = 0

    def record(self, step: int, duration_s: float) -> bool:
        flagged = False
        if len(self._durations) >= self.min_history:
            med = statistics.median(self._durations)
            flagged = duration_s > self.deadline_factor * med
        self._durations.append(duration_s)
        self._stragglers += int(flagged)
        return flagged

    def summary(self) -> Dict[str, Any]:
        return {
            "steps": len(self._durations),
            "stragglers": self._stragglers,
            "median_s": statistics.median(self._durations) if self._durations else 0.0,
        }


# the messages of a failure on the card that torch raises as a plain
# RuntimeError: a CUDA error, and cuBLAS's and cuDNN's status codes
_DEVICE_FAULT_MARKS = ("CUDA error", "CUBLAS_STATUS_", "CUDNN_STATUS_")


def is_device_fault(exc: BaseException) -> bool:
    """True for a failure of the card itself, which no retry may hide: a
    kernel's failed launch, a CUDA, cuBLAS or cuDNN error raised by torch
    (the context may be poisoned), or the card out of memory (the same step
    asks for the same memory again)."""
    if isinstance(exc, (KernelLaunchError, torch.cuda.OutOfMemoryError)):
        return True
    accelerator_error = getattr(torch, "AcceleratorError", None)
    if accelerator_error is not None and isinstance(exc, accelerator_error):
        return True
    return isinstance(exc, RuntimeError) and any(m in str(exc) for m in _DEVICE_FAULT_MARKS)


def run_with_recovery(
    step_fn: Callable[[Any, int], Tuple[Any, dict]],
    init_state: Callable[[], Any],
    total_steps: int,
    policy: CheckpointPolicy,
    monitor: Optional[StepMonitor] = None,
) -> Tuple[Any, dict]:
    """Run ``step_fn`` for steps [resume_point, total_steps).

    Resume: if ``policy.directory`` holds a checkpoint, restore it (template
    from ``init_state()``) and continue from its ``next_step``. Transient
    step failures retry up to ``policy.max_retries`` times with the SAME
    (state, i), which is safe because a failed step never committed its
    state; a device fault (``is_device_fault``) raises at once. Saves after
    step i when ``(i + 1) % policy.every_steps == 0``. Returns
    ``(final_state, last_metrics)``.
    """
    last = latest_step(policy.directory)
    if last is not None:
        state, meta = restore_checkpoint(policy.directory, init_state(), step=last)
        start = int(meta.get("next_step", last))
    else:
        state = init_state()
        start = 0
    metrics: dict = {}
    for i in range(start, total_steps):
        t0 = time.perf_counter()
        for attempt in range(policy.max_retries + 1):
            try:
                state, metrics = step_fn(state, i)
                break
            except Exception as exc:
                if attempt >= policy.max_retries or is_device_fault(exc):
                    raise
                if policy.retry_backoff_s:
                    time.sleep(policy.retry_backoff_s * (attempt + 1))
        if monitor is not None:
            monitor.record(i, time.perf_counter() - t0)
        if policy.every_steps and (i + 1) % policy.every_steps == 0:
            save_checkpoint(
                policy.directory,
                i + 1,
                state,
                meta={"next_step": i + 1},
                keep=policy.keep,
            )
    return state, metrics
