"""Straggler monitor of the training loop.

Counterpart of ``StepMonitor`` in ``repro.dist.fault_tolerance``, as the
trainer (``launch.train``) uses it. The checkpoint policy and the recovery
loop (``run_with_recovery``, with ``dist.checkpoint``) come with the
trainer's ``--ckpt``.
"""
from __future__ import annotations

import statistics
from typing import Any, Dict

__all__ = ["StepMonitor"]


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
