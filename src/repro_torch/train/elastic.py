"""Elastic resize and straggler mitigation hooks.

Counterpart of ``repro.train.elastic``: ``plan_remesh`` picks the largest
(data, model) mesh that the surviving ranks hold while keeping the model
axis, so that the restore (``train.checkpoint``, which reshards onto the
target placements) is a pure reshard; ``StragglerMonitor`` keeps a
per-step wall-time EWMA, and steps slower than ``factor`` times it are
counted and reported through a callback.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple


@dataclasses.dataclass
class StragglerMonitor:
    factor: float = 3.0
    alpha: float = 0.2
    ewma: Optional[float] = None
    slow_steps: int = 0
    on_straggler: Optional[Callable[[int, float, float], None]] = None

    def observe(self, step: int, seconds: float) -> bool:
        if self.ewma is None:
            self.ewma = seconds
            return False
        slow = seconds > self.factor * self.ewma
        if slow:
            self.slow_steps += 1
            if self.on_straggler is not None:
                self.on_straggler(step, seconds, self.ewma)
        # the EWMA excludes outliers, so one straggler does not mask the next
        if not slow:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * seconds
        return slow


def plan_remesh(n_devices: int, model_parallel: int) -> Tuple[int, int]:
    """Largest (data, model) grid for the surviving device count, keeping
    the model axis (the weights' layout) intact so restore is a pure
    reshard."""
    if n_devices < model_parallel:
        raise AssertionError((n_devices, model_parallel))
    return n_devices // model_parallel, model_parallel


def heartbeat(step: int, metrics, log_every: int = 10,
              emit: Callable[[str], None] = print):
    if step % log_every == 0:
        parts = [f"step={step}"]
        for k, v in metrics.items():
            try:
                parts.append(f"{k}={float(v):.5f}")
            except (TypeError, ValueError, RuntimeError):
                pass
        emit("  ".join(parts))
