"""Straggler mitigation hooks.

Counterpart of ``repro.train.elastic``'s ``StragglerMonitor`` and
``heartbeat``: a per-step wall-time EWMA, and steps slower than
``factor`` times it counted and reported through a callback.  The
elastic resize (``plan_remesh``) comes with the distributed slice.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional


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
