"""Step-time monitoring and straggler detection, the port's copy of
``repro/runtime/monitor.py``.

At fleet scale a straggling host shows up as a step-time outlier (all hosts
block on the same collectives); at serving scale the same signature is a
tick-time outlier (GC pause, host contention, a noisy neighbor).
``StepMonitor`` keeps an EWMA/EWVar of step times and flags z-score
outliers; the driver's policy hook decides what to do. The EWMA arithmetic
itself lives in ``observability/rolling.py::EwmaMeanVar``, shared with the
serving telemetry layer, not a twin. It is host arithmetic only, so it gives
the JAX package's results bit for bit.

Consumers: the serving ``Scheduler`` feeds every tick's host time through
``observe`` when a monitor rides in its ``Telemetry`` bundle, and flagged
ticks become ``straggler`` instant events on the tick trace; the training
driver (ROADMAP §A5) wraps each optimizer step with ``start``/``stop``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

from repro_torch.observability.rolling import EwmaMeanVar


@dataclass
class StepMonitor:
    alpha: float = 0.1            # EWMA smoothing
    z_threshold: float = 4.0      # straggler flag
    warmup_steps: int = 5         # ignore compile/first-step jitter
    on_straggler: Optional[Callable[[int, float, float], None]] = None

    _t0: float = field(default=0.0)
    events: List[dict] = field(default_factory=list)

    def __post_init__(self):
        self._ewma = EwmaMeanVar(alpha=self.alpha)

    @property
    def _mean(self) -> float:  # kept for drivers reading the running mean
        return self._ewma.mean

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, step: int) -> dict:
        return self.observe(step, time.perf_counter() - self._t0)

    def observe(self, step: int, dt: float) -> dict:
        """Feed one already-measured duration (the serving scheduler times
        its own ticks and hands the number over)."""
        flagged = False
        z = 0.0
        if self._ewma.n < self.warmup_steps:
            self._ewma.reseed(dt)
        else:
            # score BEFORE updating: an outlier must not soften its own bar
            z = self._ewma.z(dt)
            flagged = z > self.z_threshold
            if flagged:
                self.events.append(
                    {"step": step, "dt": dt, "mean": self._ewma.mean, "z": z}
                )
                if self.on_straggler:
                    self.on_straggler(step, dt, z)
            self._ewma.add(dt)
        return {
            "step_time": dt,
            "straggler": flagged,
            "mean": self._ewma.mean,
            "z": z,
        }
