"""Rolling live metrics, the port's copy of ``repro/observability/rolling.py``:
streaming P² quantiles, an EWMA, window samples, and ``latency_dist``.

End-of-run aggregates (``EngineMetrics.report()``) say how a run went; this
module says how it is going:

* ``P2Quantile`` — the P² algorithm (Jain & Chlamtac 1985): one streaming
  quantile estimate in O(1) memory (5 markers), no sample buffer;
* ``EwmaMeanVar`` — exponentially weighted mean and variance;
* ``RollingMetrics`` — the live window: P² estimators for TTFT/TPOT, a
  bounded window over per-tick occupancy and queue depth, and counter-delta
  rates between samples. ``sample()`` returns one flat dict row; the
  Scheduler takes one every ``metrics_every`` ticks.

``latency_dist`` (mean/p50/p95/max of a closed sample) is shared with
``serving/metrics.py``.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional

import numpy as np

__all__ = [
    "EwmaMeanVar",
    "P2Quantile",
    "RollingMetrics",
    "latency_dist",
]


def latency_dist(values: List[float]) -> Dict[str, float]:
    """mean/p50/p95/max summary of a latency sample (shared with benchmarks)."""
    if not values:
        return {"mean": 0.0, "p50": 0.0, "p95": 0.0, "max": 0.0}
    a = np.asarray(values, dtype=np.float64)
    return {
        "mean": float(a.mean()),
        "p50": float(np.percentile(a, 50)),
        "p95": float(np.percentile(a, 95)),
        "max": float(a.max()),
    }


class EwmaMeanVar:
    """Exponentially-weighted running mean and variance.

    ``alpha`` is the smoothing factor (weight of the newest observation).
    ``z(x)`` is the standardized score of a new observation against the
    CURRENT estimate — callers decide whether to ``add`` before or after
    reading it (``StepMonitor`` reads first: an outlier should not soften
    its own threshold).
    """

    def __init__(self, alpha: float = 0.1):
        if not 0.0 < alpha <= 1.0:
            raise ValueError("alpha must be in (0, 1]")
        self.alpha = alpha
        self.mean = 0.0
        self.var = 0.0
        self.n = 0

    def add(self, x: float) -> None:
        self.n += 1
        if self.n == 1:
            self.mean = x
            self.var = 0.0
            return
        a = self.alpha
        self.mean = (1 - a) * self.mean + a * x
        self.var = (1 - a) * self.var + a * (x - self.mean) ** 2

    def reseed(self, x: float) -> None:
        """Pin the estimate to ``x`` with zero variance (warmup steps)."""
        self.mean = x
        self.var = 0.0
        self.n += 1

    def z(self, x: float) -> float:
        return (x - self.mean) / max(self.var ** 0.5, 1e-6)

    @property
    def std(self) -> float:
        return self.var ** 0.5


class P2Quantile:
    """Streaming quantile estimate via the P² algorithm — O(1) memory.

    Five markers track (min, q/2, q, (1+q)/2, max); each observation shifts
    marker heights by a piecewise-parabolic update. Exact until the 5th
    observation (falls back to ``np.percentile`` of what it has).
    """

    def __init__(self, q: float):
        if not 0.0 < q < 1.0:
            raise ValueError("q must be in (0, 1)")
        self.q = q
        self._init: List[float] = []   # first five observations
        self.n_obs = 0
        # marker heights, positions, desired positions, desired increments
        self._h: Optional[np.ndarray] = None
        self._pos: Optional[np.ndarray] = None
        self._des: Optional[np.ndarray] = None
        self._inc: Optional[np.ndarray] = None

    def add(self, x: float) -> None:
        self.n_obs += 1
        if self._h is None:
            self._init.append(float(x))
            if len(self._init) == 5:
                q = self.q
                self._h = np.sort(np.asarray(self._init, dtype=np.float64))
                self._pos = np.arange(1.0, 6.0)
                self._des = np.asarray(
                    [1.0, 1 + 2 * q, 1 + 4 * q, 3 + 2 * q, 5.0]
                )
                self._inc = np.asarray([0.0, q / 2, q, (1 + q) / 2, 1.0])
            return
        h, pos = self._h, self._pos
        # find the cell, clamp endpoints
        if x < h[0]:
            h[0] = x
            k = 0
        elif x >= h[4]:
            h[4] = x
            k = 3
        else:
            k = int(np.searchsorted(h, x, side="right")) - 1
            k = min(max(k, 0), 3)
        pos[k + 1 :] += 1.0
        self._des += self._inc
        # adjust the three interior markers
        for i in (1, 2, 3):
            d = self._des[i] - pos[i]
            if (d >= 1.0 and pos[i + 1] - pos[i] > 1.0) or (
                d <= -1.0 and pos[i - 1] - pos[i] < -1.0
            ):
                s = 1.0 if d >= 0 else -1.0
                hp = self._parabolic(i, s)
                if h[i - 1] < hp < h[i + 1]:
                    h[i] = hp
                else:  # parabolic step would cross a neighbor: linear step
                    j = i + int(s)
                    h[i] += s * (h[j] - h[i]) / (pos[j] - pos[i])
                pos[i] += s

    def _parabolic(self, i: int, s: float) -> float:
        h, pos = self._h, self._pos
        return h[i] + s / (pos[i + 1] - pos[i - 1]) * (
            (pos[i] - pos[i - 1] + s) * (h[i + 1] - h[i]) / (pos[i + 1] - pos[i])
            + (pos[i + 1] - pos[i] - s) * (h[i] - h[i - 1]) / (pos[i] - pos[i - 1])
        )

    def value(self) -> float:
        """Current estimate (0.0 before any observation)."""
        if self._h is not None:
            return float(self._h[2])
        if not self._init:
            return 0.0
        return float(np.percentile(np.asarray(self._init), self.q * 100))


class RollingMetrics:
    """Live windowed view of a running engine.

    Fed by ``EngineMetrics`` (the optional ``rolling`` sink): latency
    observations stream into P² estimators, per-tick occupancy / queue depth
    into a bounded window, and monotone counters are snapshotted so
    ``sample(now)`` can report window *rates* (tokens and completions per
    second since the previous sample), not just lifetime means.
    """

    def __init__(self, window: int = 256):
        if window < 1:
            raise ValueError("window must be >= 1")
        self.window = window
        self.ttft_p50 = P2Quantile(0.50)
        self.ttft_p95 = P2Quantile(0.95)
        self.tpot_p50 = P2Quantile(0.50)
        self.tpot_p95 = P2Quantile(0.95)
        self.occupancy: deque = deque(maxlen=window)
        self.queue_depth: deque = deque(maxlen=window)
        self.tick_time = EwmaMeanVar(alpha=0.1)
        # monotone totals (mirrors of EngineMetrics counters)
        self.emitted_tokens = 0
        self.completed = 0
        self.completed_tokens = 0
        self.ticks = 0
        # previous sample's snapshot, for window rates
        self._last = {
            "t": 0.0,
            "emitted_tokens": 0,
            "completed": 0,
            "completed_tokens": 0,
            "ticks": 0,
        }
        self.samples = 0

    # -- feed (EngineMetrics sink protocol) ----------------------------------

    def observe_ttft(self, seconds: float) -> None:
        self.ttft_p50.add(seconds)
        self.ttft_p95.add(seconds)

    def observe_tpot(self, seconds: float) -> None:
        self.tpot_p50.add(seconds)
        self.tpot_p95.add(seconds)

    def on_token(self) -> None:
        self.emitted_tokens += 1

    def on_finish(self, new_tokens: int) -> None:
        self.completed += 1
        self.completed_tokens += new_tokens

    def on_tick(self, occupancy: float, queue_depth: int) -> None:
        self.ticks += 1
        self.occupancy.append(occupancy)
        self.queue_depth.append(queue_depth)

    def observe_tick_time(self, seconds: float) -> None:
        self.tick_time.add(seconds)

    # -- sample --------------------------------------------------------------

    def sample(self, now: float) -> Dict[str, float]:
        """One JSONL row: instantaneous window rates + streaming quantiles.

        ``now`` is engine-clock seconds (the scheduler's ``_now()``).
        """
        dt = now - self._last["t"]

        def rate(key: str) -> float:
            return (getattr(self, key) - self._last[key]) / dt if dt > 0 else 0.0

        row = {
            "t": now,
            "ticks": self.ticks,
            "emitted_tokens": self.emitted_tokens,
            "completed": self.completed,
            "emitted_tok_s": rate("emitted_tokens"),
            "goodput_tok_s": rate("completed_tokens"),
            "completed_req_s": rate("completed"),
            "tick_s": rate("ticks"),
            "occupancy": float(np.mean(self.occupancy)) if self.occupancy else 0.0,
            "queue_depth": float(np.mean(self.queue_depth))
            if self.queue_depth
            else 0.0,
            "ttft_p50_s": self.ttft_p50.value(),
            "ttft_p95_s": self.ttft_p95.value(),
            "tpot_p50_s": self.tpot_p50.value(),
            "tpot_p95_s": self.tpot_p95.value(),
            "tick_time_mean_s": self.tick_time.mean,
        }
        self._last = {
            "t": now,
            "emitted_tokens": self.emitted_tokens,
            "completed": self.completed,
            "completed_tokens": self.completed_tokens,
            "ticks": self.ticks,
        }
        self.samples += 1
        return row
