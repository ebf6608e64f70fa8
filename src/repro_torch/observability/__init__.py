"""Serving telemetry, the part of ``repro/observability/`` the serving engine
needs: the tick trace (``trace.py``), the rolling live metrics
(``rolling.py``), and the ``Telemetry`` bundle the Scheduler holds.

Off by default: the default bundle is all no-ops (the shared ``NULL_TRACE``,
no rolling window, no writer, a null annotation), so disabled telemetry
costs a few no-op calls a tick and no device sync. The profiler
annotations, the exporters, the step monitor and the serve flags that turn
them on come with a later slice (ROADMAP §A4); until then ``annotate`` is
the null annotation.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Callable, ContextManager, Optional

from repro_torch.observability.rolling import (
    EwmaMeanVar,
    P2Quantile,
    RollingMetrics,
    latency_dist,
)
from repro_torch.observability.trace import NULL_TRACE, NullTrace, Span, TraceRecorder, make_trace

__all__ = [
    "EwmaMeanVar",
    "NULL_TELEMETRY",
    "NULL_TRACE",
    "NullTrace",
    "P2Quantile",
    "RollingMetrics",
    "Span",
    "Telemetry",
    "TraceRecorder",
    "latency_dist",
    "make_trace",
    "null_annotation",
]

_NULL_CTX = contextlib.nullcontext()


def null_annotation(name: str) -> ContextManager:
    """The off switch of step annotations: one shared, reusable null context."""
    return _NULL_CTX


@dataclass
class Telemetry:
    """One engine's telemetry sinks; the default instance is all off.

    * ``trace``          — span recorder (``NULL_TRACE`` when off);
    * ``rolling``        — live windowed metrics, sampled every
      ``metrics_every`` ticks (0 disables sampling even if present);
    * ``metrics_writer`` — a sink with ``write(row)`` for the sampled rows;
    * ``annotate``       — a context factory wrapped around each step's
      dispatch, named by phase.
    """

    trace: NullTrace = field(default_factory=lambda: NULL_TRACE)
    rolling: Optional[RollingMetrics] = None
    metrics_every: int = 0
    metrics_writer: Optional[object] = None
    annotate: Callable[[str], ContextManager] = null_annotation


#: The all-off default the Scheduler falls back to.
NULL_TELEMETRY = Telemetry()
