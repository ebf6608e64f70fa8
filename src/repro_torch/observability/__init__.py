"""Serving telemetry, the port's ``repro/observability/``: tick tracing,
rolling live metrics, exporters, the profiler seam, and the ``Telemetry``
bundle the Scheduler holds.

Off by default and without a device sync when off: the Scheduler always
holds a ``Telemetry`` object, but the default one is all no-ops (the shared
``NULL_TRACE``, no rolling window, no writer, no monitor, the null
annotation), so disabled telemetry costs a few no-op calls a tick. On, it
reads the host clock only: outputs are token-identical with telemetry on or
off (``tests/test_torch_observability.py``).

Modules:

* ``trace``    — bounded ring-buffer span recorder, Chrome trace-event JSON
  export (Perfetto; the span catalog of ``docs/observability.md`` holds for
  the port's traces as it is);
* ``rolling``  — streaming P² quantiles, the shared EWMA (``StepMonitor``
  delegates here), windowed live-metrics rows; home of ``latency_dist``;
* ``export``   — metrics JSONL writer and Prometheus text exposition;
* ``profiler`` — optional ``torch.profiler`` capture with phase-named
  ``record_function``/NVTX ranges on each step dispatch.

``Telemetry.from_flags`` builds the bundle from the serve flags
(``launch/serve.py --trace-out/--metrics-jsonl/--metrics-every/
--torch-profile``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, ContextManager, Optional

from repro_torch.observability.export import (
    MetricsJSONLWriter,
    prometheus_text,
    write_prometheus,
)
from repro_torch.observability.profiler import annotation, null_annotation, torch_profile
from repro_torch.observability.rolling import (
    EwmaMeanVar,
    P2Quantile,
    RollingMetrics,
    latency_dist,
)
from repro_torch.observability.trace import NULL_TRACE, NullTrace, Span, TraceRecorder, make_trace

__all__ = [
    "EwmaMeanVar",
    "MetricsJSONLWriter",
    "NULL_TELEMETRY",
    "NULL_TRACE",
    "NullTrace",
    "P2Quantile",
    "RollingMetrics",
    "Span",
    "Telemetry",
    "TraceRecorder",
    "annotation",
    "latency_dist",
    "make_trace",
    "null_annotation",
    "prometheus_text",
    "torch_profile",
    "write_prometheus",
]


@dataclass
class Telemetry:
    """One engine's telemetry sinks; the default instance is all off.

    * ``trace``          — span recorder (``NULL_TRACE`` when off);
    * ``rolling``        — live windowed metrics, sampled every
      ``metrics_every`` ticks (0 disables sampling even if present);
    * ``metrics_writer`` — JSONL sink for the sampled rows;
    * ``monitor``        — a ``runtime.monitor.StepMonitor``; every tick's
      host time feeds it, and flagged stragglers become ``straggler``
      instant events on the trace (duck-typed: ``observe(step, dt)``);
    * ``annotate``       — ``profiler.annotation`` while a profiler capture
      runs, else the shared null annotation.
    """

    trace: NullTrace = field(default_factory=lambda: NULL_TRACE)
    rolling: Optional[RollingMetrics] = None
    metrics_every: int = 0
    metrics_writer: Optional[MetricsJSONLWriter] = None
    monitor: Optional[object] = None
    annotate: Callable[[str], ContextManager] = null_annotation

    @property
    def enabled(self) -> bool:
        return (
            self.trace.enabled
            or self.rolling is not None
            or self.monitor is not None
        )

    @classmethod
    def from_flags(
        cls,
        *,
        trace_out: Optional[str] = None,
        metrics_jsonl: Optional[str] = None,
        metrics_every: int = 32,
        trace_capacity: int = 1 << 16,
        monitor: Optional[object] = None,
        profiling: bool = False,
        rolling_window: int = 256,
    ) -> "Telemetry":
        """Build from the serve flag values (None/0 = that sink off)."""
        wants_rolling = bool(metrics_jsonl) and metrics_every > 0
        return cls(
            trace=make_trace(bool(trace_out), capacity=trace_capacity),
            rolling=RollingMetrics(window=rolling_window) if wants_rolling else None,
            metrics_every=metrics_every if wants_rolling else 0,
            metrics_writer=(
                MetricsJSONLWriter(metrics_jsonl) if wants_rolling else None
            ),
            monitor=monitor,
            annotate=annotation if profiling else null_annotation,
        )

    def close(self) -> None:
        if self.metrics_writer is not None:
            self.metrics_writer.close()


#: The all-off default the Scheduler falls back to.
NULL_TELEMETRY = Telemetry()
