"""Exporters, the port's copy of ``repro/observability/export.py``: the
metrics JSONL time series and the Prometheus text exposition.

Two sinks for the same numbers, different consumers:

* ``MetricsJSONLWriter`` — append-only JSON-lines time series. Each line is
  one ``RollingMetrics.sample()`` row (flat dict, schema in
  ``docs/observability.md``); a bench or notebook replays the file to plot
  goodput / TTFT *trajectories* instead of end-of-run scalars. Lines are
  flushed as written so a run killed mid-flight still leaves a valid file.
* ``prometheus_text`` — one scrape-shaped snapshot of an
  ``EngineMetrics.report()`` dict in the Prometheus text exposition format
  (v0.0.4): ``# HELP``/``# TYPE`` headers, ``repro_``-prefixed metric names,
  nested latency dists flattened to ``{quantile="..."}``-labelled summary
  samples. ``write_prometheus`` drops it in a file (node_exporter's textfile
  collector format).

The names, types, help lines and number format are the JAX package's, so
that for the same report dict the text is the same, byte for byte, and one
dashboard reads both. The port's report has one key more, ``busy_s`` (host
seconds inside ticks): like any key outside ``_METRIC_META`` it becomes a
gauge, ``repro_serving_busy_s``, with the generic help line.
"""
from __future__ import annotations

import json
from typing import Dict, Optional, TextIO

__all__ = ["MetricsJSONLWriter", "prometheus_text", "write_prometheus"]


class MetricsJSONLWriter:
    """Append one JSON object per line; flush per row; close idempotently."""

    def __init__(self, path: str):
        self.path = path
        self._f: Optional[TextIO] = open(path, "w")
        self.rows = 0

    def write(self, row: Dict) -> None:
        if self._f is None:
            raise ValueError(f"writer for {self.path} already closed")
        self._f.write(json.dumps(row) + "\n")
        self._f.flush()
        self.rows += 1

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self) -> "MetricsJSONLWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# metric name -> (type, help). Anything in the report not listed here is
# exported as an untyped gauge with a generic help line; latency dists are
# expanded to summaries below.
_METRIC_META = {
    "ticks": ("counter", "scheduler ticks executed"),
    "decode_steps": ("counter", "masked (B,1) decode steps dispatched"),
    "prefill_chunks": ("counter", "(B,chunk) prefill steps dispatched"),
    "prefill_lane_chunks": ("counter", "per-lane prompt chunks prefetched"),
    "prefix_hits": ("counter", "prefix-cache admission hits"),
    "prefix_misses": ("counter", "prefix-cache admission misses"),
    "prefix_hit_tokens": ("counter", "prompt tokens skipped via cached state"),
    "admitted": ("counter", "requests admitted to a lane"),
    "completed": ("counter", "requests finished"),
    "cancelled": ("counter", "requests cancelled/evicted"),
    "backpressure_stalls": ("counter", "submissions refused by a full queue"),
    "emitted_tokens": ("counter", "tokens emitted to streams"),
    "completed_tokens": ("counter", "tokens of completed requests"),
    "verify_steps": ("counter", "speculative (B,k) verify steps"),
    "draft_steps": ("counter", "draft (B,1) decode steps"),
    "spec_cycles": ("counter", "per-lane draft->verify cycles"),
    "spec_proposed": ("counter", "draft tokens proposed"),
    "spec_accepted": ("counter", "draft tokens accepted by verify"),
    "spec_emitted_tokens": ("counter", "tokens committed by verify blocks"),
    "spec_discarded_tokens": ("counter", "accepted tokens dropped mid-finish"),
    "spec_rollbacks": ("counter", "lane restores after partial accept"),
    "fetch_wait_s": ("counter", "host seconds blocked on device fetches"),
    "elapsed_s": ("gauge", "engine wall seconds"),
    "batch": ("gauge", "slot count"),
    "goodput_tok_s": ("gauge", "completed-request tokens per second"),
    "requests_per_s": ("gauge", "completed requests per second"),
    "occupancy_mean": ("gauge", "mean busy-lane fraction"),
    "queue_depth_mean": ("gauge", "mean admission-queue depth"),
    "spec_acceptance_rate": ("gauge", "accepted/proposed draft tokens"),
    "accepted_tokens_per_cycle": ("gauge", "emitted tokens per verify cycle"),
}

_DIST_KEYS = ("mean", "p50", "p95", "max")
_DIST_QUANTILE = {"p50": "0.5", "p95": "0.95"}


def _fmt(value) -> str:
    return repr(float(value))


def prometheus_text(report: Dict, prefix: str = "repro_serving_") -> str:
    """Render an ``EngineMetrics.report()`` dict as Prometheus exposition.

    Latency-dist sub-dicts (``{"mean","p50","p95","max"}``) become summary
    metrics: quantile-labelled samples plus ``_mean`` / ``_max`` gauges.
    Non-numeric values are skipped (the exposition format is numbers only).
    """
    lines = []
    for key in sorted(report):
        value = report[key]
        name = f"{prefix}{key}"
        if isinstance(value, dict) and set(value) >= set(_DIST_KEYS):
            lines.append(f"# HELP {name} latency distribution (seconds)")
            lines.append(f"# TYPE {name} summary")
            for pk, q in _DIST_QUANTILE.items():
                lines.append(f'{name}{{quantile="{q}"}} {_fmt(value[pk])}')
            lines.append(f"# HELP {name}_mean mean of {key}")
            lines.append(f"# TYPE {name}_mean gauge")
            lines.append(f"{name}_mean {_fmt(value['mean'])}")
            lines.append(f"# HELP {name}_max max of {key}")
            lines.append(f"# TYPE {name}_max gauge")
            lines.append(f"{name}_max {_fmt(value['max'])}")
            continue
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            continue
        kind, help_ = _METRIC_META.get(key, ("gauge", f"engine metric {key}"))
        # the exposition format wants _total-suffixed counters
        sample = f"{name}_total" if kind == "counter" else name
        lines.append(f"# HELP {sample} {help_}")
        lines.append(f"# TYPE {sample} {kind}")
        lines.append(f"{sample} {_fmt(value)}")
    return "\n".join(lines) + "\n"


def write_prometheus(path: str, report: Dict, prefix: str = "repro_serving_") -> str:
    text = prometheus_text(report, prefix=prefix)
    with open(path, "w") as f:
        f.write(text)
    return text
