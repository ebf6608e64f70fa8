"""Serving metrics, the port's copy of ``repro/serving/metrics.py``:
per-request latency, engine goodput, slot occupancy.

Everything is host-side bookkeeping on the engine clock — no device syncs
beyond the ones the scheduler already performs. ``EngineMetrics.report()``
returns the JAX package's plain-dict schema, plus ``busy_s`` (host seconds
inside ``Scheduler.tick``, idle waits for arrivals excluded):

* per-request: TTFT (arrival -> first emitted token, so queueing time counts)
  and TPOT (mean inter-token time after the first);
* engine: goodput (completed-request tokens per second — tokens of cancelled
  or still-resident streams don't count), emitted token rate, mean slot
  occupancy, queue depth, and tick/step counters that split scheduler work
  into prefill chunks vs decode steps;
* prefix cache: hits / misses / prompt tokens skipped via a cached state, plus
  ``prefill_lane_chunks`` (lane-level chunk count — the counter that makes
  tail-only prefill on a hit auditable) and ``fetch_wait_s``, host seconds
  blocked fetching device results (what the async tick pipeline shrinks);
* speculative decode: ``verify_steps`` / ``draft_steps`` (device step split),
  ``spec_cycles`` (lane-level draft->verify rounds), ``spec_proposed`` /
  ``spec_accepted`` draft tokens (their ratio is ``spec_acceptance_rate``),
  ``spec_emitted_tokens`` (tokens committed by verify blocks — only tokens a
  stream actually wanted; a finish landing mid-block counts the surplus in
  ``spec_discarded_tokens`` instead, so goodput and TPOT never see them),
  and ``spec_rollbacks`` (lane restores after a partial accept).

Live telemetry rides on the same hooks: ``EngineMetrics`` takes an optional
``trace`` (an ``observability.trace.TraceRecorder`` — request lifecycles
become async spans: begin at submit, instants at admit / first token, end at
finish/cancel; backpressure becomes an instant event; occupancy/queue depth
become counter tracks) and an optional ``rolling``
(``observability.rolling.RollingMetrics`` — TTFT/TPOT observations stream
into P² quantile estimators, counters into the live window the metrics JSONL
samples). Both default to off and cost nothing when off. ``latency_dist``
lives in ``observability/rolling.py`` now (one definition shared with the
benchmarks); the import below keeps this module's historical export.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from repro_torch.observability.rolling import RollingMetrics, latency_dist  # noqa: F401
from repro_torch.observability.trace import NULL_TRACE, NullTrace


@dataclass
class RequestTiming:
    rid: int
    arrival: float
    prompt_len: int
    max_new_tokens: int
    admitted: Optional[float] = None
    first_token: Optional[float] = None
    finished: Optional[float] = None
    new_tokens: int = 0
    cancelled: bool = False

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token is None:
            return None
        return self.first_token - self.arrival

    @property
    def tpot(self) -> Optional[float]:
        """Mean time per output token after the first."""
        if self.finished is None or self.first_token is None or self.new_tokens < 2:
            return None
        return (self.finished - self.first_token) / (self.new_tokens - 1)


class EngineMetrics:
    """Counters + per-request timings for one engine run.

    ``trace`` / ``rolling`` are the optional telemetry sinks described in the
    module docstring; both are no-ops when absent.
    """

    def __init__(
        self,
        batch: int,
        trace: Optional[NullTrace] = None,
        rolling: Optional[RollingMetrics] = None,
    ):
        self.batch = batch
        self.trace = trace if trace is not None else NULL_TRACE
        self.rolling = rolling
        self.requests: Dict[int, RequestTiming] = {}
        self.ticks = 0
        self.decode_steps = 0
        self.prefill_chunks = 0
        self.prefill_lane_chunks = 0
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_hit_tokens = 0
        self.fetch_wait_s = 0.0
        self.busy_s = 0.0
        self.admitted = 0
        self.completed = 0
        self.cancelled = 0
        self.backpressure_stalls = 0
        self.emitted_tokens = 0
        self.completed_tokens = 0
        self.verify_steps = 0
        self.draft_steps = 0
        self.spec_cycles = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_emitted_tokens = 0
        self.spec_discarded_tokens = 0
        self.spec_rollbacks = 0
        self.occupancy_samples: List[float] = []
        self.queue_depth_samples: List[int] = []
        self.started_at: Optional[float] = None
        self.stopped_at: Optional[float] = None

    # -- lifecycle hooks (called by the Scheduler) ---------------------------

    def start(self, now: float) -> None:
        if self.started_at is None:
            self.started_at = now

    def stop(self, now: float) -> None:
        self.stopped_at = now

    def on_submit(self, req) -> None:
        if req.rid in self.requests:
            return
        self.requests[req.rid] = RequestTiming(
            req.rid, req.arrival, req.prompt_len, req.max_new_tokens
        )
        self.trace.async_begin(
            "requests",
            "request",
            id=req.rid,
            prompt_len=req.prompt_len,
            max_new_tokens=req.max_new_tokens,
        )

    def on_backpressure(self) -> None:
        self.backpressure_stalls += 1
        self.trace.instant("backpressure", tid="engine")

    def on_admit(self, req, now: float) -> None:
        self.on_submit(req)
        self.requests[req.rid].admitted = now
        self.admitted += 1
        self.trace.async_instant("requests", "admit", id=req.rid)

    def on_token(self, req, now: float, first: bool) -> None:
        t = self.requests[req.rid]
        if first:
            t.first_token = now
            self.trace.async_instant("requests", "first_token", id=req.rid)
            if self.rolling is not None:
                self.rolling.observe_ttft(now - t.arrival)
        t.new_tokens += 1
        self.emitted_tokens += 1
        if self.rolling is not None:
            self.rolling.on_token()

    def on_finish(self, req, now: float) -> None:
        t = self.requests[req.rid]
        t.finished = now
        self.completed += 1
        self.completed_tokens += t.new_tokens
        self.trace.async_end("requests", "request", id=req.rid, tokens=t.new_tokens)
        if self.rolling is not None:
            self.rolling.on_finish(t.new_tokens)
            tpot = t.tpot
            if tpot is not None:
                self.rolling.observe_tpot(tpot)

    def on_cancel(self, req, now: float) -> None:
        t = self.requests[req.rid]
        t.finished = now
        t.cancelled = True
        self.cancelled += 1
        self.trace.async_end("requests", "request", id=req.rid, cancelled=True)

    def on_tick(self, occupancy: float, queue_depth: int) -> None:
        self.ticks += 1
        self.occupancy_samples.append(occupancy)
        self.queue_depth_samples.append(queue_depth)
        if self.rolling is not None:
            self.rolling.on_tick(occupancy, queue_depth)
        self.trace.counter(
            "engine_load", occupancy=occupancy, queue_depth=queue_depth
        )

    # -- reporting -----------------------------------------------------------

    @property
    def elapsed(self) -> float:
        if self.started_at is None:
            return 0.0
        end = self.stopped_at if self.stopped_at is not None else self.started_at
        return max(end - self.started_at, 0.0)

    def report(self) -> Dict:
        done = [t for t in self.requests.values() if t.finished and not t.cancelled]
        elapsed = self.elapsed
        return {
            "batch": self.batch,
            "elapsed_s": elapsed,
            "ticks": self.ticks,
            "decode_steps": self.decode_steps,
            "prefill_chunks": self.prefill_chunks,
            "prefill_lane_chunks": self.prefill_lane_chunks,
            "prefix_hits": self.prefix_hits,
            "prefix_misses": self.prefix_misses,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "fetch_wait_s": self.fetch_wait_s,
            "busy_s": self.busy_s,
            "admitted": self.admitted,
            "completed": self.completed,
            "cancelled": self.cancelled,
            "backpressure_stalls": self.backpressure_stalls,
            "emitted_tokens": self.emitted_tokens,
            "completed_tokens": self.completed_tokens,
            "verify_steps": self.verify_steps,
            "draft_steps": self.draft_steps,
            "spec_cycles": self.spec_cycles,
            "spec_proposed": self.spec_proposed,
            "spec_accepted": self.spec_accepted,
            "spec_emitted_tokens": self.spec_emitted_tokens,
            "spec_discarded_tokens": self.spec_discarded_tokens,
            "spec_rollbacks": self.spec_rollbacks,
            "spec_acceptance_rate": (
                self.spec_accepted / self.spec_proposed if self.spec_proposed else 0.0
            ),
            "accepted_tokens_per_cycle": (
                self.spec_emitted_tokens / self.spec_cycles if self.spec_cycles else 0.0
            ),
            "goodput_tok_s": self.completed_tokens / elapsed if elapsed else 0.0,
            "requests_per_s": self.completed / elapsed if elapsed else 0.0,
            "occupancy_mean": float(np.mean(self.occupancy_samples))
            if self.occupancy_samples
            else 0.0,
            "queue_depth_mean": float(np.mean(self.queue_depth_samples))
            if self.queue_depth_samples
            else 0.0,
            "ttft_s": latency_dist([t.ttft for t in done if t.ttft is not None]),
            "tpot_s": latency_dist([t.tpot for t in done if t.tpot is not None]),
        }
