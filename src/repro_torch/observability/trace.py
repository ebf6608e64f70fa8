"""Bounded ring-buffer span recorder with Chrome trace-event export, the
port's copy of ``repro/observability/trace.py``.

The paper's whole claim is a *time* claim — MTS trades per-step latency for
DRAM-amortized throughput — so the serving engine needs to show where a
tick's milliseconds actually go, not just end-of-run aggregates. This module
is the recording half: ``TraceRecorder`` collects phase spans (``with
rec.span("decode"):``), instant events (``rec.instant("prefix_hit")``), and
per-request async lifecycle spans into one bounded ring buffer, and exports
them as Chrome trace-event JSON (load the file in https://ui.perfetto.dev or
``chrome://tracing``).

Design constraints, in order:

* **Zero-sync, near-zero-cost when off.** The scheduler holds a recorder
  unconditionally; when tracing is disabled it holds ``NULL_TRACE``, whose
  ``span``/``instant`` are constant no-ops (one shared, reusable null context
  manager — no clock reads, no allocation, no device syncs). Telemetry must
  never change what the engine computes, only observe when it computed it.
* **Bounded memory.** The buffer is a ``deque(maxlen=capacity)``; a
  long-lived engine overwrites its oldest spans instead of growing without
  bound. Export tells you how many events were dropped.
* **Host-time only.** Timestamps come from ``time.perf_counter`` (monotonic;
  RPL005 forbids ``time.time`` for durations) rebased to the recorder's own
  t=0, in microseconds — the unit the trace-event spec expects.

Event vocabulary:

* phase spans — ``ph: "X"`` complete events on a named track (``tid``), one
  per scheduler tick phase (``tick``/``recycle``/``admit``/``inject``/
  ``prefill``/``decode``/``draft``/``verify``/``snapshot``/``retire``/
  ``fetch``);
* instant events — ``ph: "i"`` (``prefix_hit``, ``spec_rollback``,
  ``backpressure``, ``straggler``, ...);
* async spans — ``ph: "b"``/``"n"``/``"e"`` with an ``id``: request
  lifecycles (``id`` = rid; begin at submit, instants at admit/first_token,
  end at finish) and per-tick in-flight windows (``id`` = tick serial; begin
  when the tick's work is dispatched, end when it retires). With
  ``async_depth`` = 2 the in-flight window of tick *t* overlaps tick *t+1*'s
  dispatch span — the double-buffering is literally visible as overlap
  between the ``inflight`` and ``tick`` tracks.

Counter events (``ph: "C"``) chart occupancy / queue depth over time on
their own track.
"""
from __future__ import annotations

import json
import time
from collections import deque
from typing import Dict, List

__all__ = ["NullTrace", "NULL_TRACE", "Span", "TraceRecorder"]

# One process-wide pid for the exported events: the engine is single-process;
# tracks are separated by tid (thread-name metadata below).
_PID = 1

#: Track (tid) numbering: stable order in the perfetto timeline.
TRACK_IDS: Dict[str, int] = {
    "tick": 1,       # per-tick phase spans (dispatch half + retire)
    "inflight": 2,   # async per-tick dispatched->retired windows
    "requests": 3,   # per-request lifecycle async spans
    "counters": 4,   # occupancy / queue-depth counters
    "engine": 5,     # engine-level one-offs (warmup, run) + stragglers
}


class Span:
    """Open phase span; closes (and records) on ``__exit__``.

    Extra payload can be attached while the span is open::

        with rec.span("fetch") as s:
            ...
            s.arg("arrays", n)
    """

    __slots__ = ("_rec", "name", "tid", "t0", "args")

    def __init__(self, rec: "TraceRecorder", name: str, tid: str, args):
        self._rec = rec
        self.name = name
        self.tid = tid
        self.t0 = 0.0
        self.args = dict(args) if args else None

    def arg(self, key: str, value) -> None:
        if self.args is None:
            self.args = {}
        self.args[key] = value

    def __enter__(self) -> "Span":
        self.t0 = self._rec._now_us()
        return self

    def __exit__(self, *exc) -> None:
        self._rec._complete(self)


class _NullSpan:
    """Shared no-op span: ``with NULL_TRACE.span(...) as s`` costs two call
    dispatches and nothing else (no clock read, no allocation)."""

    __slots__ = ()

    def arg(self, key: str, value) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL_SPAN = _NullSpan()


class NullTrace:
    """The off switch: same surface as ``TraceRecorder``, every method a
    constant no-op. ``enabled`` lets rare non-trivial payload construction
    be skipped entirely (``if trace.enabled: ...``)."""

    enabled = False

    def span(self, name: str, tid: str = "tick", **args) -> _NullSpan:
        return _NULL_SPAN

    def instant(self, name: str, tid: str = "tick", **args) -> None:
        pass

    def async_begin(self, cat: str, name: str, id: int, **args) -> None:
        pass

    def async_instant(self, cat: str, name: str, id: int, **args) -> None:
        pass

    def async_end(self, cat: str, name: str, id: int, **args) -> None:
        pass

    def counter(self, name: str, **values) -> None:
        pass

    def export(self, path: str) -> dict:
        raise RuntimeError("tracing is disabled (NULL_TRACE has no events)")


#: The module-wide disabled recorder (identity-comparable: ``trace is
#: NULL_TRACE``).
NULL_TRACE = NullTrace()


class TraceRecorder(NullTrace):
    """Bounded in-memory recorder of Chrome trace events.

    ``capacity`` bounds the ring buffer (events, not bytes; a phase-span
    event is ~6 small dict entries). ``clock`` is injectable for tests; it
    must be monotonic (``time.perf_counter``).
    """

    enabled = True

    def __init__(
        self,
        capacity: int = 1 << 16,
        clock=time.perf_counter,
    ):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._clock = clock
        self._t0 = clock()
        self._events: deque = deque(maxlen=capacity)
        self.dropped = 0  # events evicted by the ring bound

    # -- time ----------------------------------------------------------------

    def _now_us(self) -> float:
        return (self._clock() - self._t0) * 1e6

    # -- recording -----------------------------------------------------------

    def _push(self, ev: dict) -> None:
        if len(self._events) == self.capacity:
            self.dropped += 1
        self._events.append(ev)

    def _complete(self, span: Span) -> None:
        ev = {
            "name": span.name,
            "ph": "X",
            "ts": span.t0,
            "dur": self._now_us() - span.t0,
            "pid": _PID,
            "tid": TRACK_IDS.get(span.tid, hash(span.tid) % 1000 + 10),
        }
        if span.args:
            ev["args"] = span.args
        self._push(ev)

    def span(self, name: str, tid: str = "tick", **args) -> Span:
        return Span(self, name, tid, args)

    def instant(self, name: str, tid: str = "tick", **args) -> None:
        ev = {
            "name": name,
            "ph": "i",
            "s": "t",  # thread-scoped instant
            "ts": self._now_us(),
            "pid": _PID,
            "tid": TRACK_IDS.get(tid, hash(tid) % 1000 + 10),
        }
        if args:
            ev["args"] = args
        self._push(ev)

    def _async(self, ph: str, cat: str, name: str, id: int, args) -> None:
        ev = {
            "name": name,
            "cat": cat,
            "ph": ph,
            "id": int(id),
            "ts": self._now_us(),
            "pid": _PID,
            "tid": TRACK_IDS.get(cat, TRACK_IDS["requests"]),
        }
        if args:
            ev["args"] = args
        self._push(ev)

    def async_begin(self, cat: str, name: str, id: int, **args) -> None:
        self._async("b", cat, name, id, args)

    def async_instant(self, cat: str, name: str, id: int, **args) -> None:
        self._async("n", cat, name, id, args)

    def async_end(self, cat: str, name: str, id: int, **args) -> None:
        self._async("e", cat, name, id, args)

    def counter(self, name: str, **values) -> None:
        self._push(
            {
                "name": name,
                "ph": "C",
                "ts": self._now_us(),
                "pid": _PID,
                "tid": TRACK_IDS["counters"],
                "args": values,
            }
        )

    # -- export --------------------------------------------------------------

    def events(self) -> List[dict]:
        """The buffered events, oldest first (a copy)."""
        return list(self._events)

    def to_chrome(self) -> dict:
        """The trace as a Chrome trace-event JSON object (dict form)."""
        meta = [
            {
                "name": "process_name",
                "ph": "M",
                "pid": _PID,
                "args": {"name": "repro-serving"},
            }
        ] + [
            {
                "name": "thread_name",
                "ph": "M",
                "pid": _PID,
                "tid": tid,
                "args": {"name": track},
            }
            for track, tid in TRACK_IDS.items()
        ]
        return {
            "displayTimeUnit": "ms",
            "traceEvents": meta + self.events(),
            "otherData": {"dropped_events": self.dropped},
        }

    def export(self, path: str) -> dict:
        """Write the Chrome trace JSON to ``path``; returns the dict too."""
        doc = self.to_chrome()
        with open(path, "w") as f:
            json.dump(doc, f)
        return doc


def make_trace(enabled: bool, capacity: int = 1 << 16) -> NullTrace:
    """``TraceRecorder`` when enabled, the shared ``NULL_TRACE`` otherwise."""
    return TraceRecorder(capacity=capacity) if enabled else NULL_TRACE
