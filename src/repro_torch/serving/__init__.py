"""Continuous-batching serving engine, from ``repro/serving/``.

Public surface:

* ``Request`` / ``RequestQueue`` — admission (bounded, arrival-ordered,
  backpressure on ``push``);
* ``SlotPool`` / ``Slot`` / ``SlotState`` — the cache-backed lane pool;
* ``Scheduler`` — the dispatch/retire tick loop multiplexing streams onto
  one set of fixed-shape steps (CUDA graphs on the card; ``async_depth``
  double-buffers ticks);
* ``PrefixCache`` — the prefix-sharing trie of snapshotted stack states;
* ``EngineMetrics`` — goodput / TTFT / TPOT / occupancy / prefix-hit stats;
* ``SpecLane`` — per-lane speculative-decode replay queue (kept with the
  slots; the speculative Scheduler comes with a later slice);
* ``poisson_trace`` / ``shared_prefix_trace`` / ``headline_poisson_trace`` /
  ``clone_trace`` — open-loop synthetic traffic.
"""
from repro_torch.serving.engine import Scheduler
from repro_torch.serving.metrics import EngineMetrics, RequestTiming
from repro_torch.serving.prefix_cache import PrefixCache, state_nbytes
from repro_torch.serving.queue import Request, RequestQueue
from repro_torch.serving.slots import Slot, SlotPool, SlotState, SpecLane
from repro_torch.serving.workload import (
    clone_trace,
    headline_poisson_trace,
    poisson_trace,
    shared_prefix_trace,
)

__all__ = [
    "Scheduler",
    "EngineMetrics",
    "RequestTiming",
    "PrefixCache",
    "state_nbytes",
    "Request",
    "RequestQueue",
    "Slot",
    "SlotPool",
    "SlotState",
    "SpecLane",
    "clone_trace",
    "headline_poisson_trace",
    "poisson_trace",
    "shared_prefix_trace",
]
