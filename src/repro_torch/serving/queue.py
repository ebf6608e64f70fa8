"""Admission queue for the continuous-batching engine, the port's copy of
``repro/serving/queue.py``.

``Request`` is the unit of work: a token prompt, a generation budget, and an
arrival time (seconds on the engine's clock; simulated open-loop traces use
offsets from run start). ``RequestQueue`` is the bounded admission buffer:
arrival-time ordered pops, O(1) membership, and *backpressure* — ``push``
refuses (returns False) when the queue is at capacity instead of growing
without bound, so an overloaded engine sheds load at the front door rather
than accumulating unserveable latency.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class Request:
    """One stream: prompt in, up to ``max_new_tokens`` greedy tokens out.

    ``tokens`` fills in as the scheduler emits — callers can stream partial
    results off a live request; the engine also returns the request from the
    tick that completes it.
    """

    rid: int
    prompt: np.ndarray            # (P,) int32 token ids; P == 0 means "seed
    max_new_tokens: int           # with the engine's BOS policy and decode"
    arrival: float = 0.0          # seconds on the engine clock
    tokens: List[int] = field(default_factory=list)
    cancelled: bool = False
    # Per-stream speculative opt-out: None follows the engine default (draft
    # model loaded => speculate), False pins this stream to plain decode so
    # one batch can mix speculative and plain lanes. True on a plain engine
    # is ignored (there is no draft to propose with).
    speculative: Optional[bool] = None

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, dtype=np.int32)
        if self.prompt.ndim != 1:
            raise ValueError(f"request {self.rid}: prompt must be a (P,) vector")
        if self.max_new_tokens < 1:
            raise ValueError(f"request {self.rid}: max_new_tokens must be >= 1")

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.size)

    @property
    def done(self) -> bool:
        return self.cancelled or len(self.tokens) >= self.max_new_tokens


class RequestQueue:
    """Bounded, arrival-time-ordered admission queue.

    ``push`` returns False (backpressure) at capacity; ``pop`` returns the
    earliest-arrival request, breaking ties by submission order.
    """

    def __init__(self, capacity: int = 64):
        if capacity < 1:
            raise ValueError("queue capacity must be >= 1")
        self.capacity = capacity
        self._heap: List = []
        self._seq = itertools.count()

    def __len__(self) -> int:
        return len(self._heap)

    @property
    def full(self) -> bool:
        return len(self._heap) >= self.capacity

    def push(self, req: Request) -> bool:
        if self.full:
            return False
        heapq.heappush(self._heap, (req.arrival, next(self._seq), req))
        return True

    def pop(self) -> Optional[Request]:
        if not self._heap:
            return None
        return heapq.heappop(self._heap)[2]

    def remove(self, rid: int) -> Optional[Request]:
        """Withdraw a queued request by id (abandoned before admission)."""
        for i, (_, _, req) in enumerate(self._heap):
            if req.rid == rid:
                self._heap.pop(i)
                heapq.heapify(self._heap)
                return req
        return None
