"""Slot pool, the port's copy of ``repro/serving/slots.py``: the decode
cache plus per-lane stream metadata.

A slot is one batch lane of the persistent, fixed-shape decode step. Its
lifecycle::

    FREE ──admit──► PREFILLING ──prompt consumed──► DECODING ──finish/cancel──►
    DRAINING ──recycle (next tick)──► FREE

``SlotPool`` owns the cache tree (stacked ``(L, B, ...)`` leaves, batch at
axis 1 — see the per-slot ops in ``models/rnn.py``) and the host-side
``Slot`` records. All cache mutation goes through the lane-masked steps the
Scheduler holds, which write the pool's buffers in place; the pool only tracks which lane is in which state, so
occupancy accounting and lane selection never touch the device.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional

from repro_torch.serving.queue import Request


class SlotState(enum.Enum):
    FREE = "free"              # no stream; cache bits are stale garbage
    PREFILLING = "prefilling"  # consuming its prompt (chunks, then the tail)
    DECODING = "decoding"      # autoregressive, one token per tick
    DRAINING = "draining"      # finished/evicted this tick; recycled next tick


@dataclass
class SpecLane:
    """Speculative-decode bookkeeping for one lane (``Scheduler`` spec mode).

    ``queue`` holds committed-but-unconsumed tokens: tokens already emitted to
    the stream (greedy-exact, so committed) that neither the target nor the
    draft lane state has consumed yet. The invariant the engine maintains is

        lane cache state == committed stream minus ``queue``

    for BOTH models. Each verify block replays ``queue`` in its first ``r =
    len(queue)`` positions and fills the rest with draft proposals; a fully
    accepted block keeps the advanced state (queue collapses to the one new
    bonus token), a partial accept restores the pre-block snapshot and appends
    the newly committed emissions to ``queue`` (``r`` never exceeds the block
    size k, since a partial accept emits at most ``k - r`` draft matches plus
    one). While DECODING, ``1 <= len(queue) <= k`` always holds.
    """

    queue: List[int] = field(default_factory=list)


@dataclass
class Slot:
    lane: int
    state: SlotState = SlotState.FREE
    req: Optional[Request] = None
    pos: int = 0               # prompt tokens consumed so far
    last_token: int = -1       # last emitted token (decode input next tick)
    pending: int = 0           # emissions dispatched to device, not yet retired
    fb_src: int = 0            # where next decode input lives (engine SRC_*)
    spec: Optional[SpecLane] = None  # speculative state; None = plain decode

    @property
    def busy(self) -> bool:
        return self.state in (SlotState.PREFILLING, SlotState.DECODING)

    @property
    def prompt_remaining(self) -> int:
        return 0 if self.req is None else self.req.prompt_len - self.pos

    def assign(self, req: Request) -> None:
        assert self.state is SlotState.FREE, (self.lane, self.state)
        self.req = req
        self.state = SlotState.PREFILLING
        self.pos = 0
        self.last_token = -1
        self.pending = 0
        self.fb_src = 0
        self.spec = None

    def release(self) -> None:
        assert self.state is SlotState.DRAINING, (self.lane, self.state)
        self.req = None
        self.state = SlotState.FREE
        self.pos = 0
        self.last_token = -1
        self.pending = 0
        self.fb_src = 0
        self.spec = None


class SlotPool:
    """Owns the cache pytree and the B lane records."""

    def __init__(self, caches, batch: int):
        self.caches = caches
        self.batch = batch
        self.slots: List[Slot] = [Slot(lane) for lane in range(batch)]

    def __iter__(self):
        return iter(self.slots)

    def free_lanes(self) -> List[int]:
        return [s.lane for s in self.slots if s.state is SlotState.FREE]

    def lanes_in(self, state: SlotState) -> List[Slot]:
        return [s for s in self.slots if s.state is state]

    def busy_count(self) -> int:
        return sum(1 for s in self.slots if s.busy)

    def occupancy(self) -> float:
        return self.busy_count() / self.batch

    def find(self, rid: int) -> Optional[Slot]:
        for s in self.slots:
            if s.req is not None and s.req.rid == rid:
                return s
        return None

    def recycle(self) -> List[int]:
        """Return DRAINING lanes to FREE (start-of-tick lane reclamation)."""
        lanes = []
        for s in self.slots:
            if s.state is SlotState.DRAINING:
                s.release()
                lanes.append(s.lane)
        return lanes
