"""Preemption handling: SIGTERM -> checkpoint-and-exit. The port's copy of
``repro/runtime/preemption.py``.

Cloud TPU/TRN preemptions deliver SIGTERM with a grace window. The handler
flips a flag the train loop polls each step; the loop saves a final checkpoint
and exits 0 so the scheduler restarts cleanly (``--resume auto`` picks it up).
"""
from __future__ import annotations

import signal


class PreemptionHandler:
    def __init__(self, install: bool = True):
        self._requested = False
        self._prev = None
        if install:
            try:
                self._prev = signal.signal(signal.SIGTERM, self._handler)
            except ValueError:  # non-main thread (tests)
                self._prev = None

    def _handler(self, signum, frame):
        self._requested = True

    @property
    def requested(self) -> bool:
        return self._requested

    def trigger(self):  # for tests
        self._requested = True

    def uninstall(self):
        if self._prev is not None:
            signal.signal(signal.SIGTERM, self._prev)
