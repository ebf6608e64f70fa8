"""Optional ``torch.profiler`` capture with named step annotations, the
port's form of ``repro/observability/profiler.py`` (``jax.profiler``).

The host-side tick trace (``observability/trace.py``) shows where the
scheduler's milliseconds go; the device timeline is the profiler's job. The
integration keeps the JAX package's two seams:

* ``torch_profile(dir, device)`` — context manager around a
  ``torch.profiler.profile`` session (host activity, plus the card's when
  ``device`` is a CUDA device) whose trace lands in ``dir`` through
  ``tensorboard_trace_handler``: a ``<worker>.<time>.pt.trace.json`` that
  Perfetto (ui.perfetto.dev), ``chrome://tracing`` and TensorBoard's
  profiler plugin open. A ``None``/empty dir is a no-op, so callers wrap
  unconditionally (``serve.py --torch-profile DIR``).
* ``annotation(name)`` — a ``torch.profiler.record_function(name)`` range
  and, where the card is present, an NVTX range of the same name, so Nsight
  Systems sees the same names. The scheduler wraps each step dispatch
  (``prefill`` / ``decode`` / ``verify`` / ...) so the trace arrives
  pre-segmented by tick phase. Both ranges are host-side: a CUDA graph
  replay's kernels run later on the card, and a reader attributes them to
  the phase through the profiler's correlation id of the ``cudaGraphLaunch``
  inside the range.

A profiler that fails to start warns once and yields False, as the JAX
package's does: serving must not die for want of telemetry.
"""
from __future__ import annotations

import contextlib
import warnings
from typing import ContextManager, Iterator, Optional

import torch

__all__ = ["annotation", "null_annotation", "torch_profile"]

_NULL_CTX = contextlib.nullcontext()


def null_annotation(name: str) -> ContextManager:
    """The off switch: one shared, reusable null context."""
    return _NULL_CTX


@contextlib.contextmanager
def annotation(name: str) -> Iterator[None]:
    """``record_function(name)``, and on a machine with a card also
    ``torch.cuda.nvtx.range(name)``, entered together. Use only while a
    capture runs: the ranges are cheap but not free."""
    with torch.profiler.record_function(name):
        if torch.cuda.is_available():
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield


@contextlib.contextmanager
def torch_profile(trace_dir: Optional[str], device="cuda") -> Iterator[bool]:
    """Capture a ``torch.profiler`` trace into ``trace_dir`` for the
    with-block.

    Yields True while a capture runs (callers switch their annotation
    factory on it), False when disabled or when the profiler fails to
    start. Never raises for the profiler's sake."""
    if not trace_dir:
        yield False
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    try:
        prof = profile(activities=activities,
                       on_trace_ready=tensorboard_trace_handler(trace_dir))
        prof.start()
    except Exception as e:  # the profiler failed to start: serve without it
        warnings.warn(f"torch profiler capture unavailable: {e}", stacklevel=3)
        yield False
        return
    try:
        yield True
    finally:
        try:
            prof.stop()
        except Exception as e:  # a dead capture must not fail the served run
            warnings.warn(f"torch profiler stop failed: {e}", stacklevel=3)
