"""Linear first-order recurrence engines, from ``repro/core/scan.py``.

The paper's recurrence (SRU Eq. 2 / QRNN Eq. 3) is

    c_t = a_t * c_{t-1} + b_t                  (elementwise over the hidden dim)

with ``a_t = f_t`` and ``b_t = (1 - f_t) * x_hat_t``. The engines:

  * ``sequential``  — one step at a time (a Python loop over T); SRU-1.
  * ``chunked``     — the paper's multi-time-step (MTS) schedule: chunks of
                      ``block_size`` steps evaluated with the associative
                      schedule inside, the carry rippling between chunks.
  * ``associative`` — a log-depth prefix over affine-map composition,
                      ``(a2, b2) o (a1, b1) = (a1 * a2, a2 * b1 + b2)``, the
                      recursion of ``jax.lax.associative_scan``.
  * ``pallas``      — the linear-scan kernel (``kernels/linear_scan``), B3.
  * ``fused`` / ``fused_stack`` — layer- and stack-level engines, routed in
                      ``core/mts.py`` and ``models/rnn.py``; a bare recurrence
                      has no layer to fuse and runs the linear-scan kernel.

The three plain engines compute in the input dtype, as the JAX package's XLA
engines do; only the kernel carries in fp32. ``matrix_linear_scan`` is the
same recurrence on matrix-valued states (the SSD chunk-state scan).

Layout convention: time is axis 0 — ``a, b: (T, ...)``, carry ``c0: (...)``.
"""
from __future__ import annotations

import logging
from typing import Optional

import torch

from repro_torch.kernels.common import largest_divisor_leq
from repro_torch.kernels.linear_scan import ops as linear_scan_ops

logger = logging.getLogger(__name__)


def _combine(elem_i, elem_j):
    """Compose two affine maps c -> a*c + b; ``elem_j`` is applied after ``elem_i``."""
    a_i, b_i = elem_i
    a_j, b_j = elem_j
    return a_j * a_i, a_j * b_i + b_j


def linear_scan_sequential(a: torch.Tensor, b: torch.Tensor, c0: torch.Tensor) -> torch.Tensor:
    """Reference schedule: strict left-to-right evaluation (SRU-1)."""
    c = c0
    cs = []
    for t in range(a.shape[0]):
        c = a[t] * c + b[t]
        cs.append(c)
    return torch.stack(cs)


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """``[e0, o0, e1, o1, ...]`` along axis 0 (``len(even)`` is
    ``len(odd)`` or one more)."""
    n = even.shape[0] + odd.shape[0]
    pairs = torch.stack([even[: odd.shape[0]], odd], dim=1).flatten(0, 1)
    return torch.cat([pairs, even[odd.shape[0]:]], dim=0) if n % 2 else pairs


def _associative_scan(elems):
    """Inclusive prefix of ``_combine`` over axis 0, by the odd/even
    recursion of ``jax.lax.associative_scan``: combine adjacent pairs,
    scan the half-length sequence, then fill in the even positions."""
    n = elems[0].shape[0]
    if n < 2:
        return elems
    reduced = _combine([e[0:-1:2] for e in elems], [e[1::2] for e in elems])
    odd = _associative_scan(reduced)
    if n % 2 == 0:
        even = _combine([e[:-1] for e in odd], [e[2::2] for e in elems])
    else:
        even = _combine(odd, [e[2::2] for e in elems])
    even = [torch.cat([e[:1], r], dim=0) for e, r in zip(elems, even)]
    return [_interleave(e, o) for e, o in zip(even, odd)]


def linear_scan_associative(a: torch.Tensor, b: torch.Tensor, c0: torch.Tensor) -> torch.Tensor:
    """O(log T)-depth evaluation via parallel prefix over affine-map composition."""
    # Fold the initial state into the first element so the prefix of (a, b) at
    # position t is exactly c_t.
    b0 = torch.cat([b[:1] + a[:1] * c0, b[1:]], dim=0)
    _, b_pref = _associative_scan([a, b0])
    return b_pref


def linear_scan_chunked(
    a: torch.Tensor,
    b: torch.Tensor,
    c0: torch.Tensor,
    *,
    block_size: int,
) -> torch.Tensor:
    """The paper's MTS schedule: the associative schedule inside a block (the
    JAX default), the carry rippling between. ``T`` must be a multiple of
    ``block_size``."""
    T = a.shape[0]
    if T % block_size != 0:
        raise ValueError(f"T={T} not a multiple of block_size={block_size}")
    carry, chunks = c0, []
    for start in range(0, T, block_size):
        cs = linear_scan_associative(a[start:start + block_size], b[start:start + block_size], carry)
        carry = cs[-1]
        chunks.append(cs)
    return torch.cat(chunks, dim=0)


def linear_scan(
    a: torch.Tensor,
    b: torch.Tensor,
    c0: Optional[torch.Tensor] = None,
    *,
    engine: str = "chunked",
    block_size: int = 128,
) -> torch.Tensor:
    """Evaluate ``c_t = a_t * c_{t-1} + b_t`` for all t. Time is axis 0."""
    if c0 is None:
        c0 = torch.zeros(a.shape[1:], dtype=a.dtype, device=a.device)
    if engine == "sequential":
        return linear_scan_sequential(a, b, c0)
    if engine == "associative":
        return linear_scan_associative(a, b, c0)
    if engine == "chunked":
        bs = min(block_size, a.shape[0])
        if a.shape[0] % bs != 0:
            bs = largest_divisor_leq(a.shape[0], bs)
            # Loud on purpose: a benchmark sweeping block_size would otherwise
            # silently measure a different chunk than it reports. (The benign
            # T <= block_size clamp — e.g. T=1 decode — stays quiet.)
            logger.warning(
                "linear_scan: block_size=%d does not divide T=%d; "
                "shrunk to largest divisor %d",
                block_size, a.shape[0], bs,
            )
        return linear_scan_chunked(a, b, c0, block_size=bs)
    if engine in ("pallas", "fused", "fused_stack"):
        # A bare recurrence has no layer to fuse: the fused engines run the
        # linear-scan kernel here, as in the JAX package.
        return linear_scan_ops.linear_scan(a, b, c0, block_size=block_size)
    raise ValueError(f"unknown engine {engine!r}")


# ---------------------------------------------------------------------------
# Matrix-state variant (``core/ssd.py``'s algebra): the inter-chunk recurrence
# of Mamba-2 SSD is S_k = decay_k * S_{k-1} + dS_k with S a (..., N, P) matrix
# and decay a broadcastable scalar per head. The same engines apply.
# ---------------------------------------------------------------------------

def matrix_linear_scan(
    decay: torch.Tensor,  # (K, ...) broadcastable against the state
    dS: torch.Tensor,     # (K, ..., N, P)
    S0: Optional[torch.Tensor] = None,
    *,
    engine: str = "associative",
) -> torch.Tensor:
    """Scan over chunk states; returns the states *after* each chunk, shaped
    like ``dS``."""
    if S0 is None:
        S0 = torch.zeros(dS.shape[1:], dtype=dS.dtype, device=dS.device)
    decay_b = decay.reshape(decay.shape + (1,) * (dS.dim() - decay.dim()))
    return linear_scan(decay_b * torch.ones_like(dS), dS, S0, engine=engine)
