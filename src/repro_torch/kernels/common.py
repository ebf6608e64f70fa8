"""Shared kernel utilities, from ``repro/kernels/common.py``.

The Pallas interpret switch has no meaning on the card, and ``round_up``
served only the TPU's lane padding, which the CUDA kernels replace by
masking the ragged lane edge; neither is carried over.
"""
from __future__ import annotations


def largest_divisor_leq(n: int, k: int) -> int:
    """Time steps per kernel chunk: the largest divisor of ``n`` that is at
    most ``k``, so the chunks tile the sequence as the TPU kernel's did."""
    for d in range(min(n, k), 0, -1):
        if n % d == 0:
            return d
    return 1
