"""SRU (paper Eq. 2) and QRNN (Eq. 3) cell parameters, from ``repro/core/cells.py``.

Init shapes and scales only: the gate math of these cells runs inside the
fused kernels (``kernels/fused_rnn``). Weight layout is the lane-major one of
the JAX package: per-gate slabs ``(d_in, n_gates, hidden)`` and
``(n_gates, hidden)`` biases. Random numbers come from an explicit
``torch.Generator`` on the CPU, so a seed gives the same weights on any
device; they differ from ``jax.random``'s (the tests bridge JAX's weights in).
"""
from __future__ import annotations

import math
from typing import Dict

import torch

Params = Dict[str, torch.Tensor]


def _dense_init(gen, d_in: int, d_out: int, dtype, device) -> torch.Tensor:
    """``uniform(-1, 1) / sqrt(d_in)``, as the JAX package."""
    w = torch.rand((d_in, d_out), generator=gen, dtype=torch.float32) * 2.0 - 1.0
    return (w / math.sqrt(d_in)).to(device=device, dtype=dtype)


def _gate_init(gen, d_in: int, n_gates: int, hidden: int, dtype, device) -> torch.Tensor:
    """Lane-major fused gate projection ``(d_in, G, H)``."""
    return _dense_init(gen, d_in, n_gates * hidden, dtype, device).view(d_in, n_gates, hidden)


def sru_init(gen, d_in: int, hidden: int, dtype=torch.float32, device="cpu") -> Params:
    return {
        "w": _gate_init(gen, d_in, 3, hidden, dtype, device),   # [x_hat | f | r]
        "b": torch.zeros((2, hidden), dtype=dtype, device=device),  # f, r only
        "w_skip": None if d_in == hidden else _dense_init(gen, d_in, hidden, dtype, device),
    }


def qrnn_init(gen, d_in: int, hidden: int, dtype=torch.float32, device="cpu") -> Params:
    return {
        "w0": _gate_init(gen, d_in, 3, hidden, dtype, device),  # current input
        "w1": _gate_init(gen, d_in, 3, hidden, dtype, device),  # previous input
        "b": torch.zeros((3, hidden), dtype=dtype, device=device),
    }
