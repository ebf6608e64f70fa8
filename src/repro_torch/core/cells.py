"""The paper's RNN cells, from ``repro/core/cells.py``: SRU (Eq. 2), QRNN
(Eq. 3) and LSTM (Eq. 1).

Each cell has an init, a time-batched ``gates`` part (every quantity that
depends on the inputs alone, for all T steps at once: paper Eq. 4) and an
``output`` part applied to the scanned state. For SRU/QRNN all products sit
in ``gates`` and the recurrence is elementwise; for LSTM only ``W·x`` is
time-batched and ``U·h_{t-1}`` is one product per step (``lstm_step``).

Weight layout is the JAX package's: SRU/QRNN per-gate lane-major slabs
``(d_in, n_gates, hidden)`` and ``(n_gates, hidden)`` biases, whose gate
product is one GEMM on the free ``(d_in, n_gates * hidden)`` view; LSTM the
flat ``(d_in, 4 * hidden)`` layout with gate order ``[f | i | o | c_hat]``.
The gate products are plain ``torch.matmul``: the JAX package computes them
outside any Pallas kernel. Random numbers come from an explicit
``torch.Generator`` and are drawn on its device (a CPU generator gives the
same weights whatever ``device`` they are moved to); they differ from
``jax.random``'s (the tests bridge JAX's weights in).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.models.layers import resolve_device

Params = Dict[str, torch.Tensor]


def _dense_init(gen, d_in: int, d_out: int, dtype, device) -> torch.Tensor:
    """``uniform(-1, 1) / sqrt(d_in)``, as the JAX package."""
    w = torch.rand((d_in, d_out), generator=gen, dtype=torch.float32, device=gen.device) * 2.0 - 1.0
    return (w / math.sqrt(d_in)).to(device=device, dtype=dtype)


def _gate_init(gen, d_in: int, n_gates: int, hidden: int, dtype, device) -> torch.Tensor:
    """Lane-major fused gate projection ``(d_in, G, H)``."""
    return _dense_init(gen, d_in, n_gates * hidden, dtype, device).view(d_in, n_gates, hidden)


def _gate_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x (..., d) @ w (d, G, H)`` as one GEMM on the ``(d, G*H)`` view;
    returns ``(..., G, H)``."""
    return (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[-2:])


# ---------------------------------------------------------------------------
# SRU: x_hat = W x ; f = sigma(W_f x + b_f) ; r = sigma(W_r x + b_r)
#      c = f * c_prev + (1 - f) * x_hat ; h = r * tanh(c) + (1 - r) * skip
# ---------------------------------------------------------------------------

def sru_init(gen, d_in: int, hidden: int, dtype=torch.float32, device="cuda") -> Params:
    device = resolve_device(device)
    return {
        "w": _gate_init(gen, d_in, 3, hidden, dtype, device),   # [x_hat | f | r]
        "b": torch.zeros((2, hidden), dtype=dtype, device=device),  # f, r only
        "w_skip": None if d_in == hidden else _dense_init(gen, d_in, hidden, dtype, device),
    }


def sru_gates(params: Params, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Time-batched projections. x: (T, B, d_in) -> (x_hat, f, r) each (T, B, H)."""
    h3 = _gate_product(x, params["w"])
    x_hat = h3[..., 0, :]
    f = torch.sigmoid(h3[..., 1, :] + params["b"][0])
    r = torch.sigmoid(h3[..., 2, :] + params["b"][1])
    return x_hat, f, r


def sru_recurrence_coeffs(x_hat: torch.Tensor, f: torch.Tensor):
    """(a, b) of the linear recurrence c_t = a_t c_{t-1} + b_t."""
    return f, (1.0 - f) * x_hat


def sru_output(params: Params, r: torch.Tensor, c: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    skip = x if params["w_skip"] is None else x @ params["w_skip"]
    return r * torch.tanh(c) + (1.0 - r) * skip


# ---------------------------------------------------------------------------
# QRNN: gates from a width-2 causal conv over (x_t, x_{t-1}); the recurrence
# is SRU's; h = o * tanh(c).
# ---------------------------------------------------------------------------

def qrnn_init(gen, d_in: int, hidden: int, dtype=torch.float32, device="cuda") -> Params:
    device = resolve_device(device)
    return {
        "w0": _gate_init(gen, d_in, 3, hidden, dtype, device),  # current input
        "w1": _gate_init(gen, d_in, 3, hidden, dtype, device),  # previous input
        "b": torch.zeros((3, hidden), dtype=dtype, device=device),
    }


def qrnn_gates(params: Params, x: torch.Tensor, x_prev_tail=None):
    """x: (T, B, d_in); x_prev_tail: (1, B, d_in) last input of the previous
    block (zeros at sequence start), so blockwise streaming is exact."""
    if x_prev_tail is None:
        x_prev_tail = torch.zeros_like(x[:1])
    x_shift = torch.cat([x_prev_tail, x[:-1]], dim=0)
    h3 = _gate_product(x, params["w0"]) + _gate_product(x_shift, params["w1"]) + params["b"]
    x_hat = torch.tanh(h3[..., 0, :])
    f = torch.sigmoid(h3[..., 1, :])
    o = torch.sigmoid(h3[..., 2, :])
    return x_hat, f, o


def qrnn_output(params: Params, o: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return o * torch.tanh(c)


# ---------------------------------------------------------------------------
# LSTM: the W·x half is one time-batched GEMM; U·h_{t-1} is a (B, H) x (H, 4H)
# product per step (paper Sec. 3.1), the baseline MTS cannot batch.
# ---------------------------------------------------------------------------

def lstm_init(gen, d_in: int, hidden: int, dtype=torch.float32, device="cuda") -> Params:
    device = resolve_device(device)
    return {
        "wx": _dense_init(gen, d_in, 4 * hidden, dtype, device),   # [f | i | o | c_hat]
        "uh": _dense_init(gen, hidden, 4 * hidden, dtype, device),
        "b": torch.zeros((4 * hidden,), dtype=dtype, device=device),
    }


def lstm_x_proj(params: Params, x: torch.Tensor) -> torch.Tensor:
    """The precomputable half: one GEMM for all T steps."""
    return x @ params["wx"] + params["b"]


def lstm_step(params: Params, xproj_t: torch.Tensor, h: torch.Tensor, c: torch.Tensor):
    return lstm_update(xproj_t + h @ params["uh"], c)


def lstm_update(z: torch.Tensor, c: torch.Tensor):
    """The elementwise half of a step from the whole pre-activations ``z``
    (B, 4H): the gates, then the new ``(h, c)``."""
    H = z.shape[-1] // 4
    f = torch.sigmoid(z[..., :H])
    i = torch.sigmoid(z[..., H:2 * H])
    o = torch.sigmoid(z[..., 2 * H:3 * H])
    c_hat = torch.tanh(z[..., 3 * H:])
    c = f * c + i * c_hat
    h = o * torch.tanh(c)
    return h, c
