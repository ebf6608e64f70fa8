"""Public wrappers of the whole-layer fused SRU/QRNN kernel
(``repro/kernels/fused_rnn/ops.py``: ``run_padded_layer``, ``fused_sru``,
``fused_qrnn``).

``fused_sru`` / ``fused_qrnn`` take the cell param dicts of
``core/cells.py`` in the lane-major layout, fp or int8-quantized
(``layout.quantize_cell``), normalize them to kernel operands
(``layout.py``), pick the time block, and dispatch.

Differentiable, as JAX's ``_fused_core`` / ``_fused_core_q`` are through
``jax.custom_vjp``: ``_FusedCore`` runs the kernel forward (on the card;
the plain version on the CPU) and saves the call's inputs; its backward
evaluates the plain version (``fused_rnn.fused_rnn_layer_plain``) again on
them and differentiates it, so the gate activations the kernel kept out of
device memory are recomputed, never stored. With int8 slabs (``scale``
given) it is JAX's ``_fused_core_q``, straight-through: the int8 slabs get
no gradient; the scales, biases, input, skip projection, carry and conv
tail get the dequantized reference's.

The recompute evaluates the plain version's recurrence through the
linear-scan kernel's autograd op (B3, ``linear_scan_recurrence``): the
same function, ``c_t = f_t c_{t-1} + (1 - f_t) x_hat_t`` in fp32, with B3's
fixed fold order over chunks of time instead of the plain walk's one step
at a time. The walk is a Python loop over T, thousands of small launches
per layer and step, and it took the whole train step on the card (PERF.md §6);
B3 is two launches, forward and backward. The backward launches no fused
kernel.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.common import largest_divisor_leq, recompute_grads
from repro_torch.kernels.fused_rnn import layout
from repro_torch.kernels.fused_rnn.fused_rnn import fused_rnn_layer, fused_rnn_layer_plain
from repro_torch.kernels.linear_scan import ops as linear_scan_ops


def run_layer(u, taps, b3, c0, *, mode, tail=None, wskip=None, block_t=128, scale=None,
              skip=None, scale_lane0=0):
    """Dispatch one layer (the port of ``run_padded_layer`` and
    ``run_padded_layer_q``). The kernel masks the ragged lane edge, so
    nothing is padded or sliced here; the time block is the largest divisor
    of T that is at most ``block_t``, as on the TPU. ``skip`` and
    ``scale_lane0``: a model shard's operands (``fused_rnn_layer``)."""
    bt = largest_divisor_leq(u.shape[0], block_t)
    return fused_rnn_layer(
        u, taps, b3, c0, mode=mode, tail=tail, wskip=wskip, block_t=bt, scale=scale,
        skip=skip, scale_lane0=scale_lane0,
    )


def linear_scan_recurrence(x_hat, f, r, skip, c0):
    """``ref._scan``'s recurrence, ``c_t = f_t c_{t-1} + (1 - f_t) x_hat_t``
    and ``h_t = r_t tanh(c_t) [+ (1 - r_t) skip_t]``, with the carry through
    the linear-scan kernel's autograd op (its plain version on the CPU):
    differentiable in two launches, fp32 throughout."""
    c = linear_scan_ops.linear_scan(f, (1.0 - f) * x_hat, c0.float())
    h = r * torch.tanh(c)
    if skip is not None:
        h = h + (1.0 - r) * skip
    return h, c[-1]


class _FusedCore(torch.autograd.Function):
    """One layer: ``apply(mode, block_t, scale_lane0, u, b3, wskip, c0, tail,
    scale, skip, *taps) -> (h, c_last)``; ``scale`` is None for fp slabs,
    ``wskip``, ``tail`` and ``skip`` may be None (``skip``, ``scale_lane0``:
    a model shard's operands, ``fused_rnn_layer``)."""

    @staticmethod
    def forward(ctx, mode, block_t, scale_lane0, u, b3, wskip, c0, tail, scale, skip, *taps):
        ctx.mode, ctx.scale_lane0 = mode, scale_lane0
        ctx.save_for_backward(u, b3, wskip, c0, tail, scale, skip, *taps)
        return run_layer(u, taps, b3, c0, mode=mode, tail=tail, wskip=wskip, block_t=block_t,
                         scale=scale, skip=skip, scale_lane0=scale_lane0)

    @staticmethod
    def backward(ctx, g_h, g_c):
        def plain(u, b3, wskip, c0, tail, scale, skip, *taps):
            return fused_rnn_layer_plain(u, taps, b3, c0, mode=ctx.mode, tail=tail,
                                         wskip=wskip, scale=scale, skip=skip,
                                         scale_lane0=ctx.scale_lane0,
                                         scan=linear_scan_recurrence)

        grads = recompute_grads(plain, ctx.saved_tensors, ctx.needs_input_grad[3:], (g_h, g_c))
        return (None, None, None, *grads)


def fused_layer(u, taps, b3, c0, *, mode, tail=None, wskip=None, block_t=128, scale=None,
                skip=None, scale_lane0=0):
    """:func:`run_layer` through ``_FusedCore``: differentiable (int8 slabs:
    straight-through)."""
    return _FusedCore.apply(mode, block_t, scale_lane0, u, b3, wskip, c0, tail, scale, skip,
                            *taps)


def fused_sru(
    params,
    x: torch.Tensor,   # (T, B, d) time-major
    c0: torch.Tensor,  # (B, H)
    *,
    block_t: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whole SRU layer, fused. Returns (h, c_last): (T, B, H), (B, H).
    Takes fp (``w``) or int8 (``wq`` + ``wq_scale``) cell params."""
    if layout.is_quantized(params):
        taps, scale, b3, mode, wskip = layout.sru_slabs_q(params)
    else:
        (taps, b3, mode, wskip), scale = layout.sru_slabs(params), None
    return fused_layer(x, taps, b3, c0, mode=mode, wskip=wskip, block_t=block_t, scale=scale)


def fused_qrnn(
    params,
    x: torch.Tensor,                       # (T, B, d) time-major
    x_prev_tail: Optional[torch.Tensor],   # (1, B, d) conv carry (None: zeros)
    c0: torch.Tensor,                      # (B, H)
    *,
    block_t: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whole QRNN layer, fused (shifted-input GEMM). Returns (h, c_last).
    Takes fp (``w0``/``w1``) or int8 (``w0q``/``w1q`` + shared ``wq_scale``)
    cell params."""
    if layout.is_quantized(params):
        taps, scale, b3 = layout.qrnn_slabs_q(params)
    else:
        (taps, b3), scale = layout.qrnn_slabs(params), None
    return fused_layer(
        x, taps, b3, c0, mode="qrnn", tail=x_prev_tail, block_t=block_t, scale=scale
    )
