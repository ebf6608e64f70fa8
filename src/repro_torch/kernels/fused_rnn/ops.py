"""Public wrappers of the whole-layer fused SRU/QRNN kernel
(``repro/kernels/fused_rnn/ops.py``: ``run_padded_layer``, ``fused_sru``,
``fused_qrnn``).

``fused_sru`` / ``fused_qrnn`` take the cell param dicts of
``core/cells.py`` in the lane-major layout, fp or int8-quantized
(``layout.quantize_cell``), normalize them to kernel operands
(``layout.py``), pick the time block, and dispatch. Serving only:
the ``custom_vjp`` training backward of the JAX package comes with the
training slice.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.common import largest_divisor_leq
from repro_torch.kernels.fused_rnn import layout
from repro_torch.kernels.fused_rnn.fused_rnn import fused_rnn_layer


def run_layer(u, taps, b3, c0, *, mode, tail=None, wskip=None, block_t=128, scale=None):
    """Dispatch one layer (the port of ``run_padded_layer`` and
    ``run_padded_layer_q``). The kernel masks the ragged lane edge, so
    nothing is padded or sliced here; the time block is the largest divisor
    of T that is at most ``block_t``, as on the TPU."""
    bt = largest_divisor_leq(u.shape[0], block_t)
    return fused_rnn_layer(
        u, taps, b3, c0, mode=mode, tail=tail, wskip=wskip, block_t=bt, scale=scale
    )


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
    return run_layer(x, taps, b3, c0, mode=mode, wskip=wskip, block_t=block_t, scale=scale)


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
    return run_layer(
        x, taps, b3, c0, mode="qrnn", tail=x_prev_tail, block_t=block_t, scale=scale
    )
