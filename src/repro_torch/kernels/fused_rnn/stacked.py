"""Depth-fused SRU/QRNN stack: wrapper of the CUDA kernel in
``csrc/fused_rnn_layer.cu`` that replaces
``repro/kernels/fused_rnn/stacked.py::fused_rnn_stack_pallas``.

For each of the L layers: RMSNorm of the residual stream, the gate GEMM
(QRNN: the shifted normed input with a per-layer conv tail carried across
calls), the recurrence on an fp32 carry, the highway with the normed input as
skip (SRU), and ``x += h``. The residual stream stays in fp32 across all
layers and is cast to the input dtype once, at the end.

On the TPU one kernel ran all L layers per time chunk with the full width in
VMEM. On the card layer l+1's norm contracts over the full width of layer
l's output, so lanes cannot be split across CTAs inside one launch without a
grid-wide barrier. This wrapper therefore launches the layer kernel once per
layer over all T, with a pre-norm prologue and a residual epilogue (L
launches per call). That is exact: the stack is causal per layer. The
residual stream between launches lives in two fp32 buffers used in turn.

A CUDA tensor launches the kernel (or raises); a CPU tensor runs the plain
version (``ref.py::fused_rnn_stack_ref``). ``LAUNCHES`` counts kernel
launches, one per layer.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import check_operand, largest_divisor_leq
from repro_torch.kernels.fused_rnn import layout
from repro_torch.kernels.fused_rnn.fused_rnn import kernel_dtype
from repro_torch.kernels.fused_rnn.ref import fused_rnn_stack_ref

LAUNCHES = 0

_EPS = 1e-6  # matches models/layers.py rmsnorm


def fused_rnn_stack_plain(x, taps, b3L, lnL, c0L, tailsL=None, *, block_t=128):
    """The plain version of :func:`fused_rnn_stack` (same arguments)."""
    cell = "qrnn" if len(taps) == 2 else "sru"
    return fused_rnn_stack_ref(
        x, layout.stack_taps(taps), b3L, lnL, c0L, tailsL, cell=cell, eps=_EPS
    )


def fused_rnn_stack(
    x: torch.Tensor,               # (T, B, H) residual stream
    taps: Sequence[torch.Tensor],  # (w3L,) or QRNN (w0L, w1L), each (L, H, 3, H)
    b3L: torch.Tensor,             # (L, 3, H)
    lnL: torch.Tensor,             # (L, H) pre-norm gains
    c0L: torch.Tensor,             # (L, B, H) initial carries
    tailsL: Optional[torch.Tensor] = None,  # (L, B, H) QRNN conv tails (normed)
    *,
    block_t: int = 128,            # time steps per kernel chunk
):
    """Returns ``(y, c_last, tails_last)``; tails_last is None for SRU."""
    if x.device.type == "cpu":
        return fused_rnn_stack_plain(x, taps, b3L, lnL, c0L, tailsL, block_t=block_t)
    global LAUNCHES
    T, B, H = x.shape
    code = kernel_dtype(x, B)
    L = taps[0].shape[0]
    qrnn = len(taps) == 2
    check_operand(x, "x", (T, B, H), x)
    for i, w in enumerate(taps):
        check_operand(w, f"taps[{i}]", (L, H, 3, H), x)
    check_operand(b3L, "b3L", (L, 3, H), x)
    check_operand(lnL, "lnL", (L, H), x)
    check_operand(c0L, "c0L", (L, B, H), x)
    if qrnn:
        check_operand(tailsL, "tailsL", (L, B, H), x)

    xa = x.to(torch.float32, copy=True)
    xb = torch.empty_like(xa)
    c_last = torch.empty((L, B, H), dtype=x.dtype, device=x.device)
    tails_last = torch.empty((L, B, H), dtype=x.dtype, device=x.device) if qrnn else None
    lib = build.library("fused_rnn_layer")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        for l in range(L):
            rc = lib.fused_rnn_stack_layer_launch(
                code, xa.data_ptr(), taps[0][l].data_ptr(),
                taps[1][l].data_ptr() if qrnn else None,
                b3L[l].data_ptr(), lnL[l].data_ptr(), c0L[l].data_ptr(),
                tailsL[l].data_ptr() if qrnn else None,
                xb.data_ptr(), c_last[l].data_ptr(),
                tails_last[l].data_ptr() if qrnn else None,
                T, B, H, block_t, _EPS, stream,
            )
            build.check(rc, f"fused_rnn_stack layer {l}")
            LAUNCHES += 1
            xa, xb = xb, xa
    return xa.to(x.dtype), c_last, tails_last


def _stack_fwd_impl(x, taps, b3L, lnL, c0L, tailsL, block_t):
    """Pick the time block as the TPU did and run the stack. ``x``: (T, B, d)
    with d == H (the residual stream feeds each layer's highway)."""
    d, H = x.shape[-1], taps[0].shape[-1]
    if d != H:
        raise ValueError(f"the depth-fused stack needs d_model == hidden, got {d} != {H}")
    bt = largest_divisor_leq(x.shape[0], block_t)
    return fused_rnn_stack(x, taps, b3L, lnL, c0L, tailsL, block_t=bt)


def fused_sru_stack(
    params,                # {"w": (L, d, 3, H), "b": (L, 2, H), "w_skip": None}
    ln_g: torch.Tensor,    # (L, d)
    x: torch.Tensor,       # (T, B, d) time-major residual stream
    c0: torch.Tensor,      # (L, B, H)
    *,
    block_t: int = 128,
):
    """Depth-fused SRU stack. Returns (y, c_last): (T, B, d), (L, B, H)."""
    layout.require_fp(params)
    if params.get("w_skip") is not None:
        raise ValueError("stack residual requires d_model == hidden")
    taps, b3L, _, _ = layout.sru_slabs(params)
    y, c_last, _ = _stack_fwd_impl(x, taps, b3L, ln_g, c0, None, block_t)
    return y, c_last


def fused_qrnn_stack(
    params,                # {"w0": (L, d, 3, H), "w1": (L, d, 3, H), "b": (L, 3, H)}
    ln_g: torch.Tensor,    # (L, d)
    x: torch.Tensor,       # (T, B, d)
    tails: torch.Tensor,   # (L, B, d) per-layer conv carries (NORMED inputs)
    c0: torch.Tensor,      # (L, B, H)
    *,
    block_t: int = 128,
):
    """Depth-fused QRNN stack. Returns (y, c_last, tails_last)."""
    layout.require_fp(params)
    taps, b3L = layout.qrnn_slabs(params)
    return _stack_fwd_impl(x, taps, b3L, ln_g, c0, tails, block_t)
