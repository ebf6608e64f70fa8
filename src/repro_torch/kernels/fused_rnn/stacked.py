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
grid-wide barrier. With bf16 input each launch runs the kernel's tensor-core
body, sized by ``fused_rnn.plan`` (``stack=True``). This wrapper therefore launches the layer kernel once per
layer over all T, with a pre-norm prologue and a residual epilogue (L
launches per call). That is exact: the stack is causal per layer. The
residual stream between launches lives in two fp32 buffers used in turn.

Int8 gate slabs (``sL`` given): the taps are int8 ``(L, H, 3, H)`` and
``sL`` the compact fp32 ``(L, 3, nb)`` scales; layer l's launch takes
``taps[.][l]`` and ``sL[l]`` and scales after the accumulate, as
``fused_rnn.py`` describes.

A CUDA tensor launches the kernel (or raises); a CPU tensor runs the plain
version (``ref.py::fused_rnn_stack_ref`` / ``fused_rnn_stack_ref_q``).
``LAUNCHES`` counts launches of the fp instances, one per layer,
``LAUNCHES_INT8`` those of the int8 ones.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import check_operand, largest_divisor_leq
from repro_torch.kernels.fused_rnn import layout
from repro_torch.kernels.fused_rnn.fused_rnn import _plan_on, kernel_dtype, weight_dtype
from repro_torch.kernels.fused_rnn.ref import fused_rnn_stack_ref, fused_rnn_stack_ref_q

LAUNCHES = 0
LAUNCHES_INT8 = 0

_EPS = 1e-6  # matches models/layers.py rmsnorm


def fused_rnn_stack_plain(x, taps, b3L, lnL, c0L, tailsL=None, *, block_t=128, sL=None):
    """The plain version of :func:`fused_rnn_stack` (same arguments)."""
    cell = "qrnn" if len(taps) == 2 else "sru"
    w3L = layout.stack_taps(taps)
    if sL is None:
        return fused_rnn_stack_ref(x, w3L, b3L, lnL, c0L, tailsL, cell=cell, eps=_EPS)
    sL = layout.expand_scales(sL, w3L.shape[-1])
    return fused_rnn_stack_ref_q(x, w3L, sL, b3L, lnL, c0L, tailsL, cell=cell, eps=_EPS)


def fused_rnn_stack(
    x: torch.Tensor,               # (T, B, H) residual stream
    taps: Sequence[torch.Tensor],  # (w3L,) or QRNN (w0L, w1L), each (L, H, 3, H)
    b3L: torch.Tensor,             # (L, 3, H)
    lnL: torch.Tensor,             # (L, H) pre-norm gains
    c0L: torch.Tensor,             # (L, B, H) initial carries
    tailsL: Optional[torch.Tensor] = None,  # (L, B, H) QRNN conv tails (normed)
    *,
    block_t: int = 128,            # time steps per kernel chunk
    sL: Optional[torch.Tensor] = None,  # (L, 3, nb) fp32: the taps are int8
):
    """Returns ``(y, c_last, tails_last)``; tails_last is None for SRU."""
    if x.device.type == "cpu":
        return fused_rnn_stack_plain(x, taps, b3L, lnL, c0L, tailsL, block_t=block_t, sL=sL)
    global LAUNCHES, LAUNCHES_INT8
    T, B, H = x.shape
    code = kernel_dtype(x, B)
    L = taps[0].shape[0]
    qrnn = len(taps) == 2
    check_operand(x, "x", (T, B, H), x)
    w_dtype = x.dtype if sL is None else torch.int8
    for i, w in enumerate(taps):
        check_operand(w, f"taps[{i}]", (L, H, 3, H), x, dtype=w_dtype)
    if sL is not None:
        check_operand(sL, "sL", (L, 3, layout.n_scale_blocks(H)), x, dtype=torch.float32)
    check_operand(b3L, "b3L", (L, 3, H), x)
    check_operand(lnL, "lnL", (L, H), x)
    check_operand(c0L, "c0L", (L, B, H), x)
    if qrnn:
        check_operand(tailsL, "tailsL", (L, B, H), x)

    cluster = k_tile = 0  # read by the bf16 instances only
    if x.dtype == torch.bfloat16:
        p = _plan_on(x.device, T, B, H, H, int8=sL is not None, stack=True, taps=len(taps),
                     block_t=block_t)
        cluster, k_tile = p.cluster, p.k_tile
    xa = x.to(torch.float32, copy=True)
    xb = torch.empty_like(xa)
    c_last = torch.empty((L, B, H), dtype=x.dtype, device=x.device)
    tails_last = torch.empty((L, B, H), dtype=x.dtype, device=x.device) if qrnn else None
    lib = build.library("fused_rnn_layer" if sL is None else "fused_rnn_layer_int8")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        for l in range(L):
            rc = lib.fused_rnn_stack_layer_launch(
                code, weight_dtype(sL, code), xa.data_ptr(), taps[0][l].data_ptr(),
                taps[1][l].data_ptr() if qrnn else None,
                None if sL is None else sL[l].data_ptr(),
                b3L[l].data_ptr(), lnL[l].data_ptr(), c0L[l].data_ptr(),
                tailsL[l].data_ptr() if qrnn else None,
                xb.data_ptr(), c_last[l].data_ptr(),
                tails_last[l].data_ptr() if qrnn else None,
                T, B, H, block_t, _EPS, cluster, k_tile, stream,
            )
            build.check(rc, f"fused_rnn_stack layer {l}")
            if sL is None:
                LAUNCHES += 1
            else:
                LAUNCHES_INT8 += 1
            xa, xb = xb, xa
    return xa.to(x.dtype), c_last, tails_last


def _stack_fwd_impl(x, taps, b3L, lnL, c0L, tailsL, block_t, sL=None):
    """Pick the time block as the TPU did and run the stack. ``x``: (T, B, d)
    with d == H (the residual stream feeds each layer's highway)."""
    d, H = x.shape[-1], taps[0].shape[-1]
    if d != H:
        raise ValueError(f"the depth-fused stack needs d_model == hidden, got {d} != {H}")
    bt = largest_divisor_leq(x.shape[0], block_t)
    return fused_rnn_stack(x, taps, b3L, lnL, c0L, tailsL, block_t=bt, sL=sL)


def fused_sru_stack(
    params,                # {"w" | "wq" (+ "wq_scale"): (L, d, 3, H), "b": (L, 2, H), "w_skip": None}
    ln_g: torch.Tensor,    # (L, d)
    x: torch.Tensor,       # (T, B, d) time-major residual stream
    c0: torch.Tensor,      # (L, B, H)
    *,
    block_t: int = 128,
):
    """Depth-fused SRU stack. Returns (y, c_last): (T, B, d), (L, B, H).
    Takes fp (``w``) or int8 (``wq`` + ``wq_scale``) stacked cell params."""
    if params.get("w_skip") is not None:
        raise ValueError("stack residual requires d_model == hidden")
    if layout.is_quantized(params):
        taps, sL, b3L, _, _ = layout.sru_slabs_q(params)
    else:
        (taps, b3L, _, _), sL = layout.sru_slabs(params), None
    y, c_last, _ = _stack_fwd_impl(x, taps, b3L, ln_g, c0, None, block_t, sL)
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
    """Depth-fused QRNN stack. Returns (y, c_last, tails_last). Takes fp
    (``w0``/``w1``) or int8 (``w0q``/``w1q`` + shared ``wq_scale``) params."""
    if layout.is_quantized(params):
        taps, sL, b3L = layout.qrnn_slabs_q(params)
    else:
        (taps, b3L), sL = layout.qrnn_slabs(params), None
    return _stack_fwd_impl(x, taps, b3L, ln_g, c0, tails, block_t, sL)
