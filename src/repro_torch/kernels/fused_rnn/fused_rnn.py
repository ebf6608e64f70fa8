"""Whole-layer fused SRU/QRNN kernel: wrapper of the CUDA kernel in
``csrc/fused_rnn_layer.cu`` that replaces
``repro/kernels/fused_rnn/fused_rnn.py::fused_rnn_pallas``.

One launch computes one whole layer: the gate GEMM, the gate
nonlinearities, the recurrence on an fp32 carry across all time chunks, and
the highway output, so gate activations never reach device memory. Modes
select the highway term as in the JAX kernel:

  * ``sru_identity`` — skip is the layer input (d == H);
  * ``sru_proj``     — skip is ``u @ wskip``, computed in the kernel;
  * ``qrnn``         — no skip term, tanh on x_hat. The width-2 conv is the
                       shifted-input GEMM ``[u_t ; u_{t-1}] . [w0 ; w1]``; the
                       kernel builds the shifted rows itself from ``u`` and
                       ``tail`` and reads the taps in place.

Int8 gate slabs (``scale`` given): the taps are int8 and ``scale`` is the
compact fp32 ``(3, nb)`` ``wq_scale`` of ``layout.quantize_slabs``, shared by
QRNN's two taps. The kernel widens each int8 weight to fp32 as it stores the
tile, and multiplies the scale in after the gate GEMM's fp32 accumulate,
before the bias. ``wskip`` stays fp and unscaled.

A CUDA tensor launches the kernel (or raises); a CPU tensor runs the plain
version (``ref.py``). ``LAUNCHES`` counts launches of the fp instances,
``LAUNCHES_INT8`` those of the int8 ones.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import check_operand, cuda_dtype_code
from repro_torch.kernels.fused_rnn import layout
from repro_torch.kernels.fused_rnn.ref import fused_rnn_ref, fused_rnn_ref_q

LAUNCHES = 0
LAUNCHES_INT8 = 0

MAX_BATCH = 128  # the kernel tiles (time, batch) rows in chunks of at most 128
_SKIP_MODES = {"qrnn": 0, "sru_identity": 1, "sru_proj": 2}
INT8_CODE = 2  # the kernels' ``wdtype`` code of int8 gate slabs


def kernel_dtype(u: torch.Tensor, batch: int) -> int:
    """The kernel's dtype code for ``u``; raises on what the kernel does not take."""
    if batch > MAX_BATCH:
        raise ValueError(f"the CUDA kernel takes batch <= {MAX_BATCH}, got {batch}")
    return cuda_dtype_code(u)


def weight_dtype(scale, io_code: int) -> int:
    """The kernels' ``wdtype`` code: int8 slabs when scales come with them,
    else the slabs have the IO dtype."""
    return io_code if scale is None else INT8_CODE


def fused_rnn_layer_plain(u, taps, b3, c0, *, mode, tail=None, wskip=None, block_t=128,
                          scale=None):
    """The plain version of :func:`fused_rnn_layer` (same arguments)."""
    if mode == "qrnn":
        u, w3, b3 = layout.qrnn_operands({"w0": taps[0], "w1": taps[1], "b": b3}, u, tail)
    else:
        w3 = taps[0]
    if scale is None:
        return fused_rnn_ref(u, w3, b3, wskip, c0, mode=mode)
    s3 = layout.expand_scales(scale, w3.shape[-1])
    return fused_rnn_ref_q(u, w3, s3, b3, wskip, c0, mode=mode)


def fused_rnn_layer(
    u: torch.Tensor,               # (T, B, d) layer input
    taps: Sequence[torch.Tensor],  # (w3,) or QRNN (w0, w1), each (d, 3, H)
    b3: torch.Tensor,              # (3, H) gate biases
    c0: torch.Tensor,              # (B, H) initial recurrent state
    *,
    mode: str,                     # sru_identity | sru_proj | qrnn
    tail: Optional[torch.Tensor] = None,   # (1, B, d) QRNN u_{-1} (None: zeros)
    wskip: Optional[torch.Tensor] = None,  # (d, H) highway projection (sru_proj)
    block_t: int = 128,            # time steps per kernel chunk
    scale: Optional[torch.Tensor] = None,  # (3, nb) fp32: the taps are int8
):
    """Returns ``(h, c_last)``: (T, B, H), (B, H) in ``u``'s dtype."""
    if u.device.type == "cpu":
        return fused_rnn_layer_plain(
            u, taps, b3, c0, mode=mode, tail=tail, wskip=wskip, block_t=block_t, scale=scale
        )
    global LAUNCHES, LAUNCHES_INT8
    T, B, d = u.shape
    code = kernel_dtype(u, B)
    H = taps[0].shape[-1]
    if mode not in _SKIP_MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if len(taps) != (2 if mode == "qrnn" else 1):
        raise ValueError(f"mode {mode!r} takes {2 if mode == 'qrnn' else 1} slab(s)")
    check_operand(u, "u", (T, B, d), u)
    w_dtype = u.dtype if scale is None else torch.int8
    for i, w in enumerate(taps):
        check_operand(w, f"taps[{i}]", (d, 3, H), u, dtype=w_dtype)
    if scale is not None:
        check_operand(scale, "scale", (3, layout.n_scale_blocks(H)), u, dtype=torch.float32)
    check_operand(b3, "b3", (3, H), u)
    check_operand(c0, "c0", (B, H), u)
    if mode == "sru_identity" and d != H:
        raise ValueError(f"sru_identity needs d == H, got d={d}, H={H}")
    if mode == "sru_proj":
        check_operand(wskip, "wskip", (d, H), u)
    if mode == "qrnn":
        tail = torch.zeros((1, B, d), dtype=u.dtype, device=u.device) if tail is None else tail
        check_operand(tail, "tail", (1, B, d), u)

    h = torch.empty((T, B, H), dtype=u.dtype, device=u.device)
    c_last = torch.empty((B, H), dtype=u.dtype, device=u.device)
    lib = build.library("fused_rnn_layer" if scale is None else "fused_rnn_layer_int8")
    with torch.cuda.device(u.device):
        rc = lib.fused_rnn_layer_launch(
            code, weight_dtype(scale, code), u.data_ptr(), taps[0].data_ptr(),
            taps[1].data_ptr() if mode == "qrnn" else None,
            None if scale is None else scale.data_ptr(),
            b3.data_ptr(), c0.data_ptr(),
            tail.data_ptr() if mode == "qrnn" else None,
            u.data_ptr() if mode == "sru_identity" else None,
            wskip.data_ptr() if mode == "sru_proj" else None,
            h.data_ptr(), c_last.data_ptr(),
            T, B, d, H, block_t, int(mode == "qrnn"), _SKIP_MODES[mode],
            torch.cuda.current_stream(u.device).cuda_stream,
        )
    build.check(rc, "fused_rnn_layer")
    if scale is None:
        LAUNCHES += 1
    else:
        LAUNCHES_INT8 += 1
    return h, c_last
