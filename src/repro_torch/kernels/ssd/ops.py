"""Public entry of the chunked SSD (``repro/kernels/ssd/ops.py::ssd``).

``ssd(x, dt, A, B_, C_, D, initial_state=, chunk=)`` takes the model-side
layout ``(B, S, H, P)``, checks its operands, then runs the CUDA kernel
(``ssd.py``) on CUDA tensors and the plain version (``ref.py``) on CPU
tensors. ``chunk`` is the plain version's chunk (shrunk to a divisor of S
as in JAX); the kernel walks its own 64-step chunks, which change the order
of fp32 sums and no value. JAX's ``interpret`` is not carried over.

``state_out`` (decode and prefill of ``models/mamba.py``) is a (B, H, N, P)
fp32 buffer the final state is written into, in place; it may be
``initial_state`` itself.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.common import DTYPE_CODES
from repro_torch.kernels.ssd.ref import ssd_ref
from repro_torch.kernels.ssd.ssd import ssd_cuda, ssd_meta

MAX_STATE = 128     # N the kernel takes (its shared memory)
MAX_HEAD_DIM = 256  # P the kernel takes (its one-step form: a thread per column)


def _shape(t, name, shape, device):
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_floating_point():
        raise ValueError(f"{name}: {t.dtype} is not a floating dtype")


def check_operands(x, dt, A, B_, C_, D=None, initial_state=None, state_out=None) -> None:
    """Raise on what the kernel does not take, on either device."""
    if x.dim() != 4 or B_.dim() != 4:
        raise ValueError(f"x (B, S, H, P) and B_ (B, S, G, N) expected, got "
                         f"{tuple(x.shape)} and {tuple(B_.shape)}")
    Bsz, S, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    dev = x.device
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"x: float32 or bfloat16 expected, got {x.dtype}")
    if B_.dtype not in DTYPE_CODES or C_.dtype != B_.dtype:
        raise ValueError(f"B_, C_: one dtype, float32 or bfloat16, got {B_.dtype} and "
                         f"{C_.dtype}")
    if H % G:
        raise ValueError(f"H = {H} heads do not group over G = {G} groups")
    if N > MAX_STATE:
        raise ValueError(f"state size N = {N}; the kernel takes at most {MAX_STATE}")
    if P > MAX_HEAD_DIM:
        raise ValueError(f"head dim P = {P}; the kernel takes at most {MAX_HEAD_DIM}")
    _shape(dt, "dt", (Bsz, S, H), dev)
    _shape(A, "A", (H,), dev)
    _shape(B_, "B_", (Bsz, S, G, N), dev)
    _shape(C_, "C_", (Bsz, S, G, N), dev)
    if D is not None:
        _shape(D, "D", (H,), dev)
    if initial_state is not None:
        _shape(initial_state, "initial_state", (Bsz, H, N, P), dev)
    for t, name in ((x, "x"), (B_, "B_"), (C_, "C_")):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the kernel reads rows with a unit last stride, "
                             f"got strides {t.stride()}")
    if state_out is not None:
        _shape(state_out, "state_out", (Bsz, H, N, P), dev)
        if state_out.dtype != torch.float32 or not state_out.is_contiguous():
            raise ValueError("state_out: a contiguous float32 buffer expected")
        if (initial_state is not None and state_out.data_ptr() != initial_state.data_ptr()
                and _overlap(state_out, initial_state)):
            raise ValueError("state_out overlaps initial_state without being it")


def _overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    a0, b0 = a.data_ptr(), b.data_ptr()
    a1 = a0 + a.numel() * a.element_size()
    b1 = b0 + b.numel() * b.element_size()
    return a0 < b1 and b0 < a1


def ssd(
    x: torch.Tensor,      # (B, S, H, P)
    dt: torch.Tensor,     # (B, S, H)
    A: torch.Tensor,      # (H,)
    B_: torch.Tensor,     # (B, S, G, N)
    C_: torch.Tensor,     # (B, S, G, N)
    D: Optional[torch.Tensor] = None,  # (H,)
    *,
    initial_state: Optional[torch.Tensor] = None,  # (B, H, N, P)
    chunk: int = 128,
    state_out: Optional[torch.Tensor] = None,
):
    """Returns (y (B,S,H,P) in x's dtype, final state (B,H,N,P) fp32; the
    state is ``state_out`` when it is given)."""
    check_operands(x, dt, A, B_, C_, D, initial_state, state_out)
    if x.device.type == "cpu":
        y, state = ssd_ref(x, dt, A, B_, C_, D, chunk=chunk, initial_state=initial_state)
        if state_out is not None:
            state = state_out.copy_(state)
        return y, state
    f32 = torch.float32
    Bsz, _, H, P = x.shape
    s0 = None if initial_state is None else initial_state.to(f32).contiguous()
    if state_out is None:
        state_out = torch.empty((Bsz, H, B_.shape[3], P), dtype=f32, device=x.device)
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    launch = ssd_meta if x.device.type == "meta" else ssd_cuda
    launch(x, dt.to(f32), A.to(f32).contiguous(), B_, C_,
           None if D is None else D.to(f32).contiguous(), s0, y, state_out)
    return y, state_out
