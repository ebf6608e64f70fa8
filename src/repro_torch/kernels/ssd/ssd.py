"""Chunked SSD kernel: wrapper of the CUDA kernel in ``csrc/ssd.cu`` that
replaces ``repro/kernels/ssd/ssd.py::ssd_pallas`` and the operand
preparation of its ``ops.py``.

The kernel reads x, dt, B and C in the model-side layout through their
strides and folds dt, the log-decay, the group index and the D skip in
itself. It walks the sequence in its own chunks of 64 steps (S > 1) or runs
its one-step form (S == 1, decode). ``LAUNCHES`` counts calls that launched
it.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import DTYPE_CODES, cuda_dtype_code

LAUNCHES = 0
CHUNK = 64  # the kernel's chunk: its tiling, which changes no value


def instance_info(x_dtype: torch.dtype, bc_dtype: torch.dtype, state_size: int):
    """``(dynamic shared memory bytes per CTA, resident CTAs per SM)`` of
    the chunk kernel's instance for these operands, as the card reports."""
    info = (ctypes.c_int * 2)()
    build.check(build.library("ssd").ssd_info(
        DTYPE_CODES[x_dtype], DTYPE_CODES[bc_dtype], state_size, info), "ssd_info")
    return info[0], info[1]


def ssd_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B_: torch.Tensor,
             C_: torch.Tensor, D: Optional[torch.Tensor], s0: Optional[torch.Tensor],
             y: torch.Tensor, state: torch.Tensor) -> None:
    """Launch the kernel on operands ``ops.ssd`` has checked: x (B,S,H,P)
    and B_, C_ (B,S,G,N) with unit last strides, dt (B,S,H), A and D (H,)
    contiguous, all fp32 but x, B_ and C_; s0 (may be None) and state
    (B,H,N,P) fp32 contiguous (state may be s0); y contiguous like x."""
    global LAUNCHES
    x_code, bc_code = cuda_dtype_code(x), cuda_dtype_code(B_)
    Bsz, S, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    strides = (ctypes.c_longlong * 12)(*x.stride()[:3], *dt.stride(), *B_.stride()[:3],
                                        *C_.stride()[:3])
    lib = build.library("ssd")
    with torch.cuda.device(x.device):
        rc = lib.ssd_launch(
            x_code, bc_code, x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_.data_ptr(),
            C_.data_ptr(), None if D is None else D.data_ptr(),
            None if s0 is None else s0.data_ptr(), y.data_ptr(), state.data_ptr(),
            Bsz, S, H, G, P, N, strides, torch.cuda.current_stream(x.device).cuda_stream,
        )
    build.check(rc, "ssd")
    LAUNCHES += 1
