"""Linear-scan kernel: wrapper of the CUDA kernel in ``csrc/linear_scan.cu``
that replaces ``repro/kernels/linear_scan/linear_scan.py::linear_scan_pallas``.

``c_t = a_t * c_{t-1} + b_t`` over ``(T, F)``: operands widened to fp32, an
fp32 carry for all T, each ``c_t`` stored in ``b``'s dtype. The TPU kernel's
time block and its two in-block schedules (``sequential``, ``hillis_steele``)
chose how the TPU evaluated one function; on the card each thread walks all
of T for its features, so neither is an argument here.

A CUDA tensor launches the kernel (or raises); a CPU tensor runs the plain
version (``ref.py::linear_scan_ref``). ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import check_operand, cuda_dtype_code
from repro_torch.kernels.linear_scan.ref import linear_scan_ref

LAUNCHES = 0


def linear_scan_kernel(a: torch.Tensor, b: torch.Tensor, c0: torch.Tensor) -> torch.Tensor:
    """a, b: (T, F); c0: (F,); all of one dtype (fp32 or bf16) and
    contiguous. Returns c: (T, F) in b's dtype."""
    if a.device.type == "cpu":
        return linear_scan_ref(a, b, c0)
    global LAUNCHES
    code = cuda_dtype_code(a)
    if a.dim() != 2:
        raise ValueError(f"a: expected (T, F), got shape {tuple(a.shape)}")
    T, F = a.shape
    check_operand(a, "a", (T, F), a)
    check_operand(b, "b", (T, F), a)
    check_operand(c0, "c0", (F,), a)
    out = torch.empty_like(b)
    lib = build.library("linear_scan")
    with torch.cuda.device(a.device):
        rc = lib.linear_scan_launch(
            code, a.data_ptr(), b.data_ptr(), c0.data_ptr(), out.data_ptr(), T, F,
            torch.cuda.current_stream(a.device).cuda_stream,
        )
    build.check(rc, "linear_scan")
    LAUNCHES += 1
    return out
