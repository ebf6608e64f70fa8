"""Shared kernel utilities, from ``repro/kernels/common.py``, and the
operand checks every CUDA kernel wrapper makes.

The Pallas interpret switch has no meaning on the card, and ``round_up``
served only the TPU's lane padding, which the CUDA kernels replace by
masking the ragged lane edge; neither is carried over.
"""
from __future__ import annotations

import torch

#: The kernels' dtype codes (their ``dtype`` argument).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check_operand(t: torch.Tensor, name: str, shape, like: torch.Tensor) -> None:
    """Raise unless ``t`` has ``shape`` and ``like``'s device and dtype and
    is contiguous: the kernels take exactly that."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.device != like.device or t.dtype != like.dtype:
        raise ValueError(
            f"{name}: {t.dtype} on {t.device}, expected {like.dtype} on {like.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def cuda_dtype_code(t: torch.Tensor) -> int:
    """The kernels' dtype code for ``t``; raises unless ``t`` is a CUDA
    tensor of a dtype the kernels take."""
    if t.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {t.device}")
    if t.dtype not in DTYPE_CODES:
        raise ValueError(f"the CUDA kernel takes float32 or bfloat16, got {t.dtype}")
    return DTYPE_CODES[t.dtype]


def largest_divisor_leq(n: int, k: int) -> int:
    """Time steps per kernel chunk: the largest divisor of ``n`` that is at
    most ``k``, so the chunks tile the sequence as the TPU kernel's did."""
    for d in range(min(n, k), 0, -1):
        if n % d == 0:
            return d
    return 1
