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


def check_operand(t: torch.Tensor, name: str, shape, like: torch.Tensor, dtype=None) -> None:
    """Raise unless ``t`` has ``shape``, ``like``'s device, ``dtype`` (by
    default ``like``'s) and is contiguous: the kernels take exactly that."""
    dtype = like.dtype if dtype is None else dtype
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.device != like.device or t.dtype != dtype:
        raise ValueError(
            f"{name}: {t.dtype} on {t.device}, expected {dtype} on {like.device}"
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


def stream_words(table: dict, device: torch.device, n: int, at_least: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 words of launch state (arrival counters,
    a ticket word and flags) for a launch on the current stream of
    ``device``, from a kernel that leaves them fit for its next launch, so
    that they are zeroed only when allocated. The launches that share a
    buffer must therefore run one after another: each stream has its own in
    ``table``, of at least ``at_least`` words (made anew only when a launch
    needs more), and a launch captured into a CUDA graph (replayed on
    whatever stream, while an eager launch may replace its stream's buffer)
    gets one of its own, zeroed by a fill captured with it."""
    if torch.cuda.is_current_stream_capturing():
        return torch.zeros(n, dtype=torch.int32, device=device)
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    buf = table.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, at_least), dtype=torch.int32, device=device)
        table[key] = buf
    return buf


def largest_divisor_leq(n: int, k: int) -> int:
    """Time steps per kernel chunk: the largest divisor of ``n`` that is at
    most ``k``, so the chunks tile the sequence as the TPU kernel's did."""
    for d in range(min(n, k), 0, -1):
        if n % d == 0:
            return d
    return 1
