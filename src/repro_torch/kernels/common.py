"""Shared kernel utilities, from ``repro/kernels/common.py``, and the
operand checks every CUDA kernel wrapper makes.

The Pallas interpret switch has no meaning on the card, and ``round_up``
served only the TPU's lane padding, which the CUDA kernels replace by
masking the ragged lane edge; neither is carried over.

The meta device. Every kernel's dispatch (its ``ops.py``) sends CPU
tensors to the plain version, CUDA tensors to the CUDA wrapper and meta
tensors to the wrapper's meta branch, which checks the operands as the
wrapper does, allocates on meta exactly what the wrapper allocates (its
outputs and its workspace, not the plain version's temporaries) and
launches nothing. Inside :func:`recorded_kernel_calls` each meta call is
logged with its launches, operations and bytes by the formula of the
kernel's bound (``chip_smoke.py``'s bound column): the dry run's FLOPs
count a kernel's work whatever implements it. Any other device raises, as
before. A meta branch that needs what the card reports (B5's split plan)
reads the H100 model below, which ``tests/test_torch_cuda.py`` holds to
the card.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

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


#: The H100 SXM (sm_90, 132 SMs) as the occupancy calculator sees it: the
#: meta branches' model of the card.
H100 = {"sm_count": 132, "smem_per_sm": 233472, "smem_reserved_per_cta": 1024,
        "regs_per_sm": 65536, "reg_unit_per_warp": 256, "max_ctas_per_sm": 32,
        "max_threads_per_sm": 2048}

_CALLS: contextvars.ContextVar[Optional[list]] = contextvars.ContextVar("kernel_calls",
                                                                       default=None)


@contextlib.contextmanager
def recorded_kernel_calls():
    """Log the kernels' meta calls while inside: the list this yields gets
    one dict per call (``name``, ``launches``, ``ops``, ``bytes``,
    ``dtype``)."""
    calls: list = []
    tok = _CALLS.set(calls)
    try:
        yield calls
    finally:
        _CALLS.reset(tok)


def record_call(name: str, launches: int, ops: float, rw_bytes: int, dtype: torch.dtype) -> None:
    """Log one meta call of kernel ``name`` (its ``launches`` CUDA launches,
    ``ops`` operations and ``rw_bytes`` bytes moved, by its bound's formula)
    when recording."""
    calls = _CALLS.get()
    if calls is not None:
        calls.append({"name": name, "launches": launches, "ops": float(ops),
                      "bytes": int(rw_bytes), "dtype": str(dtype).replace("torch.", "")})


def nbytes(*tensors) -> int:
    """The bytes of the given tensors (None counts 0)."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def ctas_per_sm(threads: int, regs: int, smem: int, card: dict = H100) -> int:
    """Resident CTAs per SM of an instance with ``threads`` threads,
    ``regs`` registers per thread and ``smem`` bytes of shared memory a CTA
    (dynamic and static), as ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
    counts them on ``card``."""
    warps = -(-threads // 32)
    unit = card["reg_unit_per_warp"]
    regs_cta = warps * -(-regs * 32 // unit) * unit
    return min(card["max_ctas_per_sm"], card["max_threads_per_sm"] // (warps * 32),
               card["regs_per_sm"] // regs_cta,
               card["smem_per_sm"] // (smem + card["smem_reserved_per_cta"]))


def dtype_code(t: torch.Tensor) -> int:
    """The kernels' dtype code for ``t`` on any device (a meta branch's
    check); raises on a dtype the kernels do not take."""
    if t.dtype not in DTYPE_CODES:
        raise ValueError(f"the CUDA kernel takes float32 or bfloat16, got {t.dtype}")
    return DTYPE_CODES[t.dtype]


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


def recompute_grads(plain, inputs, needs, grad_outs):
    """The backward of a kernel's autograd Function, as the JAX package's
    ``custom_vjp`` rules for its fused kernels do it: evaluate ``plain`` (the
    kernel's plain version) again on detached copies of the saved
    ``inputs`` with autograd on, and differentiate it against ``grad_outs``.
    ``needs[i]`` says whether input i wants a gradient (never an integer
    one). Returns one gradient or ``None`` per input."""
    detached = [None if t is None else t.detach().requires_grad_(bool(n))
                for t, n in zip(inputs, needs)]
    wrt = [t for t, n in zip(detached, needs) if n]
    if not wrt:
        return [None] * len(inputs)
    with torch.enable_grad():
        outs = plain(*detached)
    pairs = [(o, g) for o, g in zip(outs, grad_outs)
             if o is not None and g is not None and o.requires_grad]
    got = iter(torch.autograd.grad([o for o, _ in pairs], wrt, [g for _, g in pairs],
                                   allow_unused=True))
    return [next(got) if n else None for n in needs]
