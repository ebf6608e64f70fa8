"""Multi-time-step (MTS) executor, from ``repro/core/mts.py``.

``mts_sru`` / ``mts_qrnn`` evaluate one SRU/QRNN layer over a block of
inputs. This slice ports the ``fused`` and ``fused_stack`` engines: the whole
layer runs in one kernel (``kernels/fused_rnn``), so gate activations never
reach device memory. At this layer granularity a single cell has no depth to
fuse, so ``fused_stack`` runs the per-layer kernel here (the stack-level
engine is routed in ``models/rnn.py``). The other engines of the JAX package
raise ``NotImplementedError``.

Layout: the public API is batch-major ``(B, T, d)``; the kernels are
time-major.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.fused_rnn import ops

FUSED_ENGINES = ("fused", "fused_stack")


def _tm(x):  # batch-major <-> time-major
    return x.transpose(0, 1)


def _require_fused(engine: str) -> None:
    if engine not in FUSED_ENGINES:
        raise NotImplementedError(
            f"engine {engine!r} is not ported yet: the port runs {FUSED_ENGINES}; the "
            "core/scan.py engines come with B3 linear_scan (ROADMAP.md, open item (b))"
        )


def mts_sru(
    params,
    x: torch.Tensor,  # (B, T, d_in)
    c0: Optional[torch.Tensor] = None,  # (B, H)
    *,
    engine: str = "fused",
    block_size: int = 128,
):
    """Returns (h, c_last) with h: (B, T, H)."""
    _require_fused(engine)
    xt = _tm(x).contiguous()
    if c0 is None:
        c0 = torch.zeros((xt.shape[1], params["w"].shape[-1]), dtype=xt.dtype, device=xt.device)
    h, c_last = ops.fused_sru(params, xt, c0, block_t=block_size)
    return _tm(h), c_last


def mts_qrnn(
    params,
    x: torch.Tensor,                            # (B, T, d_in)
    c0: Optional[torch.Tensor] = None,          # (B, H)
    x_prev_tail: Optional[torch.Tensor] = None,  # (B, 1, d_in) carry for the conv
    *,
    engine: str = "fused",
    block_size: int = 128,
):
    """Returns (h, c_last) with h: (B, T, H)."""
    _require_fused(engine)
    xt = _tm(x).contiguous()
    tail = None if x_prev_tail is None else _tm(x_prev_tail).contiguous()
    if c0 is None:
        c0 = torch.zeros((xt.shape[1], params["w0"].shape[-1]), dtype=xt.dtype, device=xt.device)
    h, c_last = ops.fused_qrnn(params, xt, tail, c0, block_t=block_size)
    return _tm(h), c_last
