"""The cell-parameter layout module of the port (``repro/kernels/fused_rnn/layout.py``, fp part).

Canonical layout, the same as the JAX package's: SRU/QRNN gate projections
are per-gate lane-major slabs

    SRU   w:  (d, 3, H)   slabs [x_hat | f | r]      b: (2, H)  [f | r]
    QRNN  w0: (d, 3, H)   w1: (d, 3, H)  [x_hat|f|o] b: (3, H)

This module turns cell params into kernel operands. One difference from the
JAX package: the QRNN conv taps stay two separate slabs (a tuple ``taps``)
instead of one concatenated ``(2d, 3, H)`` slab. The JAX wrappers
concatenate them on every call, which copies the weights; the CUDA kernel
reads each tap in place. The plain versions, which follow the JAX
arithmetic, build the concatenated operands with :func:`qrnn_operands`.

Lane padding (``pad_lane_operands`` / ``pad_stack_operands``) is not carried
over: the kernels mask the ragged lane edge instead of padding to a tile.
The int8 scheme waits for its own slice.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def cell_kind(cell_params: dict) -> Optional[str]:
    """Classify a cell param dict by its keys (sru | qrnn | lstm | None).
    Quantized cells classify the same as their fp originals."""
    if "w0" in cell_params or "w0q" in cell_params:
        return "qrnn"
    if "w" in cell_params or "wq" in cell_params:
        return "sru"
    if "wx" in cell_params:
        return "lstm"
    return None


def is_quantized(cell_params: dict) -> bool:
    """True when the cell dict carries int8 gate slabs (``wq`` / ``w0q``)."""
    return "wq" in cell_params or "w0q" in cell_params


def require_fp(cell_params: dict) -> None:
    """Raise on int8 gate slabs: their kernels are not ported yet."""
    if is_quantized(cell_params):
        raise NotImplementedError(
            "int8 gate slabs are not ported yet (ROADMAP.md: the int8 forms of B1/B2)"
        )


def _sru_bias(b: torch.Tensor) -> torch.Tensor:
    """``(..., 2, H)`` [f | r] biases -> ``(..., 3, H)`` with a zero x_hat row."""
    return torch.cat([torch.zeros_like(b[..., :1, :]), b], dim=-2)


def sru_slabs(params) -> Tuple[tuple, torch.Tensor, str, Optional[torch.Tensor]]:
    """SRU cell params -> ``(taps, b3, mode, wskip)``: ``taps = (w,)`` the
    ``(..., d, 3, H)`` slab as stored, biases with a zero x_hat row, and the
    mode ``sru_identity`` (d == H) or ``sru_proj`` (``wskip`` = ``w_skip``).
    Takes one layer's params or the stacked ``(L, ...)`` ones alike, so it
    stands for the JAX package's ``sru_slabs`` and ``sru_stack_slabs``."""
    b3 = _sru_bias(params["b"])
    if params["w_skip"] is None:
        return (params["w"],), b3, "sru_identity", None
    return (params["w"],), b3, "sru_proj", params["w_skip"]


def qrnn_slabs(params) -> Tuple[tuple, torch.Tensor]:
    """QRNN cell params -> ``((w0, w1), b)``: the taps against x_t and
    x_{t-1}, left where they are. One layer's params or the stacked ones
    alike (the JAX package's ``qrnn_operands`` weights and
    ``qrnn_stack_slabs``)."""
    return (params["w0"], params["w1"]), params["b"]


def qrnn_operands(params, x, x_prev_tail):
    """QRNN cell params + inputs -> the shifted-input GEMM layout of the JAX
    package: ``u = [x_t ; x_{t-1}]`` of width 2d against ``w = [w0 ; w1]``
    ``(2d, 3, H)``. ``x``: (T, B, d); ``x_prev_tail``: (1, B, d) or None
    (zeros). Returns ``(u, w3, b3)``. The plain version uses it; the kernel
    builds the shifted rows itself."""
    if x_prev_tail is None:
        x_prev_tail = torch.zeros_like(x[:1])
    x_shift = torch.cat([x_prev_tail, x[:-1]], dim=0)
    u = torch.cat([x, x_shift], dim=-1)
    w3 = torch.cat([params["w0"], params["w1"]], dim=0)
    return u, w3, params["b"]


def stack_taps(taps) -> torch.Tensor:
    """The JAX package's ``(L, K, d, 3, H)`` stack-slab operand from the
    ``K`` taps (a copy; the plain versions use it, the kernel does not)."""
    return torch.stack(list(taps), dim=1)
