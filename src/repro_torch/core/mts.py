"""Multi-time-step (MTS) executor, from ``repro/core/mts.py``.

  * ``mts_sru`` / ``mts_qrnn``: all projections of the block are one
    time-batched GEMM (paper Eq. 4, ``core/cells.py``); the elementwise
    recurrence then runs on any engine of ``core/scan.py`` (sequential =
    SRU-1, chunked = SRU-n, associative, pallas = the linear-scan kernel).
    ``engine="fused"`` runs the whole layer in one kernel
    (``kernels/fused_rnn``), so gate activations never reach device memory;
    ``"fused_stack"`` is the stack-level engine routed in ``models/rnn.py``,
    and a single cell, with no depth to fuse, runs the per-layer kernel here.
  * ``lstm_forward``: the paper's LSTM treatment — ``W·x`` time-batched,
    ``U·h`` strictly sequential (``precompute=False``: the naive baseline).
  * ``StreamState`` + ``mts_stream_step``: a live stream processed one block
    at a time with exact carry of the recurrent state across blocks.

The v5e block-size policy (``auto_block_size``) is not carried over; an
H100 form of it is later work. Layout: the public API is batch-major
``(B, T, d)``; internals are time-major.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import cells
from repro_torch.core.scan import linear_scan
from repro_torch.kernels.fused_rnn import layout, ops
from repro_torch.models.layers import resolve_device

FUSED_ENGINES = ("fused", "fused_stack")


def _tm(x):  # batch-major <-> time-major
    return x.transpose(0, 1)


def _require_fp(params, engine: str) -> None:
    """Int8 gate slabs dequantize inside the fused kernels only; the other
    engines run the gate GEMM on fp slabs, so int8 there is an error."""
    if isinstance(params, dict) and layout.is_quantized(params):
        raise ValueError(
            f"engine={engine!r} cannot run int8-quantized gate slabs; use "
            "engine='fused'/'fused_stack' (in-kernel dequant) or "
            "kernels.fused_rnn.layout.dequantize_tree for the fp engines"
        )


def mts_sru(
    params,
    x: torch.Tensor,  # (B, T, d_in)
    c0: Optional[torch.Tensor] = None,  # (B, H)
    *,
    engine: str = "chunked",
    block_size: int = 128,
):
    """Returns (h, c_last) with h: (B, T, H)."""
    xt = _tm(x)
    if engine in FUSED_ENGINES:
        xt = xt.contiguous()
        if c0 is None:
            c0 = torch.zeros((xt.shape[1], params["w"].shape[-1]), dtype=xt.dtype, device=xt.device)
        h, c_last = ops.fused_sru(params, xt, c0, block_t=block_size)
        return _tm(h), c_last
    _require_fp(params, engine)
    x_hat, f, r = cells.sru_gates(params, xt)  # one GEMM over all T
    if c0 is None:
        c0 = torch.zeros(x_hat.shape[1:], dtype=x_hat.dtype, device=x_hat.device)
    a, b = cells.sru_recurrence_coeffs(x_hat, f)
    c = linear_scan(a, b, c0, engine=engine, block_size=block_size)
    h = cells.sru_output(params, r, c, xt)
    return _tm(h), c[-1]


def mts_qrnn(
    params,
    x: torch.Tensor,                            # (B, T, d_in)
    c0: Optional[torch.Tensor] = None,          # (B, H)
    x_prev_tail: Optional[torch.Tensor] = None,  # (B, 1, d_in) carry for the conv
    *,
    engine: str = "chunked",
    block_size: int = 128,
):
    """Returns (h, c_last) with h: (B, T, H)."""
    xt = _tm(x)
    tail = None if x_prev_tail is None else _tm(x_prev_tail)
    if engine in FUSED_ENGINES:
        xt = xt.contiguous()
        tail = None if tail is None else tail.contiguous()
        if c0 is None:
            c0 = torch.zeros((xt.shape[1], params["w0"].shape[-1]), dtype=xt.dtype, device=xt.device)
        h, c_last = ops.fused_qrnn(params, xt, tail, c0, block_t=block_size)
        return _tm(h), c_last
    _require_fp(params, engine)
    x_hat, f, o = cells.qrnn_gates(params, xt, tail)
    if c0 is None:
        c0 = torch.zeros(x_hat.shape[1:], dtype=x_hat.dtype, device=x_hat.device)
    c = linear_scan(f, (1.0 - f) * x_hat, c0, engine=engine, block_size=block_size)
    h = cells.qrnn_output(params, o, c)
    return _tm(h), c[-1]


def lstm_forward(
    params,
    x: torch.Tensor,                    # (B, T, d_in)
    h0: Optional[torch.Tensor] = None,  # (B, H)
    c0: Optional[torch.Tensor] = None,  # (B, H)
    *,
    precompute: bool = True,
):
    """Paper Sec. 3.1: only the W·x half parallelizes over time.
    Returns (h, c_last) with h: (B, T, H)."""
    xt = _tm(x)
    T, B, _ = xt.shape
    H = params["uh"].shape[0]
    if h0 is None:
        h0 = torch.zeros((B, H), dtype=xt.dtype, device=xt.device)
    if c0 is None:
        c0 = torch.zeros((B, H), dtype=xt.dtype, device=xt.device)
    xproj = cells.lstm_x_proj(params, xt) if precompute else None  # (T, B, 4H): one GEMM
    h, c, hs = h0, c0, []
    for t in range(T):
        xp_t = xproj[t] if precompute else cells.lstm_x_proj(params, xt[t][None])[0]
        h, c = cells.lstm_step(params, xp_t, h, c)
        hs.append(h)
    return _tm(torch.stack(hs)), c


# ---------------------------------------------------------------------------
# Streaming (the paper's single-user embedded scenario)
# ---------------------------------------------------------------------------

class StreamState(NamedTuple):
    c: torch.Tensor                 # (B, H) recurrent state
    x_tail: Optional[torch.Tensor]  # (B, 1, d_in) QRNN conv carry (None: SRU)


def stream_init(cell: str, batch: int, hidden: int, d_in: int, dtype=torch.float32,
                device="cuda") -> StreamState:
    device = resolve_device(device)
    tail = (torch.zeros((batch, 1, d_in), dtype=dtype, device=device)
            if cell == "qrnn" else None)
    return StreamState(c=torch.zeros((batch, hidden), dtype=dtype, device=device), x_tail=tail)


def mts_stream_step(
    cell: str,
    params,
    state: StreamState,
    x_block: torch.Tensor,  # (B, T_block, d_in)
    *,
    engine: str = "chunked",
    block_size: int = 128,
):
    """Process one MTS block of a live stream; exact w.r.t. one-shot evaluation."""
    if cell == "sru":
        h, c_last = mts_sru(params, x_block, state.c, engine=engine, block_size=block_size)
        return h, StreamState(c=c_last, x_tail=None)
    if cell == "qrnn":
        h, c_last = mts_qrnn(
            params, x_block, state.c, state.x_tail, engine=engine, block_size=block_size
        )
        return h, StreamState(c=c_last, x_tail=x_block[:, -1:])
    raise ValueError(f"streaming MTS requires input-gated cells, got {cell!r}")
