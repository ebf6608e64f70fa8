"""Multi-time-step (MTS) executor, from ``repro/core/mts.py``.

  * ``mts_sru`` / ``mts_qrnn``: all projections of the block are one
    time-batched GEMM (paper Eq. 4, ``core/cells.py``); the elementwise
    recurrence then runs on any engine of ``core/scan.py`` (sequential =
    SRU-1, chunked = SRU-n, associative, pallas = the linear-scan kernel).
    ``engine="fused"`` runs the whole layer in one kernel
    (``kernels/fused_rnn``), so gate activations never reach device memory;
    ``"fused_stack"`` is the stack-level engine routed in ``models/rnn.py``,
    and a single cell, with no depth to fuse, runs the per-layer kernel here.
    The non-fused layer is ``distribution/tensor_parallel.py``'s
    ``sru_layer`` / ``qrnn_layer``. Given a ``mesh`` (``models/rnn.py``
    passes ``distribution/fused_sharded.py::sharding_mesh``) every engine
    runs the layer per rank on this rank's lane shard of ``params`` and
    ``c0``: the fused ones in ``distribution/fused_sharded.py``, the others
    in those two.
  * ``lstm_forward``: the paper's LSTM treatment — ``W·x`` time-batched,
    ``U·h`` strictly sequential (``precompute=False``: the naive baseline),
    in ``tensor_parallel.lstm_layer``; given a ``mesh``, on this rank's
    4H / k columns of the weights.
  * ``StreamState`` + ``mts_stream_step``: a live stream processed one block
    at a time with exact carry of the recurrent state across blocks.

``auto_block_size`` is the JAX package's block-size policy with the H100's
constants in place of v5e's. Layout: the public API is batch-major
``(B, T, d)``; internals are time-major.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.distribution import fused_sharded, tensor_parallel
from repro_torch.kernels.fused_rnn import layout, ops
from repro_torch.models.layers import resolve_device

FUSED_ENGINES = ("fused", "fused_stack")

# H100 SXM constants of the block-size policy (NVIDIA's data sheet; PERF.md
# §3): dense bf16 tensor-core rate and HBM bandwidth.
H100_PEAK_FLOPS = 989e12
H100_HBM_BW = 3.35e12


def auto_block_size(d_model: int, *, cap: int = 256) -> int:
    """Smallest power-of-two MTS block that makes the gate GEMM compute-bound.

    The block GEMM is (T, d) x (d, 3H): its intensity is about T (the weights
    dominate the traffic for T << d), and it turns compute-bound once T
    passes peak / bandwidth / 2 (bf16 weights), 147.6 on the H100 (v5e's
    120.2 gave 128). ``d_model`` is unused, as in the JAX package.
    """
    ridge = H100_PEAK_FLOPS / H100_HBM_BW / 2.0  # /2: bf16 weights
    t = 1
    while t < min(ridge, cap):
        t *= 2
    return t


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
    mesh=None,
):
    """Returns (h, c_last) with h: (B, T, H). ``mesh``: run the layer per
    rank on it (``params`` and ``c0`` this rank's lane shards, ``c_last``
    its lanes); None runs the whole layer."""
    xt = _tm(x)
    if engine in FUSED_ENGINES:
        xt = xt.contiguous()
        if c0 is None:
            H = params["wq" if layout.is_quantized(params) else "w"].shape[-1]
            c0 = torch.zeros((xt.shape[1], H), dtype=xt.dtype, device=xt.device)
        if mesh is not None:
            h, c_last = fused_sharded.sharded_fused_sru(params, xt, c0, mesh=mesh,
                                                        block_t=block_size)
        else:
            h, c_last = ops.fused_sru(params, xt, c0, block_t=block_size)
        return _tm(h), c_last
    _require_fp(params, engine)
    h, c_last = tensor_parallel.sru_layer(params, xt, c0, engine=engine, block_size=block_size,
                                          mesh=mesh)
    return _tm(h), c_last


def mts_qrnn(
    params,
    x: torch.Tensor,                            # (B, T, d_in)
    c0: Optional[torch.Tensor] = None,          # (B, H)
    x_prev_tail: Optional[torch.Tensor] = None,  # (B, 1, d_in) carry for the conv
    *,
    engine: str = "chunked",
    block_size: int = 128,
    mesh=None,
):
    """Returns (h, c_last) with h: (B, T, H); see :func:`mts_sru`."""
    xt = _tm(x)
    tail = None if x_prev_tail is None else _tm(x_prev_tail)
    if engine in FUSED_ENGINES:
        xt = xt.contiguous()
        tail = None if tail is None else tail.contiguous()
        if c0 is None:
            H = params["w0q" if layout.is_quantized(params) else "w0"].shape[-1]
            c0 = torch.zeros((xt.shape[1], H), dtype=xt.dtype, device=xt.device)
        if mesh is not None:
            h, c_last = fused_sharded.sharded_fused_qrnn(params, xt, tail, c0, mesh=mesh,
                                                         block_t=block_size)
        else:
            h, c_last = ops.fused_qrnn(params, xt, tail, c0, block_t=block_size)
        return _tm(h), c_last
    _require_fp(params, engine)
    h, c_last = tensor_parallel.qrnn_layer(params, xt, c0, tail, engine=engine,
                                           block_size=block_size, mesh=mesh)
    return _tm(h), c_last


def lstm_forward(
    params,
    x: torch.Tensor,                    # (B, T, d_in)
    h0: Optional[torch.Tensor] = None,  # (B, H)
    c0: Optional[torch.Tensor] = None,  # (B, H)
    *,
    precompute: bool = True,
    mesh=None,
):
    """Paper Sec. 3.1: only the W·x half parallelizes over time.
    Returns (h, c_last) with h: (B, T, H). ``mesh``: per rank on its
    columns of ``params`` (``h0`` / ``c0`` whole or this rank's lanes), ``h``
    and ``c_last`` whole."""
    h, c_last = tensor_parallel.lstm_layer(params, _tm(x), h0, c0, mesh=mesh,
                                           precompute=precompute)
    return _tm(h), c_last


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
