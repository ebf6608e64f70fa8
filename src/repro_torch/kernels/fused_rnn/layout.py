"""The cell-parameter layout module of the port (``repro/kernels/fused_rnn/layout.py``).

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

Lane padding (``pad_lane_operands`` / ``pad_stack_operands`` /
``pad_scale_lanes``) is not carried over: the kernels mask the ragged lane
edge instead of padding to a tile. The int8 normalizers hand the kernels the
compact ``(..., 3, nb)`` scales; the kernel reads the scale of lane j at
``j // SCALE_BLOCK``, which is what JAX's per-lane expanded operand holds.
``quantize_flat_leaves`` (the checkpoint converter) comes with the
checkpoint slice.
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


def _sru_bias(b: torch.Tensor) -> torch.Tensor:
    """``(..., 2, H)`` [f | r] biases -> ``(..., 3, H)`` with a zero x_hat row."""
    return torch.cat([torch.zeros_like(b[..., :1, :]), b], dim=-2)


def sru_slabs(params) -> Tuple[tuple, torch.Tensor, str, Optional[torch.Tensor]]:
    """SRU cell params -> ``(taps, b3, mode, wskip)``: ``taps = (w,)`` the
    ``(..., d, 3, H)`` slab as stored, biases with a zero x_hat row, and the
    mode ``sru_identity`` (d == H) or ``sru_proj`` (``wskip`` = ``w_skip``).
    Takes one layer's params or the stacked ``(L, ...)`` ones alike, so it
    stands for the JAX package's ``sru_slabs`` and ``sru_stack_slabs``."""
    mode = "sru_identity" if params["w_skip"] is None else "sru_proj"
    return (params["w"],), _sru_bias(params["b"]), mode, params["w_skip"]


def sru_slabs_q(params) -> Tuple[tuple, torch.Tensor, torch.Tensor, str, Optional[torch.Tensor]]:
    """Quantized SRU cell params -> ``(taps, scale, b3, mode, wskip)``: the
    int8 twin of :func:`sru_slabs` (JAX ``sru_slabs_q`` and
    ``sru_stack_slabs_q``), with ``taps = (wq,)`` and the compact fp32
    ``wq_scale`` ``(..., 3, nb)``. ``w_skip`` stays fp."""
    mode = "sru_identity" if params["w_skip"] is None else "sru_proj"
    return (params["wq"],), params[SCALE_KEY], _sru_bias(params["b"]), mode, params["w_skip"]


def qrnn_slabs(params) -> Tuple[tuple, torch.Tensor]:
    """QRNN cell params -> ``((w0, w1), b)``: the taps against x_t and
    x_{t-1}, left where they are. One layer's params or the stacked ones
    alike (the JAX package's ``qrnn_operands`` weights and
    ``qrnn_stack_slabs``)."""
    return (params["w0"], params["w1"]), params["b"]


def qrnn_slabs_q(params) -> Tuple[tuple, torch.Tensor, torch.Tensor]:
    """Quantized QRNN cell params -> ``((w0q, w1q), scale, b)``: both int8
    taps and the one compact scale set they share (JAX ``qrnn_operands_q``
    weights and ``qrnn_stack_slabs_q``)."""
    return (params["w0q"], params["w1q"]), params[SCALE_KEY], params["b"]


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


# ---------------------------------------------------------------------------
# Weight-only int8 quantization of the gate slabs
#
# Symmetric, per gate and per block of SCALE_BLOCK lanes: one fp32 scale per
# (gate, lane block) of the trailing H dim, shared across the contraction
# (d) axis, so the kernels multiply the scale in AFTER the gate GEMM's fp32
# accumulate (``z = dot(u, wq) * scale + b``). Biases, ``w_skip``, carries
# and the whole LSTM cell stay fp.
# ---------------------------------------------------------------------------

#: Lanes per scale block (the JAX package's kernel ``block_h`` tile). The
#: CUDA kernel's ``kScaleBlock`` (``csrc/fused_rnn_layer.cu``) is the same.
SCALE_BLOCK = 128

#: The key of the fp32 scales in a quantized cell; casts leave it fp32.
SCALE_KEY = "wq_scale"


def n_scale_blocks(H: int) -> int:
    """Number of lane-scale blocks covering ``H`` lanes."""
    return -(-max(H, 1) // SCALE_BLOCK)


def expand_scales(scale: torch.Tensor, H: int) -> torch.Tensor:
    """Compact ``(..., G, nb)`` scales -> per-lane ``(..., G, H)``."""
    return torch.repeat_interleave(scale, SCALE_BLOCK, dim=-1)[..., :H]


def quantize_slabs(w: torch.Tensor):
    """Quantize a lane-major gate slab ``(..., d, G, H)`` to int8.

    Returns ``(wq int8, scale fp32 (..., G, nb))`` with
    ``nb = ceil(H / SCALE_BLOCK)``: ``scale = max(amax, tiny) / 127`` with
    amax over the contraction axis and each ``SCALE_BLOCK``-lane group,
    ``wq = clip(round(w / s_lane), -127, 127)``.
    ``torch.round`` rounds half to even, as ``jnp.round`` does, so the result
    equals the JAX package's bit for bit.
    """
    if w.dim() < 3:
        raise ValueError(f"gate slab needs a (d, G, H) tail, got {tuple(w.shape)}")
    H = w.shape[-1]
    nb = n_scale_blocks(H)
    wf = w.float()
    pad = nb * SCALE_BLOCK - H
    wp = torch.nn.functional.pad(wf, (0, pad)) if pad else wf
    grouped = wp.reshape(wp.shape[:-1] + (nb, SCALE_BLOCK))    # (..., d, G, nb, SCALE_BLOCK)
    amax = grouped.abs().amax(dim=(-4, -1))                    # (..., G, nb)
    scale = torch.clamp(amax, min=torch.finfo(torch.float32).tiny) / 127.0
    q = torch.round(wf / expand_scales(scale, H)[..., None, :, :])
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def dequantize_slabs(wq: torch.Tensor, scale: torch.Tensor):
    """Inverse of :func:`quantize_slabs`: int8 slab times scales -> fp32 slab."""
    return wq.float() * expand_scales(scale, wq.shape[-1])[..., None, :, :]


def quantize_qrnn_slabs(w0, w1):
    """Quantize the QRNN conv taps jointly, with ONE shared scale set: the
    kernel sums both taps' products before it scales. Returns
    ``(w0q, w1q, scale)``, each tap contiguous (a stacked ``(L, 2d, 3, H)``
    slice would not be, and the kernels take contiguous slabs)."""
    d = w0.shape[-3]
    wq, scale = quantize_slabs(torch.cat([w0, w1], dim=-3))
    return wq[..., :d, :, :].contiguous(), wq[..., d:, :, :].contiguous(), scale


def quantize_cell(cell_params: dict) -> dict:
    """Quantize one cell param dict (one layer's or stacked ``(L, ...)``
    leaves). SRU ``w -> wq + wq_scale``; QRNN ``w0/w1 -> w0q/w1q + wq_scale``
    (shared). Biases and ``w_skip`` stay fp; LSTM and already-quantized cells
    pass through unchanged."""
    kind = cell_kind(cell_params)
    if kind == "sru" and "w" in cell_params:
        out = {k: v for k, v in cell_params.items() if k != "w"}
        out["wq"], out[SCALE_KEY] = quantize_slabs(cell_params["w"])
        return out
    if kind == "qrnn" and "w0" in cell_params:
        out = {k: v for k, v in cell_params.items() if k not in ("w0", "w1")}
        out["w0q"], out["w1q"], out[SCALE_KEY] = quantize_qrnn_slabs(
            cell_params["w0"], cell_params["w1"]
        )
        return out
    return cell_params


def dequantize_cell(cell_params: dict) -> dict:
    """Inverse of :func:`quantize_cell`: fp32 slabs in place of the int8 ones."""
    scale = cell_params.get(SCALE_KEY)
    if "wq" in cell_params:
        out = {k: v for k, v in cell_params.items() if k not in ("wq", SCALE_KEY)}
        out["w"] = dequantize_slabs(cell_params["wq"], scale)
        return out
    if "w0q" in cell_params:
        out = {k: v for k, v in cell_params.items() if k not in ("w0q", "w1q", SCALE_KEY)}
        out["w0"] = dequantize_slabs(cell_params["w0q"], scale)
        out["w1"] = dequantize_slabs(cell_params["w1q"], scale)
        return out
    return cell_params


def _map_cells(params, fn):
    if isinstance(params, dict):
        if cell_kind(params) in ("sru", "qrnn"):
            return fn(params)
        return {k: _map_cells(v, fn) for k, v in params.items()}
    return params


def quantize_tree(params):
    """Quantize every SRU/QRNN cell dict in a params tree (LSTM and non-cell
    subtrees untouched)."""
    return _map_cells(params, quantize_cell)


def dequantize_tree(params):
    """Inverse of :func:`quantize_tree` (fp32 slabs back in every cell)."""
    return _map_cells(params, dequantize_cell)


def cast_params(tree, dtype, key=None):
    """Cast the floating leaves of a params tree to ``dtype``, as the JAX
    package's LM does under int8: integer leaves (the int8 gate slabs) and
    the fp32 ``SCALE_KEY`` leaves stay as they are (bf16 scales would add
    ~0.4% error to every gate), and ``None`` stays. ``.to`` returns the
    tensor itself when it already has that dtype, so casting params that
    were cast before costs nothing."""
    if isinstance(tree, dict):
        return {k: cast_params(v, dtype, k) for k, v in tree.items()}
    if tree is None or not tree.is_floating_point() or key == SCALE_KEY:
        return tree
    return tree.to(dtype)
