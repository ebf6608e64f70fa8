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

It also holds the checkpoint converters: the gate-major <-> lane-major
reshapes (``to_lane_major``, ``to_gate_major``, the tree forms and
``migrate_flat_leaves``), behind ``checkpoint/manager.py``'s restore-time
migration and ``launch/migrate_checkpoint.py``, and ``quantize_flat_leaves``,
behind that tool's ``--quantize int8``. The reshapes take numpy arrays and
torch tensors alike (a bf16 tensor, or a bf16 leaf numpy reads as 2-byte
void words).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

# Manifest tag of the canonical layout that ``checkpoint/manager.py`` writes.
# Checkpoints without the field predate it and are ``gate_major``.
LANE_MAJOR = "lane_major"
GATE_MAJOR = "gate_major"

# Gate counts per cell leaf name (the slabs; a bias's count comes from its
# sibling leaves, since ``b`` alone is ambiguous across cells).
SLAB_GATES = {"w": 3, "w0": 3, "w1": 3}


# ---------------------------------------------------------------------------
# Converters (pure reshapes: bitwise, any dtype, numpy arrays or tensors)
# ---------------------------------------------------------------------------

def to_lane_major(arr, n_gates: int):
    """``(..., G*H) -> (..., G, H)``: split the flat gate-major trailing dim.
    Per-gate columns are contiguous in the flat layout, so this is a reshape
    and the round trip with :func:`to_gate_major` is bitwise."""
    gh = arr.shape[-1]
    if gh % n_gates != 0:
        raise ValueError(f"trailing dim {gh} not divisible by {n_gates} gates")
    return arr.reshape(tuple(arr.shape[:-1]) + (n_gates, gh // n_gates))


def to_gate_major(arr):
    """``(..., G, H) -> (..., G*H)``: inverse of :func:`to_lane_major`."""
    if arr.ndim < 2:
        raise ValueError(f"lane-major array needs a (G, H) tail, got {tuple(arr.shape)}")
    return arr.reshape(tuple(arr.shape[:-2]) + (arr.shape[-2] * arr.shape[-1],))


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


# gate counts of every convertible leaf, per cell kind (LSTM converts nothing)
_CELL_LEAF_GATES = {"sru": {"w": 3, "b": 2}, "qrnn": {"w0": 3, "w1": 3, "b": 3}}


def _convert_tree(tree, leaf_fn):
    if isinstance(tree, dict):
        gates = _CELL_LEAF_GATES.get(cell_kind(tree))
        if gates is not None:
            return {k: (leaf_fn(v, gates[k]) if k in gates and v is not None else v)
                    for k, v in tree.items()}
        return {k: _convert_tree(v, leaf_fn) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_convert_tree(v, leaf_fn) for v in tree))
    return tree


def tree_to_lane_major(params):
    """Convert every SRU/QRNN cell dict of a tree to lane-major; LSTM cells
    and non-cell leaves pass through untouched. Bitwise (reshapes only).
    Works on one layer's or stacked ``(L, ...)`` params and, unlike the JAX
    package's (which passes a NamedTuple through), inside NamedTuples too,
    so a ``TrainState``'s params and Adam moments convert in one call."""
    return _convert_tree(params, to_lane_major)


def tree_to_gate_major(params):
    """Inverse of :func:`tree_to_lane_major` (writes the legacy layout)."""
    return _convert_tree(params, lambda a, g: to_gate_major(a))


def _cell_leaf(path: str):
    """``(prefix, name)`` of a path whose leaf sits directly under ``cell``,
    else None."""
    parts = path.split("/")
    if len(parts) < 2 or parts[-2] != "cell":
        return None
    return "/".join(parts[:-1]), parts[-1]


def migrate_flat_leaves(leaves: dict) -> dict:
    """Migrate a checkpoint's flat ``{path: array}`` mapping to lane-major.

    A leaf converts when ``cell`` is the path component directly above it
    (``params/layers/cell/w``, and the Adam moments' ``opt/m/layers/cell/w``);
    a bias's gate count comes from its siblings (``w`` => SRU, 2; ``w0`` =>
    QRNN, 3) and an LSTM cell (a sibling ``wx``) stays flat. Returns a new
    dict in the same order; only converted entries are re-bound.
    """
    out = dict(leaves)
    for path, arr in leaves.items():
        cell = _cell_leaf(path)
        if cell is None:
            continue
        prefix, name = cell
        if f"{prefix}/wx" in leaves:
            continue  # LSTM stays gate-major
        if name in SLAB_GATES:
            out[path] = to_lane_major(arr, SLAB_GATES[name])
        elif name == "b":
            if f"{prefix}/w0" in leaves:
                out[path] = to_lane_major(arr, 3)
            elif f"{prefix}/w" in leaves:
                out[path] = to_lane_major(arr, 2)
    return out


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


_QUANT_LEAVES = ("wq", "w0q", "w1q", SCALE_KEY)


def quantize_flat_leaves(leaves: dict, device=None) -> dict:
    """Quantize a checkpoint's flat ``{path: tensor}`` mapping to int8 slabs
    (the converter behind ``launch/migrate_checkpoint.py --quantize int8``).

    Every ``.../cell/w`` (SRU) and ``.../cell/w0`` + ``.../cell/w1`` (QRNN)
    is replaced by its int8 slab(s) and a ``wq_scale``: the arrays
    ``models/lm.py::lm_init`` makes under ``weight_quant="int8"``. LSTM cells
    (a sibling ``wx``) and every other leaf pass through untouched. The JAX
    package's order is kept: the removed paths are deleted and the new ones
    appended, ``wq, wq_scale`` or ``w0q, w1q, wq_scale``. The quantization
    runs on ``device`` (default: where the slab lies) and its results come
    back to the host. Raises ``ValueError`` on a mapping that holds int8
    leaves already.
    """
    for path in leaves:
        cell = _cell_leaf(path)
        if cell is not None and cell[1] in _QUANT_LEAVES:
            raise ValueError(f"leaf {path!r} is already int8-quantized; refusing to "
                             "re-quantize")

    def on(t: torch.Tensor) -> torch.Tensor:
        return t if device is None else t.to(device)

    out = dict(leaves)
    for path, arr in leaves.items():
        cell = _cell_leaf(path)
        if cell is None:
            continue
        prefix, name = cell
        if f"{prefix}/wx" in leaves:
            continue  # LSTM stays fp
        if name == "w":
            wq, scale = quantize_slabs(on(arr))
            del out[path]
            out[f"{prefix}/wq"], out[f"{prefix}/{SCALE_KEY}"] = wq.cpu(), scale.cpu()
        elif name == "w0":
            w0q, w1q, scale = quantize_qrnn_slabs(on(arr), on(leaves[f"{prefix}/w1"]))
            del out[path], out[f"{prefix}/w1"]
            out[f"{prefix}/w0q"], out[f"{prefix}/w1q"] = w0q.cpu(), w1q.cpu()
            out[f"{prefix}/{SCALE_KEY}"] = scale.cpu()
    return out


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
