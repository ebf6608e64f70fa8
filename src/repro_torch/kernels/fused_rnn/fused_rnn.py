"""Whole-layer fused SRU/QRNN kernel: wrapper of the CUDA kernel in
``csrc/fused_rnn_layer.cu`` that replaces
``repro/kernels/fused_rnn/fused_rnn.py::fused_rnn_pallas``.

One launch computes one whole layer: the gate GEMM, the gate
nonlinearities, the recurrence on an fp32 carry across all time chunks, and
the highway output, so gate activations never reach device memory. Modes
select the highway term as in the JAX kernel:

  * ``sru_identity`` — skip is the layer input (d == H);
  * ``sru_proj``     — skip is ``u @ wskip``, computed in the kernel;
  * ``qrnn``         — no skip term, tanh on x_hat. The width-2 conv is the
                       shifted-input GEMM ``[u_t ; u_{t-1}] . [w0 ; w1]``; the
                       kernel builds the shifted rows itself from ``u`` and
                       ``tail`` and reads the taps in place.

Int8 gate slabs (``scale`` given): the taps are int8 and ``scale`` is the
compact fp32 ``(3, nb)`` ``wq_scale`` of ``layout.quantize_slabs``, shared by
QRNN's two taps. The kernel widens each int8 weight exactly and multiplies
the scale in after the gate GEMM's fp32 accumulate, before the bias.
``wskip`` stays fp and unscaled.

bf16 input runs the kernel's tensor-core body: each CTA keeps its slice of
the slabs resident in shared memory, a thread block cluster splits the
contraction, and the gate GEMM runs on ``mma.sync``. :func:`plan` sizes it
(lanes per CTA, cluster, input tile) and :func:`instance_info` reports the
instance as the card sees it. fp32 input runs the CUDA-core body.

A CUDA tensor launches the kernel (or raises); a CPU tensor runs the plain
version (``ref.py``). ``LAUNCHES`` counts launches of the fp instances,
``LAUNCHES_INT8`` those of the int8 ones.
"""
from __future__ import annotations

import ctypes
import functools
import types
from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import DTYPE_CODES, check_operand, cuda_dtype_code
from repro_torch.kernels.fused_rnn import layout
from repro_torch.kernels.fused_rnn.ref import fused_rnn_ref, fused_rnn_ref_q

LAUNCHES = 0
LAUNCHES_INT8 = 0

MAX_BATCH = 128  # the kernel tiles (time, batch) rows in chunks of at most 128
_SKIP_MODES = {"qrnn": 0, "sru_identity": 1, "sru_proj": 2}
INT8_CODE = 2  # the kernels' ``wdtype`` code of int8 gate slabs


# The tensor-core body's tiling, as ``csrc/fused_rnn_layer.cu`` lays it out
# (``geometry``): 256 threads, at most 4 staged input segments of 8 columns
# a thread, 16 bytes after each input-tile row, three 32-byte gate runs per
# k, each tap padded to the 64-row box of a tensor copy, 1 KB of slack to
# align the slab.
THREADS = 256
MAX_SEG = 4
ROW_PAD = 16
GATE_ROW = 3 * 32
BOX_K = 64
ALIGN = 1024
SMEM_MAX = 232448  # dynamic shared memory a CTA may have on the H100
CLUSTERS = (1, 2, 4, 8)
N_SM = 132  # SMs of the H100 SXM
INFO_FIELDS = ("smem_bytes", "ctas_per_sm", "registers", "lanes", "cluster", "grid",
               "max_active_clusters", "rows", "k_tile")


class Plan(NamedTuple):
    """One bf16 launch: ``lanes`` hidden lanes per lane block (one 32-byte
    slab run per (k, gate)), ``cluster`` CTAs per lane block splitting the
    contraction, ``grid`` CTAs, ``rows`` (time, batch) rows per chunk,
    ``k_tile`` input-tile columns, ``k_per_cta`` contraction rows per CTA
    (each tap padded to ``BOX_K``), ``smem_bytes`` dynamic shared memory per
    CTA."""

    lanes: int
    cluster: int
    grid: int
    rows: int
    k_tile: int
    k_per_cta: int
    smem_bytes: int


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def _smem_bytes(lanes, ng, stack, taps, T, B, d, block_t, cluster, k_tile):
    """``(bytes, rows, k per CTA)`` of the kernel's shared memory for this
    launch (its ``geometry``: region by region, each rounded to 16 bytes;
    three input-tile stages where they fit, else two, one for one tile)."""
    bt = min(max(block_t, 1), T)
    if bt * B > MAX_BATCH:
        bt = MAX_BATCH // B
    rows = bt * B
    mtiles = -(-rows // 16)
    mp, wm = 16 * mtiles, 1
    while wm < mtiles:
        wm *= 2
    wk = THREADS // 32 // wm
    dpad = _up(d, BOX_K)
    kc = _up(-(-taps * dpad // cluster), BOX_K)
    ne = lanes // cluster
    nq = (bt + 1) * B
    ustride = k_tile * (4 if stack else 2) + (32 if stack else 16)

    def total(stages):
        regions = (
            kc * GATE_ROW,                                   # the slab slice
            kc * lanes * 2 if ng == 4 else 0,                # sru_proj's skip column
            stages * mp * ustride,                           # input tiles
            wk * mp * ng * lanes * 4 if wk > 1 else 0,       # partial sums of the K-split warps
            mp * ng * lanes * 4,                             # partial sums the cluster hands in
            5 * rows * ne * 4,                               # epilogue
            cluster * nq * 4 if stack else 0,                # the cluster's sums of squares
            nq * 4 if stack else 0,                          # rstd
            6 * ne * 4,                                      # biases, int8 scales
            B * ne * 4,                                      # carry
            dpad * 4 if stack else 0,                        # norm gain
            8,                                               # the slab copies' barrier
        )
        return sum(_up(r, 16) for r in regions) + ALIGN

    if k_tile >= kc:
        return total(1), rows, kc
    return (total(3) if total(3) <= SMEM_MAX else total(2)), rows, kc


@functools.lru_cache(maxsize=None)
def plan(T: int, B: int, d: int, H: int, *, int8: bool = False, ng: int = 3,
         stack: bool = False, taps: int = 1, block_t: int = 128, n_sm: int = N_SM,
         slots: Optional[tuple] = None) -> Plan:
    """The bf16 launch for a call of this shape. Lanes: 16 (bf16 slabs) or
    32 (int8). Cluster: the largest of ``CLUSTERS`` whose grid (lane blocks
    x cluster) fits ``n_sm`` SMs and whose clusters the card holds all at
    once (``slots``, one count per size in ``CLUSTERS``, as
    :func:`cluster_slots` reads them; by default ``n_sm // size``), or
    larger when the CTA's slice does not fit shared memory. Input tile: as
    many columns as the threads copy in one pass (``MAX_SEG`` segments
    each), a power of two dividing the K range of a CTA and each tap, fewer
    if shared memory runs out. Raises when no cluster fits."""
    lanes = 32 if int8 else 16
    blocks = -(-H // lanes)
    slots = slots or tuple(n_sm // c for c in CLUSTERS)
    first = max([c for c, n in zip(CLUSTERS, slots) if blocks * c <= n_sm and blocks <= n]
                or [1])
    dpad = _up(d, BOX_K)
    for cluster in (c for c in CLUSTERS if c >= first):
        _, rows, kc = _smem_bytes(lanes, ng, stack, taps, T, B, d, block_t, cluster, 16)
        kt = 16
        while kc % (2 * kt) == 0 and dpad % (2 * kt) == 0 and rows * 2 * kt <= (
                THREADS * MAX_SEG * 8):
            kt *= 2
        while kt >= 16:  # a power of two that divides K per CTA and each tap
            smem, _, _ = _smem_bytes(lanes, ng, stack, taps, T, B, d, block_t, cluster, kt)
            if smem <= SMEM_MAX:
                return Plan(lanes, cluster, blocks * cluster, rows, kt, kc, smem)
            kt //= 2
    raise ValueError(
        f"the bf16 kernel cannot keep a slab slice of d={d} x {taps} tap(s) in shared "
        f"memory at cluster {CLUSTERS[-1]}")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def cluster_slots(index: int = 0) -> tuple:
    """How many clusters of each size in ``CLUSTERS`` card ``index`` holds at
    once, each CTA filling an SM's shared memory (the GPCs' SM counts set
    it)."""
    out = (ctypes.c_int * len(CLUSTERS))()
    with torch.cuda.device(index):
        build.check(build.library("fused_rnn_layer").fused_rnn_cluster_slots(out),
                    "fused_rnn_cluster_slots")
    return tuple(out)


def _plan_on(device: torch.device, T, B, d, H, **kw) -> Plan:
    index = device.index or 0
    return plan(T, B, d, H, n_sm=_sm_count(index), slots=cluster_slots(index), **kw)


def instance_info(T: int, B: int, d: int, H: int, *, int8: bool = False, ng: int = 3,
                  stack: bool = False, taps: int = 1,
                  block_t: int = 128) -> types.MappingProxyType:
    """The bf16 instance a call of this shape runs, as the card reports it:
    ``INFO_FIELDS`` (dynamic shared memory per CTA in bytes, resident CTAs
    per SM, registers per thread, lanes per CTA, cluster size, grid, clusters
    the card holds at once, rows per chunk, input-tile columns)."""
    p = _plan_on(torch.device("cuda"), T, B, d, H, int8=int8, ng=ng, stack=stack, taps=taps,
                 block_t=block_t)
    info = (ctypes.c_int * len(INFO_FIELDS))()
    lib = build.library("fused_rnn_layer_int8" if int8 else "fused_rnn_layer")
    rc = lib.fused_rnn_info(DTYPE_CODES[torch.bfloat16], INT8_CODE if int8 else 1, ng,
                            int(stack), taps, T, B, d, H, block_t, p.cluster, p.k_tile, info)
    build.check(rc, "fused_rnn_info")
    return types.MappingProxyType(dict(zip(INFO_FIELDS, info)))


def kernel_dtype(u: torch.Tensor, batch: int) -> int:
    """The kernel's dtype code for ``u``; raises on what the kernel does not take."""
    if batch > MAX_BATCH:
        raise ValueError(f"the CUDA kernel takes batch <= {MAX_BATCH}, got {batch}")
    return cuda_dtype_code(u)


def weight_dtype(scale, io_code: int) -> int:
    """The kernels' ``wdtype`` code: int8 slabs when scales come with them,
    else the slabs have the IO dtype."""
    return io_code if scale is None else INT8_CODE


def fused_rnn_layer_plain(u, taps, b3, c0, *, mode, tail=None, wskip=None, block_t=128,
                          scale=None):
    """The plain version of :func:`fused_rnn_layer` (same arguments)."""
    if mode == "qrnn":
        u, w3, b3 = layout.qrnn_operands({"w0": taps[0], "w1": taps[1], "b": b3}, u, tail)
    else:
        w3 = taps[0]
    if scale is None:
        return fused_rnn_ref(u, w3, b3, wskip, c0, mode=mode)
    s3 = layout.expand_scales(scale, w3.shape[-1])
    return fused_rnn_ref_q(u, w3, s3, b3, wskip, c0, mode=mode)


def fused_rnn_layer(
    u: torch.Tensor,               # (T, B, d) layer input
    taps: Sequence[torch.Tensor],  # (w3,) or QRNN (w0, w1), each (d, 3, H)
    b3: torch.Tensor,              # (3, H) gate biases
    c0: torch.Tensor,              # (B, H) initial recurrent state
    *,
    mode: str,                     # sru_identity | sru_proj | qrnn
    tail: Optional[torch.Tensor] = None,   # (1, B, d) QRNN u_{-1} (None: zeros)
    wskip: Optional[torch.Tensor] = None,  # (d, H) highway projection (sru_proj)
    block_t: int = 128,            # time steps per kernel chunk
    scale: Optional[torch.Tensor] = None,  # (3, nb) fp32: the taps are int8
):
    """Returns ``(h, c_last)``: (T, B, H), (B, H) in ``u``'s dtype."""
    if u.device.type == "cpu":
        return fused_rnn_layer_plain(
            u, taps, b3, c0, mode=mode, tail=tail, wskip=wskip, block_t=block_t, scale=scale
        )
    global LAUNCHES, LAUNCHES_INT8
    T, B, d = u.shape
    code = kernel_dtype(u, B)
    H = taps[0].shape[-1]
    if mode not in _SKIP_MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if len(taps) != (2 if mode == "qrnn" else 1):
        raise ValueError(f"mode {mode!r} takes {2 if mode == 'qrnn' else 1} slab(s)")
    check_operand(u, "u", (T, B, d), u)
    w_dtype = u.dtype if scale is None else torch.int8
    for i, w in enumerate(taps):
        check_operand(w, f"taps[{i}]", (d, 3, H), u, dtype=w_dtype)
    if scale is not None:
        check_operand(scale, "scale", (3, layout.n_scale_blocks(H)), u, dtype=torch.float32)
    check_operand(b3, "b3", (3, H), u)
    check_operand(c0, "c0", (B, H), u)
    if mode == "sru_identity" and d != H:
        raise ValueError(f"sru_identity needs d == H, got d={d}, H={H}")
    if mode == "sru_proj":
        check_operand(wskip, "wskip", (d, H), u)
    if mode == "qrnn":
        tail = torch.zeros((1, B, d), dtype=u.dtype, device=u.device) if tail is None else tail
        check_operand(tail, "tail", (1, B, d), u)

    cluster = k_tile = 0  # read by the bf16 instances only
    if u.dtype == torch.bfloat16:
        p = _plan_on(u.device, T, B, d, H, int8=scale is not None,
                     ng=4 if mode == "sru_proj" else 3, taps=len(taps), block_t=block_t)
        cluster, k_tile = p.cluster, p.k_tile
    h = torch.empty((T, B, H), dtype=u.dtype, device=u.device)
    c_last = torch.empty((B, H), dtype=u.dtype, device=u.device)
    lib = build.library("fused_rnn_layer" if scale is None else "fused_rnn_layer_int8")
    with torch.cuda.device(u.device):
        rc = lib.fused_rnn_layer_launch(
            code, weight_dtype(scale, code), u.data_ptr(), taps[0].data_ptr(),
            taps[1].data_ptr() if mode == "qrnn" else None,
            None if scale is None else scale.data_ptr(),
            b3.data_ptr(), c0.data_ptr(),
            tail.data_ptr() if mode == "qrnn" else None,
            u.data_ptr() if mode == "sru_identity" else None,
            wskip.data_ptr() if mode == "sru_proj" else None,
            h.data_ptr(), c_last.data_ptr(),
            T, B, d, H, block_t, int(mode == "qrnn"), _SKIP_MODES[mode], cluster, k_tile,
            torch.cuda.current_stream(u.device).cuda_stream,
        )
    build.check(rc, "fused_rnn_layer")
    if scale is None:
        LAUNCHES += 1
    else:
        LAUNCHES_INT8 += 1
    return h, c_last
