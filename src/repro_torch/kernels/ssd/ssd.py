"""Chunked SSD kernel: wrapper of the CUDA kernel in ``csrc/ssd.cu`` that
replaces ``repro/kernels/ssd/ssd.py::ssd_pallas`` and the operand
preparation of its ``ops.py``.

The kernel reads x, dt, B and C in the model-side layout through their
strides and folds dt, the log-decay, the group index and the D skip in
itself. It walks the sequence in its own chunks of 64 steps (S > 1) or runs
its one-step form (S == 1, decode). With bf16 x, B and C the chunk kernel
runs on the tensor cores, each CTA on a block of heads of one group that
``chunk_plan`` sizes; the other dtypes run the fp32 chunk kernel, one head a
CTA. ``LAUNCHES`` counts calls that launched it (one CUDA launch each).
:func:`ssd_meta` stands for :func:`ssd_cuda` on meta operands: it checks
them, launches nothing and records the call (``kernels/common.py``).
"""
from __future__ import annotations

import ctypes
import functools
import math
import types
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (DTYPE_CODES, H100, ctas_per_sm, cuda_dtype_code,
                                        dtype_code, dtype_name, instance, nbytes, record_call)

LAUNCHES = 0
CHUNK = 64  # the kernel's chunk: its tiling, which changes no value
INFO_FIELDS = ("smem_bytes", "ctas_per_sm", "registers", "max_heads_per_cta", "p_slice")
#: C B^T's share of the work of one head of a CTA in the mma chunk kernel
#: (0.33 M of about 1.2 M multiply-adds per chunk at N = 128, P slice 32).
CB_SHARE = 0.25


def chunk_plan(batch: int, heads: int, groups: int, head_dim: int, n_sm: int,
               ctas_per_sm: int, max_heads: int, p_slice: int):
    """``(heads_per_cta, grid)`` of the mma chunk kernel. A CTA takes
    ``heads_per_cta`` heads of one group (the last block of a group may
    hold fewer) and ``p_slice`` columns of each, so the grid is (P slices,
    groups x head blocks, lanes). Of the block sizes from 2 (1 when a group
    has one head, so C B^T is shared by every head of a CTA) to
    ``max_heads``, the one whose rounds of ``n_sm * ctas_per_sm`` CTAs
    finish first, each CTA's time taken as its heads plus ``CB_SHARE``;
    ties go to the larger block (fewer C B^T)."""
    rep = heads // groups
    slices = -(-head_dim // p_slice)
    slots = n_sm * ctas_per_sm
    best = None
    for hb in range(min(2, rep), min(rep, max_heads) + 1):
        ctas = batch * groups * -(-rep // hb) * slices
        cost = math.ceil(ctas / slots) * (hb + CB_SHARE)
        if best is None or cost <= best[0]:
            best = (cost, hb, (slices, groups * -(-rep // hb), batch))
    return best[1], best[2]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def instance_info(x_dtype: torch.dtype, bc_dtype: torch.dtype,
                  state_size: int) -> types.MappingProxyType:
    """The chunk kernel's instance for these operands, as the card reports
    it: ``INFO_FIELDS`` (dynamic shared memory per CTA in bytes, resident
    CTAs per SM, registers per thread, most heads per CTA, state columns
    per CTA)."""
    info = (ctypes.c_int * len(INFO_FIELDS))()
    build.check(build.library("ssd").ssd_info(
        DTYPE_CODES[x_dtype], DTYPE_CODES[bc_dtype], state_size, info), "ssd_info")
    return types.MappingProxyType(dict(zip(INFO_FIELDS, info)))  # cached: read-only


#: The one-step kernels' card report (``ssd_step_info``).
STEP_INFO_FIELDS = ("smem_bytes", "ctas_per_sm", "registers", "static_smem_bytes")


@functools.lru_cache(maxsize=None)
def step_instance_info(x_dtype: torch.dtype, bc_dtype: torch.dtype,
                       vec: bool) -> types.MappingProxyType:
    """The one-step kernel's instance (S == 1; ``vec`` its 16-byte state
    form), as the card reports it: ``STEP_INFO_FIELDS`` (dynamic shared
    memory per CTA, 0; resident CTAs per SM; registers per thread; static
    shared memory per CTA)."""
    info = (ctypes.c_int * len(STEP_INFO_FIELDS))()
    build.check(build.library("ssd").ssd_step_info(
        DTYPE_CODES[x_dtype], DTYPE_CODES[bc_dtype], int(vec), info), "ssd_step_info")
    return types.MappingProxyType(dict(zip(STEP_INFO_FIELDS, info)))  # cached: read-only


# The H100 model of the instances (``csrc/ssd.cu``): registers per thread as
# ptxas reported them for sm_90a (the card's CUDA 12.9 build), by (x dtype,
# B/C dtype) for the fp32 chunk kernel and the one-step kernels, and the
# static shared memory of the one-step kernels; the mma chunk kernel's
# shared memory is its ``MmaSmem``.
_F32, _BF16 = torch.float32, torch.bfloat16
_CHUNK_REGS = {(_F32, _F32): 96, (_F32, _BF16): 91, (_BF16, _F32): 120}
_STEP_VEC_REGS = {(_F32, _F32): 80, (_F32, _BF16): 87, (_BF16, _F32): 90, (_BF16, _BF16): 87}
_STEP_REGS, _STEP_STATIC, _STEP_VEC_STATIC = 40, 2048, 5120
_MMA_REGS, _MMA_SMEM, _MMA_THREADS, _MMA_MAX_HEADS, _MMA_P = 124, 176416, 512, 5, 32
_THREADS, _P_SLICE, _RS = 256, 64, 68  # the fp32 chunk kernel: its state columns, row stride
_TYPES = {_F32: "float", _BF16: "bf16"}


def _chunk_smem_bytes(bc_dtype: torch.dtype, N: int) -> int:
    """The fp32 chunk kernel's dynamic shared memory (``chunk_smem_bytes``):
    the B and C tiles, the xdt and state tiles, the score tile, the decays."""
    n4 = -(-N // 4) * 4
    esize = torch.finfo(bc_dtype).bits // 8
    return esize * 2 * CHUNK * (n4 + 4) + 4 * (CHUNK * _RS + n4 * _RS + CHUNK * _RS
                                               + 3 * CHUNK + 4)


def meta_instance(x_dtype: torch.dtype, bc_dtype: torch.dtype, batch: int, S: int,
                  heads: int, groups: int, head_dim: int, state_size: int,
                  vec: bool = True) -> dict:
    """The instance a call runs on the H100 model (``common.instance``): S
    == 1 the one-step kernel (``vec``: its 16-byte state form, P a multiple
    of 4 and the state aligned), bf16 x and B/C the mma chunk kernel on
    :func:`chunk_plan`'s head blocks, else the fp32 chunk kernel.
    :func:`instance_info` is the card's side of the chunk kernels,
    :func:`step_instance_info` of the one-step ones."""
    key, types = (x_dtype, bc_dtype), f"{_TYPES[x_dtype]},{_TYPES[bc_dtype]}"
    card = {"x_dtype": dtype_name(x_dtype), "bc_dtype": dtype_name(bc_dtype),
            "state_size": state_size}
    if S == 1:
        vec = vec and head_dim % 4 == 0
        return instance(f"ssd_step{'_vec' if vec else ''}_kernel<{types}>", _THREADS,
                        (heads, batch), 1, 0, _STEP_VEC_STATIC if vec else _STEP_STATIC,
                        _STEP_VEC_REGS[key] if vec else _STEP_REGS,
                        {"x_dtype": card["x_dtype"], "bc_dtype": card["bc_dtype"], "vec": vec})
    if key == (_BF16, _BF16):
        per_sm = ctas_per_sm(_MMA_THREADS, _MMA_REGS, _MMA_SMEM)
        _, grid = chunk_plan(batch, heads, groups, head_dim, H100["sm_count"], per_sm,
                             _MMA_MAX_HEADS, _MMA_P)
        return instance("ssd_chunk_mma_kernel", _MMA_THREADS, grid, 1, _MMA_SMEM, 0, _MMA_REGS,
                        card)
    return instance(f"ssd_chunk_kernel<{types}>", _THREADS,
                    (-(-head_dim // _P_SLICE), heads, batch), 1,
                    _chunk_smem_bytes(bc_dtype, state_size), 0, _CHUNK_REGS[key], card)


def plan(batch: int, heads: int, groups: int, head_dim: int, state_size: int,
         device_index: int = 0):
    """``chunk_plan`` of one bf16 call on this card."""
    info = instance_info(torch.bfloat16, torch.bfloat16, state_size)
    return chunk_plan(batch, heads, groups, head_dim, _sm_count(device_index),
                      info["ctas_per_sm"], info["max_heads_per_cta"], info["p_slice"])


def work(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B_: torch.Tensor,
         C_: torch.Tensor, D: Optional[torch.Tensor], s0: Optional[torch.Tensor]):
    """``(bytes, operations)`` of a call (the bound's formula): every operand
    read once, y and the fp32 state written once; the chunked algorithm at
    the kernel's ``CHUNK``-step chunks, the lower triangles of C B^T and of
    the scores times xdt, C S and B^T xdt (a multiply-add counts 2), or
    ``4 N P`` a head for one step."""
    Bsz, S, H, P = x.shape
    N = B_.shape[3]
    ops = 0.0
    for t0 in range(0, S, CHUNK):
        L = min(CHUNK, S - t0)
        tri = L * (L + 1) / 2
        ops += 2.0 * (tri * N + tri * P + 2 * L * N * P) if S > 1 else 4.0 * N * P
    rw = nbytes(x, dt, A, B_, C_, D, s0) + nbytes(x) + Bsz * H * N * P * 4
    return rw, ops * Bsz * H


def ssd_meta(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B_: torch.Tensor,
             C_: torch.Tensor, D: Optional[torch.Tensor], s0: Optional[torch.Tensor],
             y: torch.Tensor, state: torch.Tensor) -> None:
    """:func:`ssd_cuda` on meta operands: their dtype checks, no launch; the
    call is recorded."""
    if x.device.type != "meta":
        raise ValueError(f"the meta branch takes meta tensors, got {x.device}")
    dtype_code(x)
    dtype_code(B_)
    rw, ops = work(x, dt, A, B_, C_, D, s0)
    Bsz, S, H, P = x.shape
    record_call("ssd", 1, ops, rw, x.dtype,
                meta_instance(x.dtype, B_.dtype, Bsz, S, H, B_.shape[2], P, B_.shape[3]))


def ssd_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B_: torch.Tensor,
             C_: torch.Tensor, D: Optional[torch.Tensor], s0: Optional[torch.Tensor],
             y: torch.Tensor, state: torch.Tensor) -> None:
    """Launch the kernel on operands ``ops.ssd`` has checked: x (B,S,H,P)
    and B_, C_ (B,S,G,N) with unit last strides, dt (B,S,H), A and D (H,)
    contiguous, all fp32 but x, B_ and C_; s0 (may be None) and state
    (B,H,N,P) fp32 contiguous (state may be s0); y contiguous like x."""
    global LAUNCHES
    x_code, bc_code = cuda_dtype_code(x), cuda_dtype_code(B_)
    Bsz, S, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    heads_per_cta = 1
    if x_code == bc_code == DTYPE_CODES[torch.bfloat16] and S > 1:
        heads_per_cta = plan(Bsz, H, G, P, N, x.device.index or 0)[0]
    strides = (ctypes.c_longlong * 12)(*x.stride()[:3], *dt.stride(), *B_.stride()[:3],
                                        *C_.stride()[:3])
    lib = build.library("ssd")
    with torch.cuda.device(x.device):
        rc = lib.ssd_launch(
            x_code, bc_code, x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_.data_ptr(),
            C_.data_ptr(), None if D is None else D.data_ptr(),
            None if s0 is None else s0.data_ptr(), y.data_ptr(), state.data_ptr(),
            Bsz, S, H, G, P, N, heads_per_cta, strides,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    build.check(rc, "ssd")
    LAUNCHES += 1
