"""Decode-attention kernel: wrapper of the CUDA kernel in
``csrc/gqa_decode.cu`` that replaces
``repro/kernels/gqa_decode/gqa_decode.py::gqa_decode_pallas``.

The TPU kernel walked the cache in ``block_s`` blocks inside one program per
(lane, KV head); the CUDA kernel cuts the cache into splits that run in
parallel (``split_plan``) and the last CTA of each (lane, KV head, head
block) to finish combines them, so the block size is not an argument.
That CTA sets its arrival counter back to 0, so a counter buffer is zeroed
once, when it is made. ``LAUNCHES`` counts calls that launched the kernel
(one CUDA launch each); ``LAUNCHES_LSE`` counts those of the form that also
stores the log-sum-exp (a shard of a sequence-sharded cache), apart.

:func:`gqa_decode_meta` is the wrapper on meta tensors (``kernels/
common.py``): the same outputs and split partials, planned on the H100
model (:func:`meta_instance_info`: the instance's shared memory from the
source's shapes, its registers as ptxas reported them for sm_90a), a
transient block of launch words, no launch.
"""
from __future__ import annotations

import ctypes
import functools
import math
import types

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (DTYPE_CODES, H100, ctas_per_sm, cuda_dtype_code,
                                        dtype_code, nbytes, record_call, stream_words)

LAUNCHES = 0
LAUNCHES_LSE = 0
MAX_SPLITS = 64  # the last CTA reads every split's partial
INFO_FIELDS = ("smem_bytes", "ctas_per_sm", "stages", "tile_rows", "registers", "heads_per_cta")

_COUNTERS = {}  # (device index, stream) -> arrival counters (``common.stream_words``)


def split_plan(batch: int, n_kv: int, seq: int, n_sm: int, ctas_per_sm: int, tile: int,
               head_blocks: int = 1, heads: int = 1, elem_bytes: int = 2):
    """``(n_split, rows_per_split)`` for a ``seq``-row cache: as many splits
    as one wave of resident CTAs (``n_sm * ctas_per_sm``) holds over the
    ``batch * n_kv * head_blocks`` (lane, KV head, head block) triples, each
    a whole number of ``tile``-row tiles, and no more than
    - one tile each, and one split for a cache of at most two tiles;
    - the combine's share: one CTA reads every split's fp32 partial
      (``heads`` x Dh each), at most twice the bytes of one split's K and V
      rows, so ``n_split**2 <= 2 * seq * elem_bytes / heads``;
    - ``MAX_SPLITS``.
    Chosen from the cache's capacity, not the lengths, which stay on the device."""
    want = min(n_sm * ctas_per_sm // (batch * n_kv * head_blocks), MAX_SPLITS,
               seq // tile if seq > 2 * tile else 1, math.isqrt(2 * seq * elem_bytes // heads))
    per_split = -(-seq // max(1, want))
    rows = -(-per_split // tile) * tile
    return -(-seq // rows), rows


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def instance_info(dtype: torch.dtype, head_dim: int, group: int) -> types.MappingProxyType:
    """The kernel instance for these operands, as the card reports it:
    ``INFO_FIELDS`` (dynamic shared memory per CTA in bytes, resident CTAs
    per SM, tiles in flight per CTA, cache rows per tile, registers per
    thread, query heads per CTA)."""
    info = (ctypes.c_int * len(INFO_FIELDS))()
    build.check(build.library("gqa_decode").gqa_decode_info(
        DTYPE_CODES[dtype], head_dim, group, info), "gqa_decode_info")
    return types.MappingProxyType(dict(zip(INFO_FIELDS, info)))  # cached: read-only


# Registers per thread of each instance, as ptxas reported them for sm_90a
# (CUDA 12.9): bf16 (head-dim bucket, m-blocks) and fp32 (head-dim bucket,
# heads per CTA); and the static shared memory of each family.
_MMA_REGS = {(64, 1): 96, (64, 2): 111, (64, 4): 127, (128, 1): 148, (128, 2): 168,
             (128, 4): 168, (256, 1): 168, (256, 2): 213, (256, 4): 246}
_MMA_STATIC_SMEM = {1: 2064, 2: 1552, 4: 1296}
_SIMT_REGS = {(32, 4): 56, (32, 8): 56, (32, 32): 76, (64, 4): 66, (64, 8): 72, (64, 32): 128,
              (128, 4): 128, (128, 8): 124, (128, 32): 168, (256, 4): 230, (256, 8): 238,
              (256, 32): 255}
_SIMT_STATIC_SMEM = 16
_THREADS, _MMA_ROWS, _SIMT_TILE, _MMA_HEADS = 128, 64, 32, 64


def meta_instance_info(dtype: torch.dtype, head_dim: int, group: int) -> dict:
    """``instance_info`` as the H100 model gives it (``common.H100``): the
    source's dispatch (bf16: head-dim buckets 64/128/256, 16, 32 or 64 heads
    a CTA; fp32: buckets 32/64/128/256, 4, 8 or 32 heads a CTA), its shared
    memory formulas and the registers ptxas reported."""
    if dtype == torch.bfloat16:
        kdh = 64 if head_dim <= 64 else 128 if head_dim <= 128 else 256
        kmb = 1 if group <= 16 else 2 if group <= 32 else 4
        stages = 3 if kdh <= 128 else 2
        stride = 2 * (-(-head_dim // 16) * 16) + 16
        smem = max(stride * (16 * kmb + 2 * stages * _MMA_ROWS),
                   4 * ((_THREADS // 32) * 16 + _MMA_HEADS) * head_dim)
        regs, static, tile, heads = _MMA_REGS[kdh, kmb], _MMA_STATIC_SMEM[kmb], _MMA_ROWS, 16 * kmb
    else:
        kdh = 32 if head_dim <= 32 else 64 if head_dim <= 64 else 128 if head_dim <= 128 else 256
        heads = 4 if group <= 4 else 8 if group <= 8 else 32
        hc = min(group, heads)
        smem = 4 * (hc * kdh + 2 * _SIMT_TILE * (kdh + 4) + hc * (_SIMT_TILE + 1) + 2 * hc)
        regs, static, tile, stages = _SIMT_REGS[kdh, heads], _SIMT_STATIC_SMEM, _SIMT_TILE, 2
    return {"smem_bytes": smem, "ctas_per_sm": ctas_per_sm(_THREADS, regs, smem + static),
            "stages": stages, "tile_rows": tile, "registers": regs, "heads_per_cta": heads}


def plan(dtype: torch.dtype, batch: int, n_kv: int, seq: int, head_dim: int, group: int,
         device_index: int = 0, meta: bool = False):
    """``(n_split, rows_per_split, head_blocks)`` of one call: on the card
    ``device_index``, or with ``meta`` on the H100 model."""
    if meta:
        info, n_sm = meta_instance_info(dtype, head_dim, group), H100["sm_count"]
    else:
        info, n_sm = instance_info(dtype, head_dim, group), _sm_count(device_index)
    heads = min(group, info["heads_per_cta"])
    head_blocks = -(-group // heads)
    n_split, rows = split_plan(batch, n_kv, seq, n_sm, info["ctas_per_sm"],
                               info["tile_rows"], head_blocks, heads, torch.finfo(dtype).bits // 8)
    return n_split, rows, head_blocks


def work(q: torch.Tensor, k: torch.Tensor, rows: int):
    """``(bytes, operations)`` of a call over ``rows`` valid cache rows in
    all: the rows' K and V, q and the output each moved once, the lengths;
    q.k and p.v, two operations a multiply-add (the bound's formula)."""
    B, Hq, Dh = q.shape
    Hkv = k.shape[2]
    rw = 2 * rows * Hkv * Dh * k.element_size() + 2 * nbytes(q) + B * 4
    return rw, 4.0 * rows * (Hq // Hkv) * Hkv * Dh


def _buffers(q: torch.Tensor, n_kv: int, n_split: int, return_lse: bool):
    """The call's output, its lse (or None) and its split partials (empty
    for one split), on q's device."""
    B, Hq, Dh = q.shape
    G = Hq // n_kv
    out = torch.empty_like(q)
    f32 = dict(dtype=torch.float32, device=q.device)
    lse = torch.empty((B, Hq), **f32) if return_lse else None
    many = n_split > 1
    part_ml = torch.empty((B, n_kv, n_split, G, 2) if many else (0,), **f32)
    part_acc = torch.empty((B, n_kv, n_split, G, Dh) if many else (0,), **f32)
    return out, lse, part_ml, part_acc


def gqa_decode_meta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    lengths: torch.Tensor, return_lse: bool = False):
    """The wrapper on meta operands ``ops.gqa_decode`` has checked: what
    :func:`gqa_decode_cuda` allocates (outputs, split partials, a block of
    launch words), planned on the H100 model, and no launch; the call is
    recorded with every slot counted valid (the lengths are on the device)."""
    if q.device.type != "meta":
        raise ValueError(f"the meta branch takes meta tensors, got {q.device}")
    dtype_code(q)
    B, Hq, Dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    n_split, _, head_blocks = plan(q.dtype, B, Hkv, S, Dh, Hq // Hkv, meta=True)
    out, lse, part_ml, part_acc = _buffers(q, Hkv, n_split, return_lse)
    words = (torch.zeros(max(B * Hkv * head_blocks, 1024), dtype=torch.int32, device=q.device)
             if n_split > 1 else None)
    rw, ops = work(q, k, B * S)
    record_call("gqa_decode_lse" if return_lse else "gqa_decode", 1, ops, rw, q.dtype)
    del part_ml, part_acc, words
    return (out, lse) if return_lse else out


def gqa_decode_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    lengths: torch.Tensor, return_lse: bool = False):
    """Launch the kernel on operands ``ops.gqa_decode`` has checked; with
    ``return_lse`` also the (B, Hq) fp32 log-sum-exp, as ``(out, lse)``."""
    global LAUNCHES, LAUNCHES_LSE
    code = cuda_dtype_code(q)
    B, Hq, Dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    n_split, rows, head_blocks = plan(q.dtype, B, Hkv, S, Dh, G, q.device.index or 0)
    out, lse, part_ml, part_acc = _buffers(q, Hkv, n_split, return_lse)
    many = n_split > 1
    lib = build.library("gqa_decode")
    with torch.cuda.device(q.device):
        counters = (stream_words(_COUNTERS, q.device, B * Hkv * head_blocks, 1024)
                    if many else None)
        rc = lib.gqa_decode_launch(
            code, q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), part_ml.data_ptr(), part_acc.data_ptr(),
            None if counters is None else counters.data_ptr(), B, S, Hkv, G, Dh, n_split, rows,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    build.check(rc, "gqa_decode")
    if return_lse:
        LAUNCHES_LSE += 1
        return out, lse
    LAUNCHES += 1
    return out
