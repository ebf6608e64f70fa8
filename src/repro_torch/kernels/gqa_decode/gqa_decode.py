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
"""
from __future__ import annotations

import ctypes
import functools
import math
import types

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import DTYPE_CODES, cuda_dtype_code, stream_words

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


def plan(dtype: torch.dtype, batch: int, n_kv: int, seq: int, head_dim: int, group: int,
         device_index: int = 0):
    """``(n_split, rows_per_split, head_blocks)`` of one call."""
    info = instance_info(dtype, head_dim, group)
    heads = min(group, info["heads_per_cta"])
    head_blocks = -(-group // heads)
    n_split, rows = split_plan(batch, n_kv, seq, _sm_count(device_index), info["ctas_per_sm"],
                               info["tile_rows"], head_blocks, heads, torch.finfo(dtype).bits // 8)
    return n_split, rows, head_blocks


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
    out = torch.empty_like(q)
    f32 = dict(dtype=torch.float32, device=q.device)
    lse = torch.empty((B, Hq), **f32) if return_lse else None
    many = n_split > 1
    part_ml = torch.empty((B, Hkv, n_split, G, 2) if many else (0,), **f32)
    part_acc = torch.empty((B, Hkv, n_split, G, Dh) if many else (0,), **f32)
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
