"""Decode-attention kernel: wrapper of the CUDA kernel in
``csrc/gqa_decode.cu`` that replaces
``repro/kernels/gqa_decode/gqa_decode.py::gqa_decode_pallas``.

The TPU kernel walked the cache in ``block_s`` blocks inside one program per
(lane, KV head); the CUDA kernel cuts the cache into splits that run in
parallel (``split_plan``) and combines them in a second pass, so the block
size is not an argument. ``LAUNCHES`` counts calls that launched the kernel
(one or, with several splits, two CUDA kernels each).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import DTYPE_CODES, cuda_dtype_code

LAUNCHES = 0
CTAS_PER_SM = 4      # splits are sized for about this many CTAs per SM
MIN_SPLIT_ROWS = 32  # one tile of the kernel


def split_plan(batch: int, n_kv: int, seq: int, n_sm: int):
    """``(n_split, rows_per_split)`` for a ``seq``-row cache: enough splits
    for about ``CTAS_PER_SM`` CTAs per SM over the ``batch * n_kv`` (lane,
    head) pairs, each split a whole number of 32-row tiles. Chosen from the
    cache's capacity, not the lengths, which stay on the device."""
    want = max(1, -(-CTAS_PER_SM * n_sm // (batch * n_kv)))
    rows = -(-seq // want)
    rows = max(MIN_SPLIT_ROWS, -(-rows // MIN_SPLIT_ROWS) * MIN_SPLIT_ROWS)
    return -(-seq // rows), rows


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def instance_info(dtype: torch.dtype, head_dim: int, group: int):
    """``(dynamic shared memory bytes per CTA, resident CTAs per SM)`` of
    the kernel instance for these operands, as the card reports them."""
    info = (ctypes.c_int * 2)()
    build.check(build.library("gqa_decode").gqa_decode_info(
        DTYPE_CODES[dtype], head_dim, group, info), "gqa_decode_info")
    return info[0], info[1]


def gqa_decode_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on operands ``ops.gqa_decode`` has checked."""
    global LAUNCHES
    code = cuda_dtype_code(q)
    B, Hq, Dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    n_split, rows = split_plan(B, Hkv, S, _sm_count(q.device.index or 0))
    out = torch.empty_like(q)
    f32 = dict(dtype=torch.float32, device=q.device)
    part_ml = torch.empty((B, Hkv, n_split, G, 2) if n_split > 1 else (0,), **f32)
    part_acc = torch.empty((B, Hkv, n_split, G, Dh) if n_split > 1 else (0,), **f32)
    lib = build.library("gqa_decode")
    with torch.cuda.device(q.device):
        rc = lib.gqa_decode_launch(
            code, q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            part_ml.data_ptr(), part_acc.data_ptr(), B, S, Hkv, G, Dh, n_split, rows,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    build.check(rc, "gqa_decode")
    LAUNCHES += 1
    return out
