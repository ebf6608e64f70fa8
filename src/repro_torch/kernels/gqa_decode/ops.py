"""Public entry of decode-shape GQA attention (``repro/kernels/gqa_decode/ops.py``).

``gqa_decode(q, k, v, lengths)`` checks its operands, then runs the CUDA
kernel (``gqa_decode.py``) on CUDA tensors, the plain version (``ref.py``)
on CPU tensors and the wrapper's meta branch on meta tensors
(``kernels/common.py``); any other device raises. ``return_lse=True`` also returns the
log-sum-exp of each (lane, query head) and takes lengths of 0: the form a
shard of a sequence-sharded cache runs, whose partials are combined across
ranks. JAX's ``block_s`` and ``interpret`` arguments
are not carried over: the block size chose how the TPU walked the cache and
changes no value.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import DTYPE_CODES, check_operand
from repro_torch.kernels.gqa_decode.gqa_decode import gqa_decode_cuda, gqa_decode_meta
from repro_torch.kernels.gqa_decode.ref import gqa_decode_ref

HEAD_DIM_STEP = 8   # a head dim is a whole number of 16-byte bf16 row pieces
MAX_HEAD_DIM = 256  # the kernel's largest head-dim bucket


def check_operands(q, k, v, lengths) -> None:
    """Raise on what the kernel does not take, on either device."""
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError(f"q (B, Hq, Dh) and k (B, S, Hkv, Dh) expected, got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    B, Hq, Dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"q: float32 or bfloat16 expected, got {q.dtype}")
    if Hq % Hkv:
        raise ValueError(f"Hq = {Hq} query heads do not group over Hkv = {Hkv} KV heads")
    if Dh % HEAD_DIM_STEP or not 0 < Dh <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {Dh} unsupported; the kernel takes a multiple of "
                         f"{HEAD_DIM_STEP} up to {MAX_HEAD_DIM}")
    check_operand(q, "q", (B, Hq, Dh), q)
    check_operand(k, "k", (B, S, Hkv, Dh), q)
    check_operand(v, "v", (B, S, Hkv, Dh), q)
    check_operand(lengths, "lengths", (B,), q, dtype=torch.int32)
    if q.device.type == "cuda" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k, v: the kernel reads 16-byte aligned rows")


def gqa_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               lengths: torch.Tensor, return_lse: bool = False):
    """One-token GQA attention over a KV cache. q: (B, Hq, Dh); k, v:
    (B, S, Hkv, Dh); lengths: (B,) int32 on q's device, each in [1, S] (in
    [0, S] with ``return_lse``). Returns (B, Hq, Dh) in q's dtype; with
    ``return_lse`` also the (B, Hq) fp32 log-sum-exp of the scaled scores
    (``-inf`` and a zero output for a length of 0), as ``(out, lse)``."""
    check_operands(q, k, v, lengths)
    if q.device.type == "cpu":
        return gqa_decode_ref(q, k, v, lengths, return_lse)
    if q.device.type == "meta":
        return gqa_decode_meta(q, k, v, lengths, return_lse)
    return gqa_decode_cuda(q, k, v, lengths, return_lse)
