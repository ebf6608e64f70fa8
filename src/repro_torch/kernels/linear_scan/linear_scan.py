"""Linear-scan kernels: wrappers of the CUDA kernels in ``csrc/linear_scan.cu``
that replace ``repro/kernels/linear_scan/linear_scan.py::linear_scan_pallas``
(the forward) and the reverse-time call of its VJP (the backward).

``c_t = a_t * c_{t-1} + b_t`` over ``(T, F)``: operands widened to fp32, an
fp32 carry, each ``c_t`` stored in ``b``'s dtype. The TPU kernel's time
block and its two in-block schedules (``sequential``, ``hillis_steele``)
chose how the TPU evaluated one function; on the card T is cut into chunks
of ``ref.chunk_len(T)`` steps, one CTA per (chunk, 32-thread column
tile), and a chunk's carry is ``c0`` folded through its predecessors'
aggregates in a fixed order (``ref.py`` says the arithmetic), so neither
is an argument here.

A CUDA tensor launches the kernel (or raises); a CPU tensor runs the plain
version (``ref.py``, with the kernel's chunk length); a meta tensor takes
the wrapper's meta branch (``kernels/common.py``: the same checks, output
and scratch, no launch, the call recorded). ``LAUNCHES`` counts kernel
launches, forward and backward alike.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (check_operand, cuda_dtype_code, dtype_code, nbytes,
                                        record_call, stream_words)
from repro_torch.kernels.linear_scan.ref import chunk_len, linear_scan_bwd_ref, linear_scan_ref

LAUNCHES = 0
THREADS = 32        # one warp per CTA
AGG_BYTES = 16      # one thread's aggregate record: (A, A, B, B) in fp32

# (device index, stream) -> a 64-bit ticket word and ready flags
# (``common.stream_words``). The kernel never needs them zeroed again: each
# launch takes a new epoch from the ticket word and tags its flags with it.
_SYNC = {}


class Plan(NamedTuple):
    chunk: int      # steps per chunk
    n_chunks: int
    vec_bytes: int  # bytes of columns a thread copies and walks: 4 (one fp32, a bf16 pair) or 2
    n_tiles: int    # column tiles of THREADS * vec_bytes bytes
    ctas: int


def plan(T: int, F: int, dtype: torch.dtype, aligned4: bool = True) -> Plan:
    """The launch the C entry makes for one call, for reports: T in chunks
    of ``chunk_len(T)``, one CTA per (chunk, tile of 32 threads' columns).
    Each thread copies and walks 4 bytes of columns (one fp32, or a bf16
    pair where F is even and every pointer is 4-byte aligned), else one
    bf16 column. None of it changes a column's arithmetic, which is the
    chunk length's alone."""
    esize = torch.finfo(dtype).bits // 8
    chunk = chunk_len(T)
    n_chunks = -(-T // chunk)
    vec = 4 if aligned4 and F * esize % 4 == 0 else esize
    n_tiles = -(-F // (THREADS * vec // esize))
    return Plan(chunk, n_chunks, vec, n_tiles, n_chunks * n_tiles)


def _scratch(T: int, F: int, device: torch.device):
    """(chunk, sync buffer, aggregate records) for a call; no scratch for
    one chunk. Sized for a column a thread, the most tiles the C entry can
    choose."""
    chunk = chunk_len(T)
    n_chunks = -(-T // chunk)
    if n_chunks == 1:
        return chunk, None, None
    n_tiles = -(-F // THREADS)
    if device.type == "meta":  # the card keeps one such block a stream
        sync = torch.zeros(max(2 + n_chunks * n_tiles, 2 + 4096), dtype=torch.int32,
                           device=device)
    else:
        sync = stream_words(_SYNC, device, 2 + n_chunks * n_tiles, 2 + 4096)
    agg = torch.empty((n_chunks - 1) * n_tiles * THREADS * AGG_BYTES // 4,
                      dtype=torch.float32, device=device)
    return chunk, sync, agg


def _ptr(t):
    return None if t is None else t.data_ptr()


def _meta(name, a, tensors, outs, ops):
    """Record a meta call that reads ``tensors`` and writes ``outs``."""
    record_call(name, 1, ops, nbytes(*tensors) + nbytes(*outs), a.dtype)


def linear_scan_kernel(a: torch.Tensor, b: torch.Tensor, c0: torch.Tensor) -> torch.Tensor:
    """a, b: (T, F); c0: (F,); all of one dtype (fp32 or bf16) and
    contiguous. Returns c: (T, F) in b's dtype."""
    if a.device.type == "cpu":
        return linear_scan_ref(a, b, c0, chunk=chunk_len(a.shape[0]))
    global LAUNCHES
    meta = a.device.type == "meta"
    code = dtype_code(a) if meta else cuda_dtype_code(a)
    if a.dim() != 2:
        raise ValueError(f"a: expected (T, F), got shape {tuple(a.shape)}")
    T, F = a.shape
    check_operand(a, "a", (T, F), a)
    check_operand(b, "b", (T, F), a)
    check_operand(c0, "c0", (F,), a)
    out = torch.empty_like(b)
    if meta:
        _scratch(T, F, a.device)  # made and dropped, as the launch's
        _meta("linear_scan", a, (a, b, c0), (out,), 2.0 * T * F)
        return out
    lib = build.library("linear_scan")
    with torch.cuda.device(a.device):
        chunk, sync, agg = _scratch(T, F, a.device)
        rc = lib.linear_scan_launch(
            code, a.data_ptr(), b.data_ptr(), c0.data_ptr(), out.data_ptr(), T, F, chunk,
            _ptr(sync), _ptr(agg), torch.cuda.current_stream(a.device).cuda_stream,
        )
    build.check(rc, "linear_scan")
    LAUNCHES += 1
    return out


def linear_scan_bwd(a: torch.Tensor, c: torch.Tensor, c0: torch.Tensor, g: torch.Tensor):
    """The VJP of ``c = linear_scan_kernel(a, b, c0)`` at cotangent ``g``, in
    one launch: ``(da, db, dc0)``, in the operands' dtype. a, c, g: (T, F);
    c0: (F,); one dtype, contiguous."""
    if a.device.type == "cpu":
        return linear_scan_bwd_ref(a, c, c0, g, chunk=chunk_len(a.shape[0]))
    global LAUNCHES
    meta = a.device.type == "meta"
    code = dtype_code(a) if meta else cuda_dtype_code(a)
    if a.dim() != 2:
        raise ValueError(f"a: expected (T, F), got shape {tuple(a.shape)}")
    T, F = a.shape
    for t, name in ((a, "a"), (c, "c"), (g, "g")):
        check_operand(t, name, (T, F), a)
    check_operand(c0, "c0", (F,), a)
    da, db, dc0 = torch.empty_like(a), torch.empty_like(a), torch.empty_like(c0)
    if meta:
        _scratch(T, F, a.device)  # made and dropped, as the launch's
        _meta("linear_scan", a, (a, c, c0, g), (da, db, dc0), 3.0 * T * F)
        return da, db, dc0
    lib = build.library("linear_scan")
    with torch.cuda.device(a.device):
        chunk, sync, agg = _scratch(T, F, a.device)
        rc = lib.linear_scan_bwd_launch(
            code, a.data_ptr(), c.data_ptr(), c0.data_ptr(), g.data_ptr(), da.data_ptr(),
            db.data_ptr(), dc0.data_ptr(), T, F, chunk, _ptr(sync), _ptr(agg),
            torch.cuda.current_stream(a.device).cuda_stream,
        )
    build.check(rc, "linear_scan_bwd")
    LAUNCHES += 1
    return da, db, dc0
