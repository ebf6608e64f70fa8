"""Plain PyTorch versions of the linear-scan kernels
(``repro/kernels/linear_scan/ref.py::linear_scan_ref`` and the VJP of
``repro/kernels/linear_scan/ops.py``), and the kernels' chunk plan.

``linear_scan_ref`` repeats the forward kernel's arithmetic step by step:
operands widened to fp32, an fp32 carry, each ``c_t`` stored in ``b``'s
dtype, the product and the sum rounded separately, as the kernel rounds
them. With ``chunk=None`` it walks all of T from ``c0``. With an int it
repeats the chunked kernel: T cut into chunks of ``chunk`` steps; each
chunk's aggregate ``A_k`` (the product of its ``a`` in time order) and
``B_k`` (its scan from carry 0); the carry into chunk k is ``c0`` folded
through ``A_j * c + B_j`` for j = 0 .. k-1 in that order; then the chunk's
walk from that carry. For T <= ``chunk`` the two are the same arithmetic.

``linear_scan_bwd_ref`` is the fused backward: the reverse-time scan
``cbar_t = g_t + a_{t+1} * cbar_{t+1}`` (``a_T = 0``), chunked the same way
in reverse time, with ``cbar`` stored in ``g``'s dtype and the products
``da_t = cbar_t * c_{t-1}`` (``c_{-1} = c0``), ``dc0 = a_0 * cbar_0`` taken
of the stored value, as JAX's ``_bwd_rule`` takes them.

The CPU path of the kernels' wrappers runs these with
``chunk=chunk_len(T)``, and ``chip_smoke.py`` holds the CUDA kernels to
them bit for bit.
"""
from __future__ import annotations

from typing import Optional

import torch

#: Steps per chunk of the CUDA kernels.
CHUNK = 64


def chunk_len(T: int) -> int:
    """Steps per chunk of the kernels for a T-step scan: ``CHUNK``, or T
    when it is shorter (one chunk: every decode step, a prompt of up to 64).
    A function of T alone, never of F, the dtype, the card or alignment, so
    a column's result does not depend on the other columns."""
    return min(T, CHUNK)


def _walk(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, out_dtype) -> torch.Tensor:
    """Steps along axis 0 from the fp32 carry ``c``; each step stored in
    ``out_dtype``. Any further axes are walked together."""
    cs = []
    for t in range(a.shape[0]):
        c = a[t].float() * c + b[t].float()
        cs.append(c.to(out_dtype))
    return torch.stack(cs)


def linear_scan_ref(a: torch.Tensor, b: torch.Tensor, c0: torch.Tensor,
                    chunk: Optional[int] = None) -> torch.Tensor:
    """c_t = a_t * c_{t-1} + b_t over axis 0; a, b: (T, F); c0: (F,).
    ``chunk``: None walks all of T; an int repeats the chunked kernel."""
    T = a.shape[0]
    if T == 0:
        return b.new_empty(b.shape)
    if chunk is None or T <= chunk:
        return _walk(a, b, c0.float(), b.dtype)
    n = -(-T // chunk)
    pad = n * chunk - T
    # (chunk, n, F): step r of every chunk side by side. The padded steps
    # (a = 1, b = 0) lie past the end of the last chunk, whose aggregate no
    # chunk reads, and their outputs are dropped.
    a_c = torch.cat([a.float(), a.new_ones((pad,) + a.shape[1:], dtype=torch.float32)])
    b_c = torch.cat([b.float(), b.new_zeros((pad,) + b.shape[1:], dtype=torch.float32)])
    a_c = a_c.reshape((n, chunk) + a.shape[1:]).transpose(0, 1)
    b_c = b_c.reshape((n, chunk) + b.shape[1:]).transpose(0, 1)
    A = torch.ones_like(a_c[0])
    B = torch.zeros_like(b_c[0])
    for r in range(chunk):
        A = A * a_c[r]
        B = a_c[r] * B + b_c[r]
    carry = [c0.float()]
    for k in range(n - 1):
        carry.append(A[k] * carry[k] + B[k])
    c = _walk(a_c, b_c, torch.stack(carry), b.dtype)     # (chunk, n, F)
    return c.transpose(0, 1).reshape((n * chunk,) + b.shape[1:])[:T]


def linear_scan_bwd_ref(a: torch.Tensor, c: torch.Tensor, c0: torch.Tensor, g: torch.Tensor,
                        chunk: Optional[int] = None):
    """The VJP of ``c = linear_scan_ref(a, b, c0)`` at cotangent ``g``:
    ``(da, db, dc0)`` in the operands' dtypes. ``chunk`` as in the forward,
    applied to the reverse-time scan."""
    a_next = torch.cat([a[1:], torch.zeros_like(a[:1])])
    cbar = linear_scan_ref(a_next.flip(0), g.flip(0), torch.zeros_like(c0),
                           chunk=chunk).flip(0)              # stored in g's dtype
    c_prev = torch.cat([c0[None], c[:-1]])
    return cbar * c_prev, cbar, a[0] * cbar[0]
