"""Public wrapper of the linear-scan kernel (``repro/kernels/linear_scan/ops.py``).

``linear_scan`` takes any trailing feature dims, flattens them to ``(T, F)``,
runs the kernel and reshapes back. ``core/scan.py`` uses it for
``engine="pallas"`` (and for a bare recurrence under ``fused``/``fused_stack``).
F is not padded: the TPU padded it to 128 lanes, the kernel masks the
ragged edge.

Differentiable: the adjoint of a first-order linear recurrence is the same
recurrence run in reverse time,

    cbar_t = g_t + a_{t+1} * cbar_{t+1}
    da_t   = cbar_t * c_{t-1},   db_t = cbar_t,   dc0 = a_0 * cbar_0

so the backward runs the same kernel on time-flipped operands (the JAX
package's ``_bwd_rule``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.linear_scan.linear_scan import linear_scan_kernel


class _LinearScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, c0):
        c = linear_scan_kernel(a, b, c0)
        ctx.save_for_backward(a, c, c0)
        return c

    @staticmethod
    def backward(ctx, g):
        a, c, c0 = ctx.saved_tensors
        a_next = torch.cat([a[1:], torch.zeros_like(a[:1])], dim=0)
        cbar = linear_scan_kernel(
            a_next.flip(0), g.flip(0).contiguous(), torch.zeros_like(c0)
        ).flip(0)
        c_prev = torch.cat([c0[None], c[:-1]], dim=0)
        return cbar * c_prev, cbar, a[0] * cbar[0]


def linear_scan(
    a: torch.Tensor,
    b: torch.Tensor,
    c0: torch.Tensor,
    *,
    block_size: int = 128,
) -> torch.Tensor:
    """c_t = a_t * c_{t-1} + b_t; time axis 0, any trailing dims.
    ``block_size`` is the JAX signature's; on the card it changes no value."""
    del block_size
    T = a.shape[0]
    c = _LinearScan.apply(
        a.reshape(T, -1).contiguous(), b.reshape(T, -1).contiguous(), c0.reshape(-1).contiguous()
    )
    return c.reshape(b.shape)
