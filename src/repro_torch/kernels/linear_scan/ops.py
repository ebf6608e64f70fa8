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

JAX's ``_bwd_rule`` runs its forward kernel on time-flipped operands and
takes the products outside it; here one kernel launch
(``linear_scan.linear_scan_bwd``) walks time down, reads ``a_{t+1}``,
``c_{t-1}`` and ``g`` in place and writes all three gradients.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.linear_scan.linear_scan import linear_scan_bwd, linear_scan_kernel


class _LinearScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, c0):
        c = linear_scan_kernel(a, b, c0)
        ctx.save_for_backward(a, c, c0)
        return c

    @staticmethod
    def backward(ctx, g):
        a, c, c0 = ctx.saved_tensors
        return linear_scan_bwd(a, c, c0, g.contiguous())


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
