"""Plain PyTorch version of the linear-scan kernel
(``repro/kernels/linear_scan/ref.py::linear_scan_ref``).

It repeats the kernel's arithmetic step by step: operands widened to fp32,
an fp32 carry for all T, each ``c_t`` stored in ``b``'s dtype. The product
and the sum are rounded separately, as the kernel rounds them. The CPU path
of the kernel's wrapper runs it, and ``chip_smoke.py`` holds the kernel to
it on the card.
"""
from __future__ import annotations

import torch


def linear_scan_ref(a: torch.Tensor, b: torch.Tensor, c0: torch.Tensor) -> torch.Tensor:
    """c_t = a_t * c_{t-1} + b_t over axis 0; a, b: (T, F); c0: (F,)."""
    c = c0.float()
    cs = []
    for t in range(a.shape[0]):
        c = a[t].float() * c + b[t].float()
        cs.append(c.to(b.dtype))
    return torch.stack(cs) if cs else b.new_empty(b.shape)
