"""Plain PyTorch version of the chunked SSD kernel
(``repro/kernels/ssd/ref.py::ssd_ref``): ``core/ssd.py::ssd_chunked`` on
its sequential carry chain, with the final state. The CPU path of
``ops.ssd`` runs it, and ``chip_smoke.py`` holds the kernel to it on the
card.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.ssd import ssd_chunked


def ssd_ref(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    B_: torch.Tensor,
    C_: torch.Tensor,
    D: Optional[torch.Tensor] = None,
    *,
    chunk: int = 64,
    initial_state: Optional[torch.Tensor] = None,
):
    """Returns (y (B,S,H,P) in x's dtype, final state (B,H,N,P) fp32)."""
    return ssd_chunked(
        x, dt, A, B_, C_, D,
        chunk=chunk,
        initial_state=initial_state,
        engine="sequential",
        return_final_state=True,
    )
