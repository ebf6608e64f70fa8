"""Gradient compression with error feedback, from ``repro/optim/compression.py``.

Gradients are quantized to bf16 or int8 (one absmax scale per tensor) and the
residual is added back on the next step (EF-SGD style), so compression error
does not accumulate. On one device there is no cross-pod reduction to
shrink; the numerics (quantize -> dequantize + error feedback) are the JAX
package's.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.tree import tree_map


def ef_init(params) -> Dict:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def _quant_dequant(g: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "bf16":
        return g.to(torch.bfloat16).float()
    if mode == "int8":
        absmax = torch.clamp(torch.max(torch.abs(g)), min=1e-12)
        scale = absmax / 127.0
        q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
        return q.float() * scale
    raise ValueError(f"unknown compression mode {mode!r}")


@torch.no_grad()
def compress_grads(
    grads, ef_state: Optional[Dict], mode: Optional[str]
) -> Tuple[Dict, Optional[Dict]]:
    """Returns (compressed grads, new error-feedback state)."""
    if mode is None or mode == "none":
        return grads, ef_state
    corrected = tree_map(lambda g, e: g.float() + e, grads, ef_state)
    new_g = tree_map(lambda c: _quant_dequant(c, mode), corrected)
    new_e = tree_map(lambda c, q: c - q, corrected, new_g)
    return new_g, new_e
