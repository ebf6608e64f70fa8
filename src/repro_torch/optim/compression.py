"""Gradient compression with error feedback, from ``repro/optim/compression.py``.

Gradients are quantized to bf16 or int8 (one absmax scale per tensor) and the
residual is added back on the next step (EF-SGD style), so compression error
does not accumulate. The port's collectives run uncompressed; the numerics
(quantize -> dequantize + error feedback) are the JAX package's. Under a
mesh the grads and the error-feedback state are this rank's shards, held
as the params are: bf16 is elementwise, and int8's absmax is taken over the
whole leaf, a maximum over the axes the leaf is sharded on.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.distribution.sharding import spec_axes
from repro_torch.tree import tree_leaves, tree_map, unflatten_like


def ef_init(params) -> Dict:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def _quant_dequant(g: torch.Tensor, mode: str, absmax=None) -> torch.Tensor:
    if mode == "bf16":
        return g.to(torch.bfloat16).float()
    if mode == "int8":
        absmax = torch.clamp(torch.max(torch.abs(g)) if absmax is None else absmax, min=1e-12)
        scale = absmax / 127.0
        q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
        return q.float() * scale
    raise ValueError(f"unknown compression mode {mode!r}")


def _whole_absmax(tree, mesh, specs) -> list:
    """Each leaf's absmax over the whole leaf: its shard's, then the maximum
    over the axes it is sharded on, leaves of one set of axes together."""
    leaves, spec_list = tree_leaves(tree), tree_leaves(specs)
    out = [torch.max(torch.abs(x)) for x in leaves]
    by_axes: Dict[tuple, list] = {}
    for i, spec in enumerate(spec_list):
        axes = tuple(a for a in spec_axes(spec) if mesh.shape[a] > 1)
        if axes:
            by_axes.setdefault(axes, []).append(i)
    for axes in sorted(by_axes):
        idx = by_axes[axes]
        m = torch.stack([out[i] for i in idx])
        for a in axes:
            m = mesh.axis(a).all_reduce(m, op="max")
        for j, i in enumerate(idx):
            out[i] = m[j]
    return out


@torch.no_grad()
def compress_grads(
    grads, ef_state: Optional[Dict], mode: Optional[str], *, mesh=None, specs=None
) -> Tuple[Dict, Optional[Dict]]:
    """Returns (compressed grads, new error-feedback state). ``mesh`` /
    ``specs``: the trees are this rank's shards (module docstring)."""
    if mode is None or mode == "none":
        return grads, ef_state
    corrected = tree_map(lambda g, e: g.float() + e, grads, ef_state)
    if mode == "int8" and mesh is not None:
        absmax = iter(_whole_absmax(corrected, mesh, specs))
        new_g = unflatten_like(corrected, [_quant_dequant(c, mode, next(absmax))
                                           for c in tree_leaves(corrected)])
    else:
        new_g = tree_map(lambda c: _quant_dequant(c, mode), corrected)
    new_e = tree_map(lambda c, q: c - q, corrected, new_g)
    return new_g, new_e
