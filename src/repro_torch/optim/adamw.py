"""AdamW, from ``repro/optim/adamw.py``: configurable moment dtype, global-norm
clipping, decoupled weight decay on matrices only (ndim >= 2), and a cosine
schedule with linear warmup. The moment math is fp32 whatever the moments'
storage dtype, as in JAX.

Plain functions on trees of dicts of tensors. ``adamw_update`` writes the
new params and moments into the tensors it is given (under
``torch.no_grad()``) and returns those same trees: the port's form of the
JAX train step's ``donate_argnums=(0,)``. The values are JAX's.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.distribution.sharding import spec_axes
from repro_torch.tree import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor  # () int32
    m: Dict
    v: Dict


def _moment_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def adamw_init(params, moment_dtype: str = "float32") -> AdamWState:
    dt = _moment_dtype(moment_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    step_device = tree_leaves(params)[0].device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=step_device),
        m=tree_map(zeros, params),
        v=tree_map(zeros, params),
    )


def global_norm(tree, mesh=None, specs=None) -> torch.Tensor:
    """The L2 norm of the whole tree. Under ``mesh`` the leaves are this
    rank's shards under ``specs``: each leaf's sum of squares is summed over
    the axes it is sharded on (:func:`sharding.spec_axes`), so a replicated
    leaf counts once and the norm is JAX's over the whole tree. Leaves
    sharded on the same axes are reduced together, one collective a set."""
    if mesh is None:
        leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
        return torch.sqrt(torch.sum(torch.stack(leaves)))
    by_axes: Dict[tuple, list] = {}
    for x, spec in zip(tree_leaves(tree), tree_leaves(specs)):
        axes = tuple(a for a in spec_axes(spec) if mesh.shape[a] > 1)
        by_axes.setdefault(axes, []).append(torch.sum(torch.square(x.float())))
    total = 0.0
    for axes in sorted(by_axes):
        part = torch.sum(torch.stack(by_axes[axes]))
        for a in axes:
            part = mesh.axis(a).all_reduce(part)
        total = total + part
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(
    grads,
    state: AdamWState,
    params,
    lr: torch.Tensor,
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    clip_norm: float = 1.0,
    mesh=None,
    specs=None,
) -> Tuple[Dict, AdamWState, Dict]:
    """One step. ``params``, ``state.m``, ``state.v`` and ``state.step`` are
    updated in place and returned with the metrics ``grad_norm`` and ``lr``.
    Under ``mesh`` every tree holds this rank's shards under ``specs``: the
    update is elementwise, and only the clip's norm crosses ranks."""
    step = state.step + 1
    gnorm = global_norm(grads, mesh, specs)
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)

    stepf = step.float()
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=step.device), stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=step.device), stepf)

    def upd(p, g, m, v):
        # JAX's expressions, each product and sum the same, written in place
        # where an operand is dead, so at most four temporaries of the leaf's
        # size live at once (a mixtral-8x22b expert leaf is 3.2 GB in fp32).
        g = g.float() * scale
        m32 = m.float() * b1
        m32 += (1 - b1) * g
        v32 = v.float() * b2
        v32 += ((1 - b2) * g).mul_(g)
        del g
        m.copy_(m32)
        v.copy_(v32)
        delta = m32.div_(bc1).div_(v32.div_(bc2).sqrt_().add_(eps))  # mhat / (sqrt(vhat) + eps)
        del v32
        if p.dim() >= 2:  # decoupled decay on matrices only
            delta += p.float() * weight_decay
        p.copy_(p.float() - delta.mul_(lr))

    tree_map(upd, params, grads, state.m, state.v)
    state.step.copy_(step)
    return params, state, {"grad_norm": gnorm, "lr": lr}


def cosine_schedule(base_lr: float, warmup: int, total: int, min_frac: float = 0.1):
    """``lr(step)`` for a () int tensor ``step``, in fp32 on its device."""

    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = base_lr * torch.clamp((step + 1) / max(warmup, 1), max=1.0)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, base_lr * cos)

    return lr
