"""Weight and cache bridge between the JAX package and the port.

The port's params and caches are nested dicts with the JAX package's keys
and layouts (lane-major ``(d, 3, H)`` slabs, ``w_skip: None`` included). The
JAX side hands them over as numpy arrays (``jax.tree_util.tree_map(np.asarray,
params)``), since the port imports nothing of JAX. fp32 and integer arrays
round-trip bitwise (the int8 gate slabs cross as ``torch.int8``); bfloat16
crosses as float32, which holds it exactly. A train state crosses the same
way, leaf for leaf (``train_state_from_numpy`` / ``train_state_to_numpy``),
so a test can start both frameworks from one JAX ``init_train_state``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.fused_rnn.layout import cast_params
from repro_torch.optim.adamw import AdamWState
from repro_torch.training.steps import TrainState
from repro_torch.tree import tree_map


def _from_numpy(device):
    def leaf(a):
        arr = np.asarray(a)
        if arr.dtype.name == "bfloat16":
            t = torch.tensor(arr.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.tensor(arr)
        return t.to(device)

    return leaf


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def params_from_numpy(tree, *, device, dtype=None):
    """JAX params as numpy -> the port's params on ``device``; ``dtype``
    casts the floating leaves by the quantization layout's rule
    (``layout.cast_params``: int8 slabs and the fp32 ``wq_scale`` stay as
    they are)."""
    tree = tree_map(_from_numpy(device), tree)
    return tree if dtype is None else cast_params(tree, dtype)


def params_to_numpy(tree):
    """The port's params -> numpy arrays with the same keys."""
    return tree_map(_to_numpy, tree)


# Decode caches (``lm_init_caches`` layout) are nested dicts of arrays too.
caches_from_numpy = params_from_numpy
caches_to_numpy = params_to_numpy


def train_state_from_numpy(state, *, device) -> TrainState:
    """A JAX ``TrainState`` as numpy (``jax.tree_util.tree_map(np.asarray,
    state)``: fields ``params``, ``opt`` = (``step``, ``m``, ``v``), ``ef``)
    -> the port's ``TrainState`` on ``device``, every leaf bitwise."""
    leaf = _from_numpy(device)
    opt = AdamWState(step=leaf(state.opt.step), m=tree_map(leaf, state.opt.m),
                     v=tree_map(leaf, state.opt.v))
    return TrainState(params=tree_map(leaf, state.params), opt=opt,
                      ef=tree_map(leaf, state.ef))


def train_state_to_numpy(state: TrainState) -> TrainState:
    """The port's ``TrainState`` -> the same NamedTuples holding numpy arrays."""
    opt = AdamWState(step=_to_numpy(state.opt.step), m=tree_map(_to_numpy, state.opt.m),
                     v=tree_map(_to_numpy, state.opt.v))
    return TrainState(params=tree_map(_to_numpy, state.params), opt=opt,
                      ef=tree_map(_to_numpy, state.ef))
