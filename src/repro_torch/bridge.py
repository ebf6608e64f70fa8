"""Weight and cache bridge between the JAX package and the port.

The port's params and caches are nested dicts with the JAX package's keys
and layouts (lane-major ``(d, 3, H)`` slabs, ``w_skip: None`` included). The
JAX side hands them over as numpy arrays (``jax.tree_util.tree_map(np.asarray,
params)``), since the port imports nothing of JAX. fp32 and integer arrays
round-trip bitwise (the int8 gate slabs cross as ``torch.int8``); bfloat16
crosses as float32, which holds it exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.fused_rnn.layout import cast_params


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return None if tree is None else fn(tree)


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
    tree = _map(tree, _from_numpy(device))
    return tree if dtype is None else cast_params(tree, dtype)


def params_to_numpy(tree):
    """The port's params -> numpy arrays with the same keys."""
    return _map(tree, _to_numpy)


# Decode caches (``lm_init_caches`` layout) are nested dicts of arrays too.
caches_from_numpy = params_from_numpy
caches_to_numpy = params_to_numpy
