"""Serving step builders, from ``repro/training/steps.py``
(``build_prefill_step``, ``build_decode_step``).

Each builder closes over the config and returns a plain function that runs
under ``torch.inference_mode()``. The training steps come with the training
slice.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models import lm


def build_prefill_step(cfg, *, batch: int, max_len: int, device="cuda"):
    """``prefill_step(params, inputs) -> (logits, caches)``: fresh zero caches
    on ``device``, then one MTS prefill over the prompt."""

    def prefill_step(params, inputs: Dict):
        with torch.inference_mode():
            caches = lm.lm_init_caches(cfg, batch, max_len, device=device)
            return lm.lm_prefill(params, cfg, inputs, caches)

    return prefill_step


def _copy_into(dst, src):
    for k, v in src.items():
        if isinstance(v, dict):
            _copy_into(dst[k], v)
        else:
            dst[k].copy_(v)


def build_decode_step(cfg):
    """``decode_step(params, caches, token) -> (logits, caches)``. The caches
    are updated in place and returned: the port's form of the JAX package's
    ``donate_argnums``, which keeps every cache buffer where it is. Attention
    layers write their new K/V row in place (``models/attention.py``) and
    Mamba layers their conv tails and SSM state (``models/mamba.py``), so
    nothing is copied for them; the small RNN caches come back new and are
    copied into the old buffers."""

    def decode_step(params, caches, token):
        with torch.inference_mode():
            logits, new = lm.lm_decode_step(params, cfg, caches, token)
            if new is not caches:
                _copy_into(caches, new)
            return logits, caches

    return decode_step
