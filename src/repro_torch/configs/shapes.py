"""Assigned input shapes and their shape-only stand-ins (the port's copy of
``repro/configs/shapes.py``).

Four shapes per architecture (40 cells). ``train_4k`` is a train step;
``prefill_32k`` the prefill path; ``decode_32k`` / ``long_500k`` a decode
step, one new token against a cache of ``seq_len``. Applicability
(``long_500k`` needs sub-quadratic mixing; an encoder-only model has no
decode) is encoded here.

Tensors on the ``meta`` device stand in for JAX's ``ShapeDtypeStruct``: a
shape and a dtype, no storage, so a full-size spec allocates nothing.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str        # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def applicability(cfg: ArchConfig, shape: ShapeSpec) -> Optional[str]:
    """None if runnable, else the reason the cell is skipped."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return "skip(full-attn: 500k dense KV decode is not sub-quadratic)"
    if shape.kind == "decode" and cfg.skip_decode:
        return "skip(encoder-only)"
    return None


def train_input_specs(cfg: ArchConfig, shape: ShapeSpec):
    B, S = shape.global_batch, shape.seq_len
    specs = {"targets": _spec((B, S), torch.int32), "mask": _spec((B, S), torch.float32)}
    if cfg.frontend:
        specs["inputs_embeds"] = _spec((B, S, cfg.d_model), torch.bfloat16)
    else:
        specs["inputs"] = _spec((B, S), torch.int32)
    return specs


def prefill_input_specs(cfg: ArchConfig, shape: ShapeSpec):
    B, S = shape.global_batch, shape.seq_len
    if cfg.frontend:
        return {"inputs_embeds": _spec((B, S, cfg.d_model), torch.bfloat16)}
    return {"inputs": _spec((B, S), torch.int32)}


def decode_token_spec(cfg: ArchConfig, shape: ShapeSpec):
    B = shape.global_batch
    if cfg.frontend:
        return _spec((B, 1, cfg.d_model), torch.bfloat16)
    return _spec((B, 1), torch.int32)


def cache_specs(cfg: ArchConfig, shape: ShapeSpec):
    """The decode caches of ``lm_init_caches`` on the meta device (no
    allocation)."""
    from repro_torch.models.lm import lm_init_caches

    return lm_init_caches(cfg, shape.global_batch, shape.seq_len, device="meta")


class _MetaGenerator(torch.Generator):
    """A CPU generator whose ``device`` reads ``meta``: ``lm_init`` draws
    each leaf on its generator's device, so the params come out as meta
    tensors, shapes and dtypes only."""

    @property
    def device(self):
        return torch.device("meta")


def param_shapes(cfg: ArchConfig):
    """``lm_init``'s params on the meta device (JAX's ``eval_shape`` of
    ``lm_init``, as ``launch/dryrun.py::_param_structs`` takes it): int8
    configs come with their int8 slabs and scales."""
    from repro_torch.models.lm import lm_init

    return lm_init(_MetaGenerator(), cfg, device="meta")
