"""Decoder LM for block kind ``rnn``, from ``repro/models/lm.py``.

Entry points:
  * ``lm_init(gen, cfg, device)``                     params tree
  * ``lm_init_caches(cfg, batch, max_len, device)``   stacked decode caches
  * ``lm_prefill(params, cfg, batch, caches)``        logits of last pos + caches
  * ``lm_decode_step(params, cfg, caches, tok)``      one-token serve step

The params tree has the JAX package's keys and layout (``bridge.py``
converts between the two). The other block kinds (attention, Mamba) and the
training forward wait for later slices.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models import rnn
from repro_torch.models.layers import (
    _dtype,
    embed_apply,
    embed_init,
    logits_apply,
    resolve_device,
    rmsnorm,
    rmsnorm_init,
)


def block_kind(cfg) -> str:
    if cfg.cell is not None:
        return "rnn"
    return "mamba" if cfg.ssm else "attn"


def _require_rnn(cfg) -> None:
    if block_kind(cfg) != "rnn" or cfg.frontend or cfg.attn_every:
        raise NotImplementedError(
            f"{cfg.name}: the port serves block kind 'rnn' only so far (ROADMAP.md, "
            "open item (e): the non-RNN families)"
        )


def _cast_params(tree, compute):
    """Cast the floating leaves to the compute dtype (``None`` stays).
    ``.to`` returns the tensor itself when it already has that dtype, so
    params cast once up front (``launch/serve.py``) cost nothing here."""
    if isinstance(tree, dict):
        return {k: _cast_params(v, compute) for k, v in tree.items()}
    if tree is None or not tree.is_floating_point():
        return tree
    return tree.to(compute)


def lm_init(gen: torch.Generator, cfg, device="cuda") -> Dict:
    """Params from ``gen`` (a CPU ``torch.Generator``), made on ``device``."""
    _require_rnn(cfg)
    device = resolve_device(device)
    if cfg.weight_quant != "none":
        raise NotImplementedError(
            "weight_quant='int8' is not ported yet (ROADMAP.md: the int8 forms of B1/B2)"
        )
    dtype = _dtype(cfg.param_dtype)
    params: Dict = {
        "embed": embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype, cfg.tie_embeddings, device)
    }
    layers = [rnn.rnn_block_init(gen, cfg, dtype, device) for _ in range(cfg.n_layers)]
    params["layers"] = _stack_trees(layers)
    params["final_norm"] = rmsnorm_init(cfg.d_model, dtype, device)
    return params


def _stack_trees(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    return None if first is None else torch.stack(trees)


def lm_init_caches(cfg, batch: int, max_len: int, device="cuda"):
    """Zero caches ``{"layers": {leaf: (L, B, ...)}}`` in the compute dtype
    (so the fp32 carry is rounded to it at every call boundary, as in JAX):
    ``c``, plus ``x_tail`` for QRNN and ``h`` for LSTM. ``max_len`` is unused
    by RNN caches; it is kept for the JAX signature."""
    _require_rnn(cfg)
    device = resolve_device(device)
    one = rnn.rnn_init_cache(cfg, batch, _dtype(cfg.compute_dtype), device)
    return {"layers": {k: torch.stack([v] * cfg.n_layers) for k, v in one.items()}}


def _run_layers(params, cfg, h, caches, fn):
    """All layers, threading the stacked caches. ``fn`` is the per-layer
    ``rnn_block_prefill`` or ``rnn_block_decode``; with ``cfg.fuse_depth``
    the stack-level API runs instead (the depth-fused stack under
    ``scan_engine="fused_stack"``)."""
    layers = _cast_params(params["layers"], h.dtype)
    if cfg.fuse_depth:
        stack_fn = rnn.rnn_stack_prefill if fn is rnn.rnn_block_prefill else rnn.rnn_stack_decode
        h, new = stack_fn(layers, cfg, h, caches["layers"])
    else:
        h, new = rnn.scan_layers(fn, layers, cfg, h, caches["layers"])
    return h, {"layers": new}


def _head(params, cfg, h):
    compute = h.dtype
    h = rmsnorm(params["final_norm"].to(compute), h)
    return logits_apply(_cast_params(params["embed"], compute), h)


def lm_prefill(params, cfg, batch, caches):
    """``batch["inputs"]``: (B, T) token ids. Returns the last position's
    logits (B, 1, V_padded) and the new caches."""
    compute = _dtype(cfg.compute_dtype)
    h = embed_apply(params["embed"], batch["inputs"]).to(compute)
    h, caches = _run_layers(params, cfg, h, caches, rnn.rnn_block_prefill)
    return _head(params, cfg, h[:, -1:]), caches


def lm_decode_step(params, cfg, caches, token):
    """One serve step: ``token`` (B, 1) ids. Returns (logits, new caches)."""
    compute = _dtype(cfg.compute_dtype)
    h = embed_apply(params["embed"], token).to(compute)
    h, caches = _run_layers(params, cfg, h, caches, rnn.rnn_block_decode)
    return _head(params, cfg, h), caches
