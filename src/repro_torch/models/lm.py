"""Decoder LM for block kinds ``rnn``, ``attn`` and ``mamba``, from ``repro/models/lm.py``.

Entry points:
  * ``lm_init(gen, cfg, device, dtype)``              params tree (int8 gate
                                                      slabs when ``cfg.weight_quant == "int8"``)
  * ``lm_init_caches(cfg, batch, max_len, device)``   stacked decode caches
  * ``lm_prefill(params, cfg, batch, caches)``        logits of last pos + caches
  * ``lm_verify(params, cfg, batch, caches)``         every position's logits + caches
  * ``lm_decode_step(params, cfg, caches, tok)``      one-token serve step

The params tree has the JAX package's keys and layout (``bridge.py``
converts between the two). The port serves the paper's SRU/QRNN/LSTM LMs,
the dense GQA attention LMs (``llama3-8b``, ``smollm-360m``) and the Mamba-2
LM (``mamba2-2.7b``). Attention and Mamba caches are written in place
(``models/attention.py``, ``models/mamba.py``); RNN caches are returned
anew, as in JAX. MoE, the hybrids, the frontends and the training forward
wait for later slices (ROADMAP.md).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels.fused_rnn import layout
from repro_torch.models import attention, mamba, rnn
from repro_torch.models.layers import (
    _dtype,
    embed_apply,
    embed_init,
    logits_apply,
    mlp_apply,
    mlp_init,
    resolve_device,
    rmsnorm,
    rmsnorm_init,
)


def block_kind(cfg) -> str:
    if cfg.cell is not None:
        return "rnn"
    return "mamba" if cfg.ssm else "attn"


def _require_served(cfg) -> None:
    """Refuse the families the port does not serve yet, naming the queue."""
    unserved = [name for name, on in (("moe", cfg.moe), ("attn_every", cfg.attn_every),
                                      ("frontend", cfg.frontend)) if on]
    if unserved:
        raise NotImplementedError(
            f"{cfg.name}: the port does not serve {'/'.join(unserved)} configs yet "
            "(ROADMAP.md §A6: the other assigned archs, MoE, hybrid and frontend ones)"
        )


# ---------------------------------------------------------------------------
# Attention blocks: pre-norm attention + residual, pre-norm MLP + residual
# ---------------------------------------------------------------------------

def _attn_block_init(gen, cfg, dtype, device) -> Dict:
    return {
        "ln1": rmsnorm_init(cfg.d_model, dtype, device),
        "attn": attention.attn_init(gen, cfg, dtype, device),
        "ln2": rmsnorm_init(cfg.d_model, dtype, device),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type, dtype, device),
    }


def _attn_block_prefill(params, cfg, x, cache):
    a, cache = attention.attn_prefill(params["attn"], cfg, rmsnorm(params["ln1"], x), cache)
    h = x + a
    return h + mlp_apply(params["mlp"], rmsnorm(params["ln2"], h), cfg.mlp_type), cache


def _attn_block_decode(params, cfg, x, cache):
    a, cache = attention.attn_decode(params["attn"], cfg, rmsnorm(params["ln1"], x), cache)
    h = x + a
    return h + mlp_apply(params["mlp"], rmsnorm(params["ln2"], h), cfg.mlp_type), cache


# ---------------------------------------------------------------------------
# Mamba blocks: pre-norm Mamba-2 mixer + residual
# ---------------------------------------------------------------------------

def _mamba_block_prefill(params, cfg, x, cache):
    out, cache = mamba.mamba_prefill(params["mamba"], cfg, rmsnorm(params["ln1"], x), cache)
    return x + out, cache


def _mamba_block_decode(params, cfg, x, cache):
    out, cache = mamba.mamba_decode(params["mamba"], cfg, rmsnorm(params["ln1"], x), cache)
    return x + out, cache


def _block_init(gen, cfg, dtype, device) -> Dict:
    kind = block_kind(cfg)
    if kind == "attn":
        return _attn_block_init(gen, cfg, dtype, device)
    if kind == "mamba":
        return {"ln1": rmsnorm_init(cfg.d_model, dtype, device),
                "mamba": mamba.mamba_init(gen, cfg, dtype, device)}
    return rnn.rnn_block_init(gen, cfg, dtype, device)


def _block_cache(cfg, batch: int, max_len: int, dtype, device) -> Dict:
    kind = block_kind(cfg)
    if kind == "attn":
        return attention.init_cache(cfg, batch, max_len, dtype, device)
    if kind == "mamba":
        return mamba.mamba_init_cache(cfg, batch, dtype, device)
    return rnn.rnn_init_cache(cfg, batch, dtype, device)


def _stacked_init(make, n: int):
    """``n`` layers of ``make()`` written one at a time into stacked
    ``(n, ...)`` leaves: only one layer exists outside the stack."""
    one = make()
    out = rnn.tree_map(lambda t: t.new_empty((n, *t.shape)), one)
    for l in range(n):
        one = one if l == 0 else make()
        rnn.tree_map(lambda o, t: o[l].copy_(t), out, one)
    return out


# ---------------------------------------------------------------------------
# Model init and caches
# ---------------------------------------------------------------------------

def lm_init(gen: torch.Generator, cfg, device="cuda", dtype=None) -> Dict:
    """Params from ``gen`` (drawn on its device), made on ``device`` in
    ``dtype`` (default ``cfg.param_dtype``; every config's is fp32). Each
    leaf is drawn in fp32 and cast as it is made, and layers are written
    into the stacked leaves one at a time, so a bf16 llama3-8b never has its
    fp32 tree on the card: the peak is the bf16 tree plus one fp32 leaf.
    int8 gate slabs are quantized from the fp32 slabs, then the rest cast."""
    _require_served(cfg)
    device = resolve_device(device)
    dtype = _dtype(cfg.param_dtype) if dtype is None else dtype
    quant = cfg.weight_quant == "int8"
    draw = _dtype(cfg.param_dtype) if quant else dtype
    params: Dict = {
        "embed": embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype, cfg.tie_embeddings, device)
    }
    params["layers"] = _stacked_init(lambda: _block_init(gen, cfg, draw, device), cfg.n_layers)
    if quant:
        # Weight-only int8 of the SRU/QRNN gate slabs; LSTM and every
        # non-cell leaf pass through.
        params["layers"] = layout.cast_params(layout.quantize_tree(params["layers"]), dtype)
    params["final_norm"] = rmsnorm_init(cfg.d_model, dtype, device)
    return params


def lm_init_caches(cfg, batch: int, max_len: int, device="cuda"):
    """Zero caches ``{"layers": {leaf: (L, ...)}}`` in the compute dtype
    (``pos`` int32, ``ssm`` fp32). RNN: ``c``, plus ``x_tail`` for QRNN and
    ``h`` for LSTM; ``max_len`` is unused by them and by Mamba (kept for the
    JAX signature). Attention: ``k``, ``v`` (L, B, size, Hkv, Dh) and ``pos``
    (L,). Mamba: ``conv_x``, ``conv_b``, ``conv_c`` (L, B, W-1, C) and
    ``ssm`` (L, B, H, N, P)."""
    _require_served(cfg)
    device = resolve_device(device)
    one = _block_cache(cfg, batch, max_len, _dtype(cfg.compute_dtype), device)
    return {"layers": {k: v.new_zeros((cfg.n_layers, *v.shape)) for k, v in one.items()}}


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------

def _run_layers(params, cfg, h, caches, decode: bool):
    """All layers, threading the stacked caches. Attention and Mamba layers
    write their slice of the stacked cache in place and the same ``caches``
    is returned. RNN layers run ``rnn_block_prefill``/``rnn_block_decode`` per
    layer (``scan_layers``), or with ``cfg.fuse_depth`` the stack-level API
    (the depth-fused stack under ``scan_engine="fused_stack"``), and return
    new caches."""
    layers = layout.cast_params(params["layers"], h.dtype)
    kind = block_kind(cfg)
    if kind in ("attn", "mamba"):
        fns = {"attn": (_attn_block_prefill, _attn_block_decode),
               "mamba": (_mamba_block_prefill, _mamba_block_decode)}
        fn = fns[kind][decode]
        for l in range(cfg.n_layers):
            h, _ = fn(rnn.layer_slice(layers, l), cfg, h, rnn.layer_slice(caches["layers"], l))
        return h, caches
    if cfg.fuse_depth:
        stack_fn = rnn.rnn_stack_decode if decode else rnn.rnn_stack_prefill
        h, new = stack_fn(layers, cfg, h, caches["layers"])
    else:
        fn = rnn.rnn_block_decode if decode else rnn.rnn_block_prefill
        h, new = rnn.scan_layers(fn, layers, cfg, h, caches["layers"])
    return h, {"layers": new}


def _head(params, cfg, h):
    compute = h.dtype
    h = rmsnorm(params["final_norm"].to(compute), h)
    return logits_apply(layout.cast_params(params["embed"], compute), h)


def _prefill_layers(params, cfg, batch, caches):
    compute = _dtype(cfg.compute_dtype)
    h = embed_apply(params["embed"], batch["inputs"]).to(compute)
    return _run_layers(params, cfg, h, caches, decode=False)


def lm_prefill(params, cfg, batch, caches):
    """``batch["inputs"]``: (B, T) token ids. Returns the last position's
    logits (B, 1, V_padded) and the new caches."""
    h, caches = _prefill_layers(params, cfg, batch, caches)
    return _head(params, cfg, h[:, -1:]), caches


def lm_verify(params, cfg, batch, caches):
    """``lm_prefill`` that keeps EVERY position's logits (B, T, V_padded):
    the target half of speculative decode scores a drafted block of T tokens
    in one chunk on the MTS path. RMSNorm and the head are maps over
    positions, so row T-1 is what ``lm_prefill`` gives for the chunk."""
    h, caches = _prefill_layers(params, cfg, batch, caches)
    return _head(params, cfg, h), caches


def lm_decode_step(params, cfg, caches, token):
    """One serve step: ``token`` (B, 1) ids. Returns (logits, caches)."""
    compute = _dtype(cfg.compute_dtype)
    h = embed_apply(params["embed"], token).to(compute)
    h, caches = _run_layers(params, cfg, h, caches, decode=True)
    return _head(params, cfg, h), caches
