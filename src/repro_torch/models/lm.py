"""Decoder LM for block kinds ``rnn``, ``attn`` and ``mamba``, from ``repro/models/lm.py``.

Entry points:
  * ``lm_init(gen, cfg, device, dtype)``              params tree (int8 gate
                                                      slabs when ``cfg.weight_quant == "int8"``)
  * ``lm_forward(params, cfg, batch)``                train logits (B, S, V_padded)
  * ``lm_loss(params, cfg, batch)``                   scalar CE loss (+ metrics)
  * ``lm_init_caches(cfg, batch, max_len, device)``   stacked decode caches
  * ``lm_prefill(params, cfg, batch, caches)``        logits of last pos + caches
  * ``lm_verify(params, cfg, batch, caches)``         every position's logits + caches
  * ``lm_decode_step(params, cfg, caches, tok)``      one-token serve step

The params tree has the JAX package's keys and layout (``bridge.py``
converts between the two). The port serves the paper's SRU/QRNN/LSTM LMs,
the dense GQA attention LMs (``llama3-8b``, ``smollm-360m``) and the Mamba-2
LM (``mamba2-2.7b``). Attention and Mamba caches are written in place
(``models/attention.py``, ``models/mamba.py``); RNN caches are returned
anew, as in JAX. MoE, the hybrids and the frontends wait for later slices
(ROADMAP.md).

The training forward (``lm_hidden`` / ``lm_forward`` / ``lm_loss``) is
differentiated by autograd: the fused RNN kernels through their autograd
Functions (``kernels/fused_rnn/ops.py``, ``stacked.py``), the linear scan
through its own (``kernels/linear_scan/ops.py``), attention through
``chunked_attention`` and Mamba through ``core/ssd.py::ssd_chunked``, as in
JAX. ``cfg.remat`` recomputes each block (``"block"``:
``torch.utils.checkpoint``) or all but its matmul outputs (``"dots"``).
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

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
    """Refuse the families the port does not serve or train yet, naming the queue."""
    unserved = [name for name, on in (("moe", cfg.moe), ("attn_every", cfg.attn_every),
                                      ("frontend", cfg.frontend)) if on]
    if unserved:
        raise NotImplementedError(
            f"{cfg.name}: the port does not run {'/'.join(unserved)} configs yet "
            "(ROADMAP.md §A6: the other assigned archs, MoE, hybrid and frontend ones)"
        )


# The matmul outputs remat="dots" keeps (JAX's
# ``dots_with_no_batch_dims_saveable``: products without batch dims).
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots():
    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE

    return create_selective_checkpoint_contexts(policy)


def maybe_remat(fn, remat: str):
    """none: save everything; block: recompute everything in the backward;
    dots: recompute all but matmul outputs."""
    if remat == "block":
        return lambda *args: checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    if remat == "dots":
        return lambda *args: checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                                        context_fn=_save_dots)
    return fn


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


def _attn_block_apply(params, cfg, x, positions):
    h = x + attention.attn_train(params["attn"], cfg, rmsnorm(params["ln1"], x), positions)
    return h + mlp_apply(params["mlp"], rmsnorm(params["ln2"], h), cfg.mlp_type)


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


def _block_apply(params, cfg, x, positions):
    kind = block_kind(cfg)
    if kind == "attn":
        return _attn_block_apply(params, cfg, x, positions)
    if kind == "mamba":
        return x + mamba.mamba_apply(params["mamba"], cfg, rmsnorm(params["ln1"], x))
    return rnn.rnn_block_apply(params, cfg, x)


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
# Train forward / loss
# ---------------------------------------------------------------------------

def lm_hidden(params, cfg, batch) -> torch.Tensor:
    """Embed -> blocks -> final norm. ``batch["inputs"]``: (B, S) token ids.
    Returns (B, S, d) in the compute dtype."""
    _require_served(cfg)
    compute = _dtype(cfg.compute_dtype)
    h = embed_apply(params["embed"], batch["inputs"]).to(compute)
    B, S = h.shape[:2]
    positions = torch.arange(S, dtype=torch.int32, device=h.device)[None].expand(B, S)
    layers = params["layers"]
    if cfg.cast_params_once:  # one cast of the whole stack; fp32 masters get grads through it
        layers = layout.cast_params(layers, compute)

    if block_kind(cfg) == "rnn" and cfg.fuse_depth:
        def stack_apply(lp, x):
            return rnn.rnn_stack_apply(layout.cast_params(lp, compute), cfg, x)

        h = maybe_remat(stack_apply, cfg.remat)(layers, h)
    else:
        def apply_block(lp, x):
            return _block_apply(layout.cast_params(lp, compute), cfg, x, positions)

        apply_block = maybe_remat(apply_block, cfg.remat)
        for l in range(cfg.n_layers):
            h = apply_block(rnn.layer_slice(layers, l), h)
    return rmsnorm(params["final_norm"].to(compute), h)


def lm_forward(params, cfg, batch) -> torch.Tensor:
    h = lm_hidden(params, cfg, batch)
    return logits_apply(layout.cast_params(params["embed"], h.dtype), h)


def _ce_terms(cfg, logits, targets):
    """(logz, ll) per token in fp32; the padded vocab's columns excluded."""
    logits = logits.float()
    if cfg.padded_vocab != cfg.vocab:
        pad_mask = torch.arange(cfg.padded_vocab, device=logits.device) < cfg.vocab
        logits = torch.where(pad_mask, logits, -1e30)
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return logz, ll


def lm_loss(params, cfg, batch):
    """Cross-entropy over targets. ``batch``: inputs, targets, mask.
    Returns ``(loss, {"loss", "tokens"})``. With ``cfg.loss_chunk > 0`` the
    (tokens, V) logits are never materialized: the final hidden states go
    through the head ``loss_chunk`` tokens at a time, each chunk under
    checkpoint."""
    targets = batch["targets"]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(targets.shape, dtype=torch.float32, device=targets.device)
    denom = torch.clamp(torch.sum(mask), min=1.0)

    if not cfg.loss_chunk:
        logz, ll = _ce_terms(cfg, lm_forward(params, cfg, batch), targets)
        loss = torch.sum((logz - ll) * mask) / denom
        return loss, {"loss": loss, "tokens": torch.sum(mask)}

    h = lm_hidden(params, cfg, batch)
    B, S, d = h.shape
    n = max(S // cfg.loss_chunk, 1)
    C = S // n
    embed_c = layout.cast_params(params["embed"], h.dtype)
    hc, tc, mc = h.reshape(B, n, C, d), targets.reshape(B, n, C), mask.reshape(B, n, C)

    def chunk_nll(hx, tx, mx):
        logz, ll = _ce_terms(cfg, logits_apply(embed_c, hx), tx)
        return torch.sum((logz - ll) * mx)

    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(n):
        total = total + checkpoint(chunk_nll, hc[:, i], tc[:, i], mc[:, i],
                                   use_reentrant=False, preserve_rng_state=False)
    loss = total / denom
    return loss, {"loss": loss, "tokens": torch.sum(mask)}


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
