"""Decoder LM for block kinds ``rnn``, ``attn`` and ``mamba``, from ``repro/models/lm.py``.

Entry points:
  * ``lm_init(gen, cfg, device, dtype)``              params tree (int8 gate
                                                      slabs when ``cfg.weight_quant == "int8"``)
  * ``lm_forward(params, cfg, batch)``                train logits (B, S, V_padded)
  * ``lm_loss(params, cfg, batch)``                   scalar CE loss (+ metrics)
  * ``lm_init_caches(cfg, batch, max_len, device)``   stacked decode caches
  * ``lm_prefill(params, cfg, batch, caches, fsdp)``  logits of last pos + caches
  * ``lm_verify(params, cfg, batch, caches)``         every position's logits + caches
  * ``lm_decode_step(params, cfg, caches, tok, fsdp)`` one-token serve step
                                                      (an embedding row with a frontend)

The params tree has the JAX package's keys and layout (``bridge.py``
converts between the two). The port serves the paper's SRU/QRNN/LSTM LMs,
the dense attention LMs (``llama3-8b``, ``smollm-360m``, ``granite-20b``,
``nemotron-4-340b``),
the frontend-stub LMs (``internvl2-2b``, ``musicgen-large``: the inputs are
embeddings, through one ``frontend.adapter`` matrix), the Mamba-2 LM
(``mamba2-2.7b``) and the hybrid ``zamba2-7b``: groups of ``attn_every``
Mamba blocks, each followed by one weight-shared attention block
(``shared_attn``) with a KV cache of its own per application; the
``n_layers % attn_every`` tail blocks have none after them. Attention and
Mamba caches are written in place (``models/attention.py``,
``models/mamba.py``); RNN caches are returned anew, as in JAX. With
``cfg.moe`` an attention block's FFN is the mixture of experts of
``models/moe.py`` (``mixtral-8x22b``, ``qwen3-moe-235b-a22b``), under the
``moe`` key of its params.

The training forward (``lm_hidden`` / ``lm_forward`` / ``lm_loss``) is
differentiated by autograd: the fused RNN kernels through their autograd
Functions (``kernels/fused_rnn/ops.py``, ``stacked.py``), the linear scan
through its own (``kernels/linear_scan/ops.py``), attention through
``chunked_attention`` and Mamba through ``core/ssd.py::ssd_chunked``, as in
JAX. ``cfg.remat`` recomputes each block (``"block"``:
``torch.utils.checkpoint``) or all but its matmul outputs (``"dots"``).

Under a mesh whose model axis divides the padded vocab (the step builders'
``sharding.use_rules``) ``embed`` and ``unembed`` are this rank's blocks of
it: the lookup and the head run vocab-parallel
(``distribution/tensor_parallel.py``), and the logits come back gathered
to the whole vocab on every rank; the train loss reduces each rank's own
columns and gathers none. The attention and Mamba blocks
(``models/attention.py``, ``mamba.py``) and the dense MLP (:func:`_mlp`)
run the rank's shards of their leaves and caches under a model axis.
"""
from __future__ import annotations

import contextvars

from typing import Dict, NamedTuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.distribution import tensor_parallel
from repro_torch.distribution.sharding import model_group
from repro_torch.kernels.fused_rnn import layout
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import attention, mamba, moe, rnn
from repro_torch.models.layers import (
    _dtype,
    embed_init,
    mlp_apply,
    mlp_init,
    dense_init,
    resolve_device,
    rmsnorm,
    rmsnorm_init,
)


def block_kind(cfg) -> str:
    if cfg.cell is not None:
        return "rnn"
    return "mamba" if cfg.ssm else "attn"


# The matmul outputs remat="dots" keeps (JAX's
# ``dots_with_no_batch_dims_saveable``: products without batch dims, so the
# MoE router product is kept and the experts' batched products recomputed).
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots():
    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE

    return create_selective_checkpoint_contexts(policy)


def maybe_remat(fn, remat: str):
    """none: save everything; block: recompute everything in the backward;
    dots: recompute all but matmul outputs. The recompute runs in a copy of
    the forward's context: on the card the backward runs on the autograd
    engine's device thread, where the forward's context variables (the
    mesh of ``sharding.use_rules``) are not set."""
    if remat not in ("block", "dots"):
        return fn
    kw = {"context_fn": _save_dots} if remat == "dots" else {}

    def run(*args):
        ctx = contextvars.copy_context()
        return checkpoint(lambda *a: ctx.run(fn, *a), *args, use_reentrant=False,
                          preserve_rng_state=False, **kw)

    return run


# ---------------------------------------------------------------------------
# Attention blocks: pre-norm attention + residual, pre-norm MLP + residual
# ---------------------------------------------------------------------------

def _attn_block_init(gen, cfg, dtype, device) -> Dict:
    p = {
        "ln1": rmsnorm_init(cfg.d_model, dtype, device),
        "attn": attention.attn_init(gen, cfg, dtype, device),
        "ln2": rmsnorm_init(cfg.d_model, dtype, device),
    }
    if cfg.moe:
        p["moe"] = moe.moe_init(gen, cfg, dtype, device)
    else:
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type, dtype, device)
    return p


def _mlp(params, cfg, x):
    """``mlp_apply``; under a model axis on the rank's "ff" columns of
    ``w_gate`` / ``w_up`` (the nonlinearity is elementwise) and rows of
    ``w_down``, the partial products summed (whole leaves: whole)."""
    group = None if params["w_down"].shape[0] == cfg.d_ff else model_group()
    return mesh_lib.combine(mlp_apply(params, mesh_lib.enter(x, group), cfg.mlp_type), group)


def _ffn(params, cfg, h):
    """The block's second half: pre-norm MLP or mixture of experts, plus residual."""
    z = rmsnorm(params["ln2"], h)
    if cfg.moe:
        return h + moe.moe_apply(params["moe"], cfg, z)
    return h + _mlp(params["mlp"], cfg, z)


def _attn_block_apply(params, cfg, x, positions):
    h = x + attention.attn_train(params["attn"], cfg, rmsnorm(params["ln1"], x), positions)
    return _ffn(params, cfg, h)


def _attn_block_prefill(params, cfg, x, cache):
    a, cache = attention.attn_prefill(params["attn"], cfg, rmsnorm(params["ln1"], x), cache)
    return _ffn(params, cfg, x + a), cache


def _attn_block_decode(params, cfg, x, cache):
    a, cache = attention.attn_decode(params["attn"], cfg, rmsnorm(params["ln1"], x), cache)
    return _ffn(params, cfg, x + a), cache


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


def _block_cache_shapes(cfg, batch: int, max_len: int, dtype) -> Dict:
    kind = block_kind(cfg)
    if kind == "attn":
        return attention.cache_shapes(cfg, batch, max_len, dtype)
    if kind == "mamba":
        return mamba.mamba_cache_shapes(cfg, batch, dtype)
    return rnn.rnn_cache_shapes(cfg, batch, dtype)


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
    device = resolve_device(device)
    dtype = _dtype(cfg.param_dtype) if dtype is None else dtype
    quant = cfg.weight_quant == "int8"
    draw = _dtype(cfg.param_dtype) if quant else dtype
    params: Dict = {}
    if cfg.frontend:
        params["frontend"] = {"adapter": dense_init(gen, cfg.d_model, cfg.d_model, dtype, device)}
    params["embed"] = embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype, cfg.tie_embeddings,
                                 device)
    params["layers"] = _stacked_init(lambda: _block_init(gen, cfg, draw, device), cfg.n_layers)
    if quant:
        # Weight-only int8 of the SRU/QRNN gate slabs; LSTM and every
        # non-cell leaf pass through.
        params["layers"] = layout.cast_params(layout.quantize_tree(params["layers"]), dtype)
    if cfg.attn_every:  # one attention block, shared by every application
        params["shared_attn"] = _attn_block_init(gen, cfg, dtype, device)
    params["final_norm"] = rmsnorm_init(cfg.d_model, dtype, device)
    return params


def _split_groups(cfg):
    """(n_groups, group_size, n_tail) of a hybrid's interleave."""
    g = cfg.attn_every
    n_groups = cfg.n_layers // g
    return n_groups, g, cfg.n_layers - n_groups * g


class CacheLeaf(NamedTuple):
    """A cache leaf's shape and dtype, without the tensor."""

    shape: tuple
    dtype: torch.dtype


def _stacked(one: Dict, n: int) -> Dict:
    return {k: CacheLeaf((n, *shape), dtype) for k, (shape, dtype) in one.items()}


def lm_cache_shapes(cfg, batch: int, max_len: int) -> Dict:
    """The leaves of :func:`lm_init_caches` as :class:`CacheLeaf` (shape and
    dtype), no tensor made: what a rank reads to size its shards of caches
    it never holds whole (``training/steps.py::_init_caches``)."""
    dtype = _dtype(cfg.compute_dtype)
    caches = {"layers": _stacked(_block_cache_shapes(cfg, batch, max_len, dtype), cfg.n_layers)}
    if cfg.attn_every:
        n_groups, _, _ = _split_groups(cfg)
        caches["shared_attn"] = _stacked(attention.cache_shapes(cfg, batch, max_len, dtype),
                                         n_groups)
    return caches


def lm_init_caches(cfg, batch: int, max_len: int, device="cuda"):
    """Zero caches ``{"layers": {leaf: (L, ...)}}`` in the compute dtype
    (``pos`` int32, ``ssm`` fp32). RNN: ``c``, plus ``x_tail`` for QRNN and
    ``h`` for LSTM; ``max_len`` is unused by them and by Mamba (kept for the
    JAX signature). Attention: ``k``, ``v`` (L, B, size, Hkv, Dh) and ``pos``
    (L,). Mamba: ``conv_x``, ``conv_b``, ``conv_c`` (L, B, W-1, C) and
    ``ssm`` (L, B, H, N, P). A hybrid adds ``"shared_attn"``: an attention
    cache stacked over its ``n_layers // attn_every`` applications."""
    device = resolve_device(device)
    return rnn.tree_map(lambda leaf: torch.zeros(leaf.shape, dtype=leaf.dtype, device=device),
                        lm_cache_shapes(cfg, batch, max_len))


def _whole(fsdp, tree, path: str, layer: bool = False):
    """``tree`` (the params' subtree at ``path``, or with ``layer`` one
    layer's slice of it) gathered whole over "data" by the train step's FSDP
    plan (``launch/mesh.py::FsdpPlan``); ``tree`` itself without one."""
    return tree if fsdp is None else fsdp.gather(tree, path, layer)


def _head_params(params, fsdp=None) -> Dict:
    """The head's leaf: ``unembed``, or tied the ``embed`` table."""
    key = "unembed" if "unembed" in params["embed"] else "embed"
    return {key: _whole(fsdp, params["embed"][key], f"embed/{key}")}


def _embed_in(params, cfg, batch, compute, fsdp=None) -> torch.Tensor:
    """The first hidden states in the compute dtype: ``batch["inputs"]``
    (B, S) token ids through the embedding table (vocab-parallel under a
    sharding mesh), or with a frontend stub ``batch["inputs_embeds"]`` (B,
    S, d) through its adapter matrix."""
    if cfg.frontend:
        adapter = _whole(fsdp, params["frontend"]["adapter"], "frontend/adapter")
        return batch["inputs_embeds"].to(compute) @ adapter.to(compute)
    table = {"embed": _whole(fsdp, params["embed"]["embed"], "embed/embed")}
    return tensor_parallel.embed(table, batch["inputs"], tensor_parallel.vocab_group(cfg)
                                 ).to(compute)


def _check_hybrid(cfg) -> None:
    if cfg.attn_every and block_kind(cfg) == "rnn" and cfg.fuse_depth:
        # the stack-level call would skip the shared attention block
        raise ValueError("fuse_depth does not support attn_every hybrids")


# ---------------------------------------------------------------------------
# Train forward / loss
# ---------------------------------------------------------------------------

def lm_hidden(params, cfg, batch, fsdp=None) -> torch.Tensor:
    """Embed -> blocks (a hybrid's shared block after every ``attn_every``
    of them) -> final norm. ``batch["inputs"]``: (B, S) token ids, or
    ``batch["inputs_embeds"]`` (B, S, d) with a frontend. Returns (B, S, d)
    in the compute dtype.

    ``fsdp``: the train step's plan (``launch/mesh.py::FsdpPlan``) when
    ``params`` are this rank's data shards. Each block then gathers its own
    layer inside its remat region, as JAX's scanned layers do, so under
    ``remat="block"`` a rank holds one layer gathered at a time and the
    backward gathers it again; with ``cast_params_once`` the shard is cast
    and the gather moves the compute dtype. The depth-fused RNN stack
    gathers its whole stack at its one call, the hybrid's shared block
    gathers at each application, the vocab leaves where they are used.
    Under ``"none"`` or ``"dots"`` autograd keeps the gathered weights its
    products save, so the peak does not fall (JAX's scan residuals keep
    them too). Without a plan the params are used as they are."""
    _check_hybrid(cfg)
    compute = _dtype(cfg.compute_dtype)
    h = _embed_in(params, cfg, batch, compute, fsdp)
    B, S = h.shape[:2]
    positions = torch.arange(S, dtype=torch.int32, device=h.device)[None].expand(B, S)
    layers = params["layers"]
    if cfg.cast_params_once:  # one cast of the whole stack; fp32 masters get grads through it
        layers = layout.cast_params(layers, compute)

    if block_kind(cfg) == "rnn" and cfg.fuse_depth:
        def stack_apply(lp, x):
            lp = _whole(fsdp, lp, "layers")
            return rnn.rnn_stack_apply(layout.cast_params(lp, compute), cfg, x)

        h = maybe_remat(stack_apply, cfg.remat)(layers, h)
    else:
        def apply_block(lp, x):
            lp = _whole(fsdp, lp, "layers", layer=True)
            return _block_apply(layout.cast_params(lp, compute), cfg, x, positions)

        apply_block = maybe_remat(apply_block, cfg.remat)
        shared_apply = None
        if cfg.attn_every:
            shared = layout.cast_params(params["shared_attn"], compute)  # once a call

            def shared_apply(x):
                return _attn_block_apply(_whole(fsdp, shared, "shared_attn"), cfg, x, positions)

            if cfg.remat == "block":  # as JAX checkpoints it (only under "block")
                shared_apply = maybe_remat(shared_apply, "block")
        for l in range(cfg.n_layers):
            with mesh_lib.loop_body():
                h = apply_block(rnn.layer_slice(layers, l), h)
                if shared_apply is not None and (l + 1) % cfg.attn_every == 0:
                    h = shared_apply(h)
    return rmsnorm(_whole(fsdp, params["final_norm"], "final_norm").to(compute), h)


def lm_forward(params, cfg, batch, fsdp=None) -> torch.Tensor:
    h = lm_hidden(params, cfg, batch, fsdp)
    return tensor_parallel.logits(layout.cast_params(_head_params(params, fsdp), h.dtype), h,
                                  tensor_parallel.vocab_group(cfg))


def head_nll(params, cfg, h, targets, mask, fsdp=None) -> torch.Tensor:
    """The masked sum of the NLL of ``targets`` (B, S) under the head's
    logits of the final hidden states ``h`` (B, S, d), in fp32: the logits
    whole, or with ``cfg.loss_chunk > 0`` ``loss_chunk`` tokens at a time,
    each chunk under checkpoint, so the (tokens, V) logits never exist.
    Under a model axis that shards the vocab each rank holds its columns
    only (:func:`tensor_parallel.ce_terms`). ``fsdp``: the train step's plan
    (:func:`lm_hidden`)."""
    embed_c = layout.cast_params(_head_params(params, fsdp), h.dtype)
    group = tensor_parallel.vocab_group(cfg)  # read here: the recompute runs outside the context
    if not cfg.loss_chunk:
        logz, ll = tensor_parallel.ce_terms(embed_c, h, targets, group, cfg.vocab)
        return torch.sum((logz - ll) * mask)
    B, S, d = h.shape
    n = max(S // cfg.loss_chunk, 1)
    C = S // n
    hc, tc, mc = h.reshape(B, n, C, d), targets.reshape(B, n, C), mask.reshape(B, n, C)

    def chunk_nll(hx, tx, mx):
        logz, ll = tensor_parallel.ce_terms(embed_c, hx, tx, group, cfg.vocab)
        return torch.sum((logz - ll) * mx)

    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(n):
        total = total + checkpoint(chunk_nll, hc[:, i], tc[:, i], mc[:, i],
                                   use_reentrant=False, preserve_rng_state=False)
    return total


def lm_loss(params, cfg, batch, denom=None, fsdp=None):
    """Cross-entropy over targets. ``batch``: inputs, targets, mask.
    Returns ``(loss, {"loss", "tokens"})``: :func:`head_nll` of
    :func:`lm_hidden`'s states over ``denom``, the token count the NLL sum
    is divided by (default the batch's own, at least 1); a data-parallel
    rank passes the whole microbatch's, so the ranks' losses add up to its
    loss. ``fsdp``: the train step's FSDP plan (:func:`lm_hidden`)."""
    targets = batch["targets"]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(targets.shape, dtype=torch.float32, device=targets.device)
    if denom is None:
        denom = torch.clamp(torch.sum(mask), min=1.0)
    loss = head_nll(params, cfg, lm_hidden(params, cfg, batch, fsdp), targets, mask, fsdp) / denom
    return loss, {"loss": loss, "tokens": torch.sum(mask)}


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------

def _run_layers(params, cfg, h, caches, decode: bool, fsdp=None):
    """All layers, threading the stacked caches. Attention and Mamba layers
    write their slice of the stacked cache in place and the same ``caches``
    is returned; so does a hybrid's shared block, into its application's
    slice of ``caches["shared_attn"]``. RNN layers run
    ``rnn_block_prefill``/``rnn_block_decode`` per layer (``scan_layers``),
    or with ``cfg.fuse_depth`` the stack-level API (the depth-fused stack
    under ``scan_engine="fused_stack"``), and return new caches.

    ``fsdp``: the serving step's plan (``launch/mesh.py::FsdpPlan``, forward
    only) when ``params`` are this rank's data shards: each attention or
    Mamba layer is gathered over "data" where it runs, the hybrid's shared
    block at each application, an RNN stack whole at its one call, as
    :func:`lm_hidden` gathers them for training."""
    _check_hybrid(cfg)
    layers = layout.cast_params(params["layers"], h.dtype)
    kind = block_kind(cfg)
    if kind in ("attn", "mamba"):
        fns = {"attn": (_attn_block_prefill, _attn_block_decode),
               "mamba": (_mamba_block_prefill, _mamba_block_decode)}
        fn = fns[kind][decode]
        g = cfg.attn_every
        if g:
            shared = layout.cast_params(params["shared_attn"], h.dtype)
            shared_fn = (_attn_block_prefill, _attn_block_decode)[decode]
        for l in range(cfg.n_layers):
            with mesh_lib.loop_body():
                lp = _whole(fsdp, rnn.layer_slice(layers, l), "layers", layer=True)
                h, _ = fn(lp, cfg, h, rnn.layer_slice(caches["layers"], l))
                if g and (l + 1) % g == 0:
                    h, _ = shared_fn(_whole(fsdp, shared, "shared_attn"), cfg, h,
                                     rnn.layer_slice(caches["shared_attn"], (l + 1) // g - 1))
        return h, caches
    if cfg.attn_every:  # JAX groups them too; no config has an RNN hybrid
        raise NotImplementedError(f"{cfg.name}: the port serves Mamba-2 hybrids only")
    layers = _whole(fsdp, layers, "layers")
    if cfg.fuse_depth:
        stack_fn = rnn.rnn_stack_decode if decode else rnn.rnn_stack_prefill
        h, new = stack_fn(layers, cfg, h, caches["layers"])
    else:
        fn = rnn.rnn_block_decode if decode else rnn.rnn_block_prefill
        with mesh_lib.loop_body():
            h, new = rnn.scan_layers(fn, layers, cfg, h, caches["layers"])
    return h, {"layers": new}


def _head(params, cfg, h, fsdp=None):
    compute = h.dtype
    h = rmsnorm(_whole(fsdp, params["final_norm"], "final_norm").to(compute), h)
    return tensor_parallel.logits(layout.cast_params(_head_params(params, fsdp), compute), h,
                                  tensor_parallel.vocab_group(cfg))


def _prefill_layers(params, cfg, batch, caches, fsdp=None):
    h = _embed_in(params, cfg, batch, _dtype(cfg.compute_dtype), fsdp)
    return _run_layers(params, cfg, h, caches, decode=False, fsdp=fsdp)


def lm_prefill(params, cfg, batch, caches, fsdp=None):
    """``batch["inputs"]``: (B, T) token ids, or ``batch["inputs_embeds"]``
    (B, T, d) with a frontend. Returns the last position's logits (B, 1,
    V_padded) and the new caches. ``fsdp``: the serving step's FSDP plan
    (:func:`_run_layers`)."""
    h, caches = _prefill_layers(params, cfg, batch, caches, fsdp)
    return _head(params, cfg, h[:, -1:], fsdp), caches


def lm_verify(params, cfg, batch, caches):
    """``lm_prefill`` that keeps EVERY position's logits (B, T, V_padded):
    the target half of speculative decode scores a drafted block of T tokens
    in one chunk on the MTS path. RMSNorm and the head are maps over
    positions, so row T-1 is what ``lm_prefill`` gives for the chunk."""
    h, caches = _prefill_layers(params, cfg, batch, caches)
    return _head(params, cfg, h), caches


def lm_decode_step(params, cfg, caches, token_or_embed, fsdp=None):
    """One serve step: a token (B, 1) of ids, or with a frontend an
    embedding (B, 1, d). Returns (logits, caches). ``fsdp``: the serving
    step's FSDP plan (:func:`_run_layers`)."""
    key = "inputs_embeds" if cfg.frontend else "inputs"
    h = _embed_in(params, cfg, {key: token_or_embed}, _dtype(cfg.compute_dtype), fsdp)
    h, caches = _run_layers(params, cfg, h, caches, decode=True, fsdp=fsdp)
    return _head(params, cfg, h, fsdp), caches
