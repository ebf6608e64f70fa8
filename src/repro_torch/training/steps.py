"""Train and serving steps, from ``repro/training/steps.py``: the train
step (``TrainState``, ``init_train_state``, ``build_train_step``,
``build_eval_step``), the batch path's ``build_prefill_step`` and
``build_decode_step``, and the fixed-shape lane-masked steps of continuous
batching (``serving/engine.py``).

Each builder closes over the config and returns a plain function. The
serving steps run under ``torch.inference_mode()``; the train step runs
eagerly with autograd (capturing it as a CUDA graph is later work).

``build_prefill_step``, ``build_decode_step`` and ``build_cache_init`` take
a ``mesh`` (``launch/mesh.py``), as JAX's do: each rank then allocates its
shards of the caches (``fused_sharded.rank_cache_specs``: the RNN carries
(L, B, H) with their lanes over "model" where the fused path runs per rank,
the batch over "data") and runs the step under ``sharding.use_rules``, so
the fused engines run per rank. The step's params, inputs and caches are
this rank's shards. The lane-masked, verify and draft builders take no mesh
(continuous batching under a mesh is ROADMAP §A7.2).
"""
from __future__ import annotations

import contextlib
from typing import Dict, NamedTuple, Optional

import torch

from repro_torch.distribution import fused_sharded
from repro_torch.distribution.sharding import local_shape, use_rules
from repro_torch.models import lm, rnn
from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update, cosine_schedule
from repro_torch.optim.compression import compress_grads, ef_init
from repro_torch.tree import tree_leaves, tree_map, unflatten_like


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

class TrainState(NamedTuple):
    params: Dict
    opt: AdamWState
    ef: Optional[Dict]  # error-feedback residuals (grad compression) or None


def init_train_state(gen: torch.Generator, cfg, compression: Optional[str] = None,
                     device="cuda") -> TrainState:
    params = lm.lm_init(gen, cfg, device=device)
    opt = adamw_init(params, cfg.moment_dtype)
    ef = ef_init(params) if compression not in (None, "none") else None
    return TrainState(params=params, opt=opt, ef=ef)


def _split_microbatch(batch: Dict, n_mb: int, i: int) -> Dict:
    def one(x):
        mb = x.shape[0] // n_mb
        return x[i * mb:(i + 1) * mb]

    return {k: one(v) for k, v in batch.items()}


def build_train_step(
    cfg,
    *,
    base_lr: float = 3e-4,
    warmup: int = 100,
    total_steps: int = 10000,
    compression: Optional[str] = None,
):
    """``train_step(state, batch) -> (state, metrics)``: microbatched
    gradient accumulation (a Python loop, fp32 sums: JAX's ``lax.scan``),
    loss averaged over microbatches and grads scaled only when there are
    several, optional compression with error feedback, then AdamW at
    ``schedule(opt.step)``. The params, moments and step are updated in
    place and the same tensors returned (the port's ``donate_argnums``).
    ``metrics``: ``loss``, ``grad_norm``, ``lr`` (tensors on the device).

    Int8 weight-quantized configs are refused, as the JAX package's step
    refuses them (``jax.grad`` of int8 gate slabs is a ``TypeError``)."""
    if cfg.weight_quant == "int8":
        raise TypeError(
            f"{cfg.name}: int8 weight-quantized configs do not train (their gate slabs "
            "are int8, and the JAX package's build_train_step cannot differentiate them "
            "either); train the fp config and quantize at init"
        )
    schedule = cosine_schedule(base_lr, warmup, total_steps)

    def train_step(state: TrainState, batch: Dict):
        n_mb = cfg.microbatches
        leaves = [p.detach().requires_grad_() for p in tree_leaves(state.params)]
        params = unflatten_like(state.params, leaves)

        def grads_of(mb):
            loss, _ = lm.lm_loss(params, cfg, mb)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            return loss.detach(), [torch.zeros_like(p, dtype=torch.float32) if g is None
                                   else g.float() for p, g in zip(leaves, grads)]

        if n_mb == 1:
            loss, g_sum = grads_of(batch)
        else:
            # Summed in place, each microbatch's grads dropped before the
            # next's exist: one fp32 copy of the params' size beside the sum.
            g_sum = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
            loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
            for i in range(n_mb):
                loss_i, g_i = grads_of(_split_microbatch(batch, n_mb, i))
                for a, g in zip(g_sum, g_i):
                    a.add_(g)
                del g_i
                loss = loss + loss_i
            loss = loss / n_mb
            for g in g_sum:
                g.div_(n_mb)
        grads = unflatten_like(state.params, g_sum)
        grads, new_ef = compress_grads(grads, state.ef, compression)
        lr = schedule(state.opt.step)
        new_params, new_opt, opt_metrics = adamw_update(grads, state.opt, state.params, lr)
        return TrainState(params=new_params, opt=new_opt, ef=new_ef), {"loss": loss, **opt_metrics}

    return train_step


def build_eval_step(cfg):
    """``eval_step(params, batch) -> metrics`` (``loss``, ``tokens``), no grads."""

    def eval_step(params, batch):
        with torch.no_grad():
            _, metrics = lm.lm_loss(params, cfg, batch)
            return metrics

    return eval_step


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def _init_caches(cfg, mesh, batch: int, max_len: int, device):
    """Zero caches on ``device``: whole, or under ``mesh`` this rank's
    shards of them (``fused_sharded.rank_cache_specs``)."""
    if mesh is None:
        return lm.lm_init_caches(cfg, batch, max_len, device=device)
    whole = lm.lm_init_caches(cfg, batch, max_len, device="meta")
    specs = fused_sharded.rank_cache_specs(cfg, whole, mesh)
    return tree_map(lambda leaf, spec: torch.zeros(local_shape(leaf.shape, spec, mesh),
                                                   dtype=leaf.dtype, device=device),
                    whole, specs)


def _under(mesh):
    """``use_rules(mesh)``, or nothing without a mesh."""
    return contextlib.nullcontext() if mesh is None else use_rules(mesh)


def build_prefill_step(cfg, mesh=None, *, batch: int, max_len: int, device="cuda"):
    """``prefill_step(params, inputs) -> (logits, caches)``: fresh zero caches
    on ``device`` (under ``mesh``, this rank's shards of them, for the
    global ``batch``), then one MTS prefill over the prompt."""

    def prefill_step(params, inputs: Dict):
        with torch.inference_mode(), _under(mesh):
            caches = _init_caches(cfg, mesh, batch, max_len, device)
            return lm.lm_prefill(params, cfg, inputs, caches)

    return prefill_step


def _copy_into(dst, src):
    for k, v in src.items():
        if isinstance(v, dict):
            _copy_into(dst[k], v)
        else:
            dst[k].copy_(v)


def build_decode_step(cfg, mesh=None):
    """``decode_step(params, caches, token) -> (logits, caches)`` (under
    ``mesh``, per rank, as ``build_prefill_step``). The caches
    are updated in place and returned: the port's form of the JAX package's
    ``donate_argnums``, which keeps every cache buffer where it is. Attention
    layers write their new K/V row in place (``models/attention.py``) and
    Mamba layers their conv tails and SSM state (``models/mamba.py``), so
    nothing is copied for them; the small RNN caches come back new and are
    copied into the old buffers."""

    def decode_step(params, caches, token):
        with torch.inference_mode(), _under(mesh):
            logits, new = lm.lm_decode_step(params, cfg, caches, token)
            if new is not caches:
                _copy_into(caches, new)
            return logits, caches

    return decode_step


# ---------------------------------------------------------------------------
# Slot-multiplexed serving steps (continuous batching, ``serving/``).
#
# Fixed-shape steps that let one persistent step serve many independent
# streams: every call computes all B lanes, and a (B,) lane mask decides
# which lanes' cache updates are committed (``rnn.rnn_cache_merge_lanes``);
# the other lanes keep their bits. RNN caches only (the Scheduler enforces
# ``block_kind(cfg) == "rnn"``). The decode and chunk-prefill steps also take
# the greedy token on the device and return ``(next_tok (B,), logits
# (B, 1, V), caches)``, so a tick's host round trip is B token ids.
#
# The port's form of ``donate_argnums``: every step that changes the caches
# writes them into the buffers it was given and returns that same tree, so
# the pool's leaves never move (CUDA graphs replay over their addresses).
# ---------------------------------------------------------------------------

def _greedy(cfg, logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits[:, -1, : cfg.vocab], dim=-1)


def build_cache_init(cfg, mesh=None, *, batch: int, max_len: int = 1, device="cuda"):
    """Thunk returning fresh zero decode caches on ``device``: the slot
    pool's backing store; under ``mesh`` this rank's shards of them, as
    ``build_prefill_step`` allocates them."""

    def cache_init():
        return _init_caches(cfg, mesh, batch, max_len, device)

    return cache_init


def build_masked_decode_step(cfg):
    """Lane-masked one-token step: ``(params, caches, token (B, 1) int64,
    lane_mask (B,) bool) -> (next_tok (B,), logits (B, 1, V), caches)``.
    Lanes outside the mask run on placeholder tokens; the merge discards
    their compute and their cache bits stay as they were."""

    def decode_step(params, caches, token, lane_mask):
        with torch.inference_mode():
            logits, new = lm.lm_decode_step(params, cfg, caches, token)
            _copy_into(caches, rnn.rnn_cache_merge_lanes(caches, new, lane_mask))
            return _greedy(cfg, logits), logits, caches

    return decode_step


def build_chunk_prefill_step(cfg, *, chunk: int):
    """Slot-targeted chunked prefill into the existing caches: ``(params,
    caches, tokens (B, chunk) int64, lane_mask (B,) bool) -> (next_tok (B,),
    logits (B, 1, V), caches)``. A prompt is consumed ``chunk`` tokens a call
    with exact carry (the MTS schedule for the paper's RNNs) while resident
    lanes stay as they are under the mask. ``next_tok`` means something only
    for lanes whose prompt ends at this chunk's last position."""

    def prefill_step(params, caches, tokens, lane_mask):
        if tokens.shape[-1] != chunk:
            raise ValueError(f"chunk prefill: tokens {tuple(tokens.shape)}, chunk {chunk}")
        with torch.inference_mode():
            logits, new = lm.lm_prefill(params, cfg, {"inputs": tokens}, caches)
            _copy_into(caches, rnn.rnn_cache_merge_lanes(caches, new, lane_mask))
            return _greedy(cfg, logits), logits, caches

    return prefill_step


def build_verify_step(cfg, *, chunk: int):
    """Speculative-block verification: ``(params, caches, tokens (B, chunk)
    int64, lane_mask (B,) bool) -> (per_pos_tok (B, chunk), logits (B, chunk,
    V), caches)``. The drafted block rides the chunk-prefill path
    (``lm_verify`` keeps every position's logits), and ``per_pos_tok[:, i]``
    is the greedy sample after ``tokens[:, : i + 1]``, so acceptance is
    decided from one (B, chunk) array. Masked lanes keep their cache bits; a
    rejected lane is restored from its pre-block snapshot
    (``build_lane_snapshot`` / ``build_lane_inject``)."""

    def verify_step(params, caches, tokens, lane_mask):
        if tokens.shape[-1] != chunk:
            raise ValueError(f"verify: tokens {tuple(tokens.shape)}, chunk {chunk}")
        with torch.inference_mode():
            logits, new = lm.lm_verify(params, cfg, {"inputs": tokens}, caches)
            _copy_into(caches, rnn.rnn_cache_merge_lanes(caches, new, lane_mask))
            return torch.argmax(logits[..., : cfg.vocab], dim=-1), logits, caches

    return verify_step


def build_draft_block_step(cfg, *, k: int):
    """The draft half of a speculative block as one step: ``(params, caches,
    host_toks (B, k) int64, host_src (B, k) bool, lane_mask (B,) bool) ->
    block (B, k) int64``. It runs k masked one-token steps of the draft; the
    input at position p is ``host_toks[:, p]`` where ``host_src[:, p]`` (a
    lane's committed, unconsumed queue), else the draft's own output of the
    step before, chosen on the device. ``block`` holds the k tokens the
    draft consumed: the verify chunk's input. The JAX Scheduler runs these
    k steps one by one (``repro/serving/engine.py::_dispatch_spec``); as
    one step they are one CUDA graph on the card."""
    decode = build_masked_decode_step(cfg)

    def draft_block_step(params, caches, host_toks, host_src, lane_mask):
        if host_toks.shape[-1] != k:
            raise ValueError(f"draft block: tokens {tuple(host_toks.shape)}, k {k}")
        with torch.inference_mode():
            prev = torch.zeros_like(host_toks[:, 0])
            cols = []
            for p in range(k):
                col = torch.where(host_src[:, p], host_toks[:, p], prev)
                cols.append(col)
                prev, _, _ = decode(params, caches, col[:, None], lane_mask)
            return torch.stack(cols, dim=1)

    return draft_block_step


def build_lane_reset(cfg):
    """Lane-masked cache reset: ``(caches, lane_mask) -> caches`` with the
    masked lanes zeroed (a freshly admitted stream) and the rest bitwise."""

    def reset_step(caches, lane_mask):
        with torch.inference_mode():
            _copy_into(caches, rnn.rnn_cache_reset_lanes(caches, lane_mask))
            return caches

    return reset_step


def build_lane_snapshot(cfg):
    """Chunk-boundary state capture: ``(caches, lane) -> state``, every leaf
    (L, B, ...) -> (L, ...). ``lane`` is a 0-dim int64 tensor on the caches'
    device, so one captured snapshot serves every lane. The caches are only
    read; a captured snapshot's ``state`` is overwritten by its next replay."""

    def snapshot_step(caches, lane):
        with torch.inference_mode():
            return rnn.rnn_cache_extract_lane(caches, lane)

    return snapshot_step


def build_lane_inject(cfg):
    """Prefix-hit admission: ``(caches, lane, state) -> caches`` with
    ``state`` (a ``build_lane_snapshot`` result) written into ``lane`` and
    every other lane bitwise."""

    def inject_step(caches, lane, state):
        with torch.inference_mode():
            _copy_into(caches, rnn.rnn_cache_inject_lane(caches, lane, state))
            return caches

    return inject_step
