"""Train and serving steps, from ``repro/training/steps.py``: the train
step (``TrainState``, ``init_train_state``, ``build_train_step``,
``build_eval_step``), the batch path's ``build_prefill_step`` and
``build_decode_step``, and the fixed-shape lane-masked steps of continuous
batching (``serving/engine.py``).

Each builder closes over the config and returns a plain function. The
serving steps run under ``torch.inference_mode()``; the train step runs
eagerly with autograd (capturing it as a CUDA graph is later work).
``build_train_step`` and ``build_eval_step`` take a ``mesh`` too, as JAX's:
data parallelism, FSDP and the model axis's per-rank fused RNN and MoE
layers (:func:`build_train_step`).

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

from repro_torch.configs import shapes
from repro_torch.distribution import fused_sharded
from repro_torch.distribution import sharding as shd
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


# ---------------------------------------------------------------------------
# Training on a mesh of ranks
# ---------------------------------------------------------------------------

def train_param_specs(cfg, mesh, *, fsdp: bool = False):
    """The specs a train state's params are held under on ``mesh``: JAX's
    ``param_specs`` (``fsdp``: the ``fsdp_opt`` dims over ``data``) with
    the model axis kept only where the port computes per rank
    (``fused_sharded.rank_specs``); every other leaf is whole on each model
    rank."""
    whole = shapes.param_shapes(cfg)
    return fused_sharded.rank_specs(cfg, shd.param_specs(whole, mesh, fsdp=fsdp), mesh)


def train_state_specs(param_specs, compression: Optional[str] = None) -> TrainState:
    """The spec tree of a whole train state: the moments and the
    error-feedback state are held as the params are, the step whole."""
    ef = param_specs if compression not in (None, "none") else None
    return TrainState(params=param_specs, opt=AdamWState(step=(), m=param_specs, v=param_specs),
                      ef=ef)


def shard_train_state(state: TrainState, specs: TrainState, mesh) -> TrainState:
    """This rank's shards of a whole train state under ``specs``
    (:func:`train_state_specs`)."""
    return unflatten_like(state, [shd.local_shard(x, s, mesh) for x, s in
                                  zip(tree_leaves(state), tree_leaves(specs))])


def _data_dim(spec) -> Optional[int]:
    """The dim ``spec`` shards over ``data``, or None."""
    for dim, entry in enumerate(spec):
        if "data" in shd.spec_axes((entry,)):
            if entry != "data":
                raise ValueError(f"spec {spec}: the train step shards a dim over 'data' alone")
            return dim
    return None


def _token_count(batch) -> torch.Tensor:
    """The tokens ``lm_loss`` counts in ``batch``: its mask's sum, or every
    target without a mask."""
    mask = batch.get("mask")
    if mask is None:
        return torch.tensor(batch["targets"].numel(), dtype=torch.float32,
                            device=batch["targets"].device)
    return torch.sum(mask)


def _rank_rows(mesh, mb: int):
    """This rank's rows ``[lo, hi)`` of each microbatch of ``mb`` rows, or
    None when every data rank computes the whole microbatch (no data axis,
    or ``mb`` does not divide by it: JAX's divisibility fallback)."""
    D = 1 if mesh is None else mesh.shape.get("data", 1)
    if D == 1 or mb % D:
        return None
    r = mesh.coords["data"]
    return r * mb // D, (r + 1) * mb // D


def _reduce_over_data(g_sum, spec_list, mesh, split: bool):
    """The microbatch-summed grads of the whole params -> this rank's
    shards of the data-parallel sum: replicated leaves all-reduced in one
    flat buffer, data-sharded (FSDP) leaves reduce-scattered to the shard;
    without a split only the FSDP leaves are sliced to the shard."""
    out = list(g_sum)
    dims = [_data_dim(s) for s in spec_list]
    if mesh.shape.get("data", 1) == 1:
        return out
    data = mesh.axis("data")
    for i, dim in enumerate(dims):
        if dim is not None:
            out[i] = (data.reduce_scatter(out[i], dim) if split else
                      shd.local_shard(out[i], (None,) * dim + ("data",), mesh))
    whole = [i for i, dim in enumerate(dims) if dim is None]
    if split and whole:
        flat = data.all_reduce(torch.cat([out[i].reshape(-1) for i in whole]))
        for i, piece in zip(whole, torch.split(flat, [out[i].numel() for i in whole])):
            out[i] = piece.view_as(out[i])
    return out


def build_train_step(
    cfg,
    mesh=None,
    *,
    base_lr: float = 3e-4,
    warmup: int = 100,
    total_steps: int = 10000,
    compression: Optional[str] = None,
    specs=None,
):
    """``train_step(state, batch) -> (state, metrics)``: microbatched
    gradient accumulation (a Python loop, fp32 sums: JAX's ``lax.scan``),
    loss averaged over microbatches and grads scaled only when there are
    several, optional compression with error feedback, then AdamW at
    ``schedule(opt.step)``. The params, moments and step are updated in
    place and the same tensors returned (the port's ``donate_argnums``).
    ``metrics``: ``loss``, ``grad_norm``, ``lr`` (tensors on the device).

    Under ``mesh`` (a live ``launch/mesh.py`` mesh) the step runs under
    ``use_rules(mesh, sp=cfg.sequence_parallel)``, as JAX's, and the state
    holds this rank's shards under ``specs`` (a param spec tree,
    :func:`train_param_specs`; default the params whole on every data rank).
    ``batch`` is the global batch, the same on every rank, and the function
    is JAX's:

      * data: microbatch i is the global rows ``[i mb, (i+1) mb)``, of which
        data rank r computes its ``mb / D``; it divides its rows' NLL sum by
        the whole microbatch's token count (every rank holds the global
        mask), so the grads summed over ``data`` are JAX's under a ragged
        mask too. Where ``mb`` does not divide by D every data rank computes
        the whole microbatch and nothing is summed.
      * FSDP (specs with ``data`` on a dim, ``train_param_specs(fsdp=True)``):
        the params and moments are data shards at rest. This is the simple
        form: the step gathers the whole params at once before the forward
        (not layer by layer) and frees them after the backward; the grads
        are reduce-scattered to the shards and AdamW runs on the shard.
      * model: the sharded fused RNN path and MoE's expert-parallel layer
        run per rank through their autograd Functions
        (``distribution/fused_sharded.py``); the leaves held whole on every
        model rank get equal grads there, and nothing is reduced over
        ``model``.

    The clip norm and int8 compression's absmax are taken over whole leaves
    (``optim/``).

    Int8 weight-quantized configs are refused, as the JAX package's step
    refuses them (``jax.grad`` of int8 gate slabs is a ``TypeError``)."""
    if cfg.weight_quant == "int8":
        raise TypeError(
            f"{cfg.name}: int8 weight-quantized configs do not train (their gate slabs "
            "are int8, and the JAX package's build_train_step cannot differentiate them "
            "either); train the fp config and quantize at init"
        )
    schedule = cosine_schedule(base_lr, warmup, total_steps)
    if mesh is not None and specs is None:
        specs = train_param_specs(cfg, mesh)

    def train_step(state: TrainState, batch: Dict):
        with _under(mesh, cfg.sequence_parallel):
            return _step(state, batch)

    def _step(state: TrainState, batch: Dict):
        n_mb = cfg.microbatches
        spec_list = None if mesh is None else tree_leaves(specs)
        whole = tree_leaves(state.params)
        if mesh is not None:  # FSDP: the whole params, freed after the backward
            whole = [shd.gather_shard(p, s, mesh, axes=("data",))
                     for p, s in zip(whole, spec_list)]
        leaves = [p.detach().requires_grad_() for p in whole]
        del whole
        params = unflatten_like(state.params, leaves)
        mb_rows = next(iter(batch.values())).shape[0] // n_mb
        rows = _rank_rows(mesh, mb_rows)

        def grads_of(mb):
            denom = None
            if rows is not None:
                denom = torch.clamp(_token_count(mb), min=1.0)
                mb = {k: v[rows[0]:rows[1]] for k, v in mb.items()}
            loss, _ = lm.lm_loss(params, cfg, mb, denom=denom)
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
        del params, leaves
        if mesh is not None:
            g_sum = _reduce_over_data(g_sum, spec_list, mesh, rows is not None)
            if rows is not None:
                loss = mesh.axis("data").all_reduce(loss)
        grads = unflatten_like(state.params, g_sum)
        grads, new_ef = compress_grads(grads, state.ef, compression, mesh=mesh, specs=specs)
        lr = schedule(state.opt.step)
        new_params, new_opt, opt_metrics = adamw_update(grads, state.opt, state.params, lr,
                                                        mesh=mesh, specs=specs)
        return TrainState(params=new_params, opt=new_opt, ef=new_ef), {"loss": loss, **opt_metrics}

    return train_step


def build_eval_step(cfg, mesh=None, *, specs=None):
    """``eval_step(params, batch) -> metrics`` (``loss``, ``tokens``), no
    grads. Under ``mesh``, as :func:`build_train_step`: the params this
    rank's shards under ``specs`` (gathered whole over ``data`` for the
    call), ``batch`` the global batch, each data rank its rows when they
    divide, the loss summed over ``data``."""
    if mesh is not None and specs is None:
        specs = train_param_specs(cfg, mesh)

    def eval_step(params, batch):
        with torch.no_grad(), _under(mesh, cfg.sequence_parallel):
            if mesh is None:
                _, metrics = lm.lm_loss(params, cfg, batch)
                return metrics
            params = tree_map(lambda p, s: shd.gather_shard(p, s, mesh, axes=("data",)),
                              params, specs)
            tokens = _token_count(batch)
            rows = _rank_rows(mesh, batch["targets"].shape[0])
            if rows is None:
                return lm.lm_loss(params, cfg, batch)[1]
            loss, _ = lm.lm_loss(params, cfg, {k: v[rows[0]:rows[1]] for k, v in batch.items()},
                                 denom=torch.clamp(tokens, min=1.0))
            loss = mesh.axis("data").all_reduce(loss)
            return {"loss": loss, "tokens": tokens}

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


def _under(mesh, sp: bool = False):
    """``use_rules(mesh, sp=sp)``, or nothing without a mesh."""
    return contextlib.nullcontext() if mesh is None else use_rules(mesh, sp=sp)


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
