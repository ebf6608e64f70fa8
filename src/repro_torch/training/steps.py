"""Train and serving steps, from ``repro/training/steps.py``: the train
step (``TrainState``, ``init_train_state``, ``build_train_step`` and its
first half ``step_grads``, ``build_eval_step``), the batch path's
``build_prefill_step`` and ``build_decode_step``, and the fixed-shape
lane-masked steps of continuous batching (``serving/engine.py``).

Each builder closes over the config and returns a plain function. The
serving steps run under ``torch.inference_mode()``; the train step runs
eagerly with autograd (capturing it as a CUDA graph is later work).
``build_train_step`` and ``build_eval_step`` take a ``mesh`` too, as JAX's:
data parallelism, FSDP gathered a layer at a time, and the model axis's
per-rank RNN layers, vocab leaves, attention, MLP and Mamba blocks and MoE
experts in every schedule (:func:`build_train_step`).

Every serving builder takes a ``mesh`` (``launch/mesh.py``), as JAX's do:
each rank then allocates its shards of the caches
(``fused_sharded.rank_cache_specs``, JAX's ``cache_specs``: the RNN
carries (L, B, H) with their lanes over "model" where H divides, the KV
caches over their heads or else their sequence, the SSM state over its
heads, the batch over "data") and runs the step under
``sharding.use_rules``, so the RNN layers, the vocab leaves and the
attention, MLP and Mamba blocks (``models/attention.py``, ``mamba.py``)
run per rank. The batch path's steps (``build_prefill_step``,
``build_decode_step``) take this rank's shards of the inputs. The
lane-masked steps of continuous batching take the global (B,) lane mask and
(B, .) tokens, slice them to the rank's lanes, and gather the sampled
tokens over "data", so the engine on every rank sees the same B token ids;
a lane snapshot is broadcast over "data" from the rank that holds the lane,
and an inject writes only there.
"""
from __future__ import annotations

import contextlib
from typing import Dict, NamedTuple, Optional

import torch

from repro_torch.configs import shapes
from repro_torch.distribution import fused_sharded
from repro_torch.distribution import sharding as shd
from repro_torch.distribution.sharding import local_shape, use_rules
from repro_torch.launch.mesh import FsdpPlan, loop_body
from repro_torch.models import attention, lm, rnn
from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update, cosine_schedule
from repro_torch.optim.compression import compress_grads, ef_init
from repro_torch.tree import flatten_with_paths, tree_leaves, tree_map, unflatten_like


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
    ``param_specs`` (``fsdp``: the ``fsdp_opt`` dims over ``data``) as
    ``fused_sharded.rank_specs`` keeps them: every leaf as JAX places it
    but ``wq_scale`` (int8 configs do not train), the MoE experts over
    "model" or on their ``ff_moe`` columns in every schedule. A leaf's grad
    is then this rank's shard of it, and the clip norm and int8
    compression's absmax reduce over the axes its spec names
    (``sharding.spec_axes``)."""
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


def _dp_size(mesh) -> int:
    """The ranks of ``mesh``'s data-parallel axes, ("pod", "data")."""
    return 1 if mesh is None else mesh.shape.get("pod", 1) * mesh.shape.get("data", 1)


def _rank_rows(mesh, mb: int):
    """This rank's rows ``[lo, hi)`` of each microbatch of ``mb`` rows, or
    None when every data-parallel rank computes the whole microbatch (no
    data axis, or ``mb`` does not divide by the ranks of ("pod", "data"):
    JAX's divisibility fallback)."""
    D = _dp_size(mesh)
    if D == 1 or mb % D:
        return None
    r = mesh.dp_group().index
    return r * mb // D, (r + 1) * mb // D


def fsdp_plan(mesh, specs, reduce: bool) -> Optional[FsdpPlan]:
    """The FSDP gathers of a step on ``mesh`` under the param ``specs``
    (``launch/mesh.py::FsdpPlan``, over "data" alone, as JAX's ``fsdp``
    rule shards; ``reduce``: the data ranks compute different rows), or
    None: no mesh or data axis, or no leaf sharded over it."""
    if mesh is None or specs is None or mesh.shape.get("data", 1) == 1:
        return None
    dims = shd.map_with_paths(lambda path, spec: _data_dim(spec), specs)
    return FsdpPlan(dims, mesh.axis("data"), reduce) if tree_leaves(dims) else None


def _all_reduce_flat(group, out, idx) -> None:
    """``out[i]`` for ``i`` in ``idx`` summed over ``group`` in one flat
    buffer, in place of the list's entries."""
    flat = group.all_reduce(torch.cat([out[i].reshape(-1) for i in idx]))
    for i, piece in zip(idx, torch.split(flat, [out[i].numel() for i in idx])):
        out[i] = piece.view_as(out[i])


def _reduce_over_data(g_sum, spec_list, mesh, split: bool):
    """The microbatch-summed grads of this rank's shards -> the
    data-parallel sum: where the data-parallel ranks computed different
    rows (``split``), the leaves held whole over "data" are all-reduced
    over ("pod", "data") in one flat buffer. The FSDP leaves' grads are
    already their shard's sum over "data": the backward of their gathers
    reduce-scattered them (``FsdpPlan``); a "pod" axis sums them over it."""
    out = list(g_sum)
    if not split or _dp_size(mesh) == 1:
        return out
    whole = [i for i, s in enumerate(spec_list) if _data_dim(s) is None]
    if whole:
        _all_reduce_flat(mesh.dp_group(), out, whole)
    sharded = [i for i, s in enumerate(spec_list) if _data_dim(s) is not None]
    if sharded and mesh.shape.get("pod", 1) > 1:
        _all_reduce_flat(mesh.axis("pod"), out, sharded)
    return out


def _reduce_over_model(cfg, g_sum, params, spec_list, seq_len: int):
    """Under sequence parallelism (``sharding.seq_group`` of ``seq_len``)
    the grads of the leaves held whole over "model" that the rank used on
    its sequence slice or in a Megatron-SP region
    (``lm.sequence_partial_keys``: the norms, a q/k norm, a leaf the axis
    does not divide) are the rank's part: summed over "model" in one flat
    buffer. The leaves sharded over "model" already hold their whole
    grad."""
    seq = shd.seq_group(seq_len)
    if seq is None:
        return g_sum
    keys = lm.sequence_partial_keys(cfg)
    idx = [i for i, ((path, _), s) in enumerate(zip(flatten_with_paths(params), spec_list))
           if path.split("/")[0] in keys and shd.replicated_on(s, shd.MODEL_AXIS)]
    if idx:
        _all_reduce_flat(seq, g_sum, idx)
    return g_sum


def step_grads(cfg, params, batch: Dict, mesh=None, specs=None):
    """The train step's loss and grads: ``(loss, grads)``, the
    microbatches' mean loss and mean fp32 grads (a tree like ``params``),
    as :func:`build_train_step`'s step computes them before compression
    and AdamW. Under ``mesh`` as that step: ``params`` this rank's shards
    under ``specs`` (default :func:`train_param_specs`), ``batch`` the
    global batch, the grads this rank's shards of the sum over ``data``."""
    if mesh is not None and specs is None:
        specs = train_param_specs(cfg, mesh)
    with _under(mesh, cfg.sequence_parallel):
        return _step_grads(cfg, params, batch, mesh, specs)


def _step_grads(cfg, params, batch: Dict, mesh, specs):
    n_mb = cfg.microbatches
    spec_list = None if mesh is None else tree_leaves(specs)
    # The rank's shards: an FSDP leaf is gathered where its block uses it
    # (lm.lm_hidden), and its grad comes back shard-size.
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    tree = unflatten_like(params, leaves)
    mb_rows = next(iter(batch.values())).shape[0] // n_mb
    rows = _rank_rows(mesh, mb_rows)
    fsdp = fsdp_plan(mesh, specs, rows is not None)

    def grads_of(mb):
        denom = None
        if rows is not None:
            denom = torch.clamp(_token_count(mb), min=1.0)
            mb = {k: v[rows[0]:rows[1]] for k, v in mb.items()}
        loss, _ = lm.lm_loss(tree, cfg, mb, denom=denom, fsdp=fsdp)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p, dtype=torch.float32) if g is None
                               else g.float() for p, g in zip(leaves, grads)]

    if n_mb == 1:
        loss, g_sum = grads_of(batch)
    else:
        # Summed in place, each microbatch's grads dropped before the
        # next's exist: one fp32 copy of the shards' size beside the sum.
        g_sum = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
        loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        for i in range(n_mb):
            with loop_body():
                loss_i, g_i = grads_of(_split_microbatch(batch, n_mb, i))
            for a, g in zip(g_sum, g_i):
                a.add_(g)
            del g_i
            loss = loss + loss_i
        loss = loss / n_mb
        for g in g_sum:
            g.div_(n_mb)
    del tree, leaves
    if mesh is not None:
        g_sum = _reduce_over_data(g_sum, spec_list, mesh, rows is not None)
        g_sum = _reduce_over_model(cfg, g_sum, params, spec_list, batch["targets"].shape[1])
        if rows is not None:
            loss = mesh.dp_group().all_reduce(loss)
    return loss, unflatten_like(params, g_sum)


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
        data-parallel rank r (over ("pod", "data"), ``Mesh.dp_group``: D
        ranks) computes its ``mb / D``; it divides its rows' NLL sum by
        the whole microbatch's token count (every rank holds the global
        mask), so the grads summed over those ranks are JAX's under a ragged
        mask too. Where ``mb`` does not divide by D every data rank computes
        the whole microbatch and nothing is summed.
      * FSDP (specs with ``data`` on a dim, ``train_param_specs(fsdp=True)``):
        the params and moments are data shards at rest. Each block gathers
        its own layer over "data" where it runs, inside its remat region
        (``lm.lm_hidden``, :func:`fsdp_plan`), as JAX's scanned layers do:
        under ``remat="block"`` a rank holds one layer gathered at a time,
        and the backward gathers it again. The gather's backward
        reduce-scatters each microbatch's cotangent to the shard (where
        ``mb`` does not divide by D: takes the rank's block, no sum), so the
        grads are shard-size and summed over microbatches as such; AdamW
        runs on the shard.
      * model: the RNN layers (``distribution/fused_sharded.py`` for the
        fused engines, ``distribution/tensor_parallel.py`` for the others,
        ``pallas`` on B3 per rank, and the LSTM), the vocab leaves, the
        attention, dense MLP and Mamba blocks (``models/attention.py``,
        ``mamba.py``, ``lm._mlp``: the rank's heads, "ff" columns and rows,
        ``ssd_chunked`` on its Mamba heads) and the MoE experts
        (``models/moe.py``: the rank's experts, or their ``ff_moe``
        columns, in every schedule) run per rank through ``launch/mesh.py``'s
        autograd collectives; each model-sharded leaf gets its own shard's
        grad, the leaves held whole on every model rank get equal grads
        there, and nothing is reduced over ``model``.
      * sequence parallelism (``cfg.sequence_parallel``, a model axis that
        divides the sequence): the residual stream between blocks is the
        rank's sequence slice (``lm.lm_hidden``: Megatron-SP around the
        attention and dense MLP, the other blocks on the gathered
        sequence), and the grads of the leaves held whole over "model" that
        ran on the slice are summed over it (:func:`_reduce_over_model`).

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
            loss, grads = _step_grads(cfg, state.params, batch, mesh, specs)
            grads, new_ef = compress_grads(grads, state.ef, compression, mesh=mesh, specs=specs)
            lr = schedule(state.opt.step)
            new_params, new_opt, opt_metrics = adamw_update(grads, state.opt, state.params, lr,
                                                            mesh=mesh, specs=specs)
        return TrainState(params=new_params, opt=new_opt, ef=new_ef), {"loss": loss, **opt_metrics}

    return train_step


def build_eval_step(cfg, mesh=None, *, specs=None):
    """``eval_step(params, batch) -> metrics`` (``loss``, ``tokens``), no
    grads. Under ``mesh``, as :func:`build_train_step`: the params this
    rank's shards under ``specs`` (FSDP leaves gathered over ``data`` a
    layer at a time, as the train step's forward gathers them), ``batch``
    the global batch, each data rank its rows when they divide, the loss
    summed over ``data``."""
    if mesh is not None and specs is None:
        specs = train_param_specs(cfg, mesh)

    def eval_step(params, batch):
        with torch.no_grad(), _under(mesh, cfg.sequence_parallel):
            if mesh is None:
                _, metrics = lm.lm_loss(params, cfg, batch)
                return metrics
            tokens = _token_count(batch)
            rows = _rank_rows(mesh, batch["targets"].shape[0])
            fsdp = fsdp_plan(mesh, specs, rows is not None)
            if rows is None:
                return lm.lm_loss(params, cfg, batch, fsdp=fsdp)[1]
            loss, _ = lm.lm_loss(params, cfg, {k: v[rows[0]:rows[1]] for k, v in batch.items()},
                                 denom=torch.clamp(tokens, min=1.0), fsdp=fsdp)
            loss = mesh.dp_group().all_reduce(loss)
            return {"loss": loss, "tokens": tokens}

    return eval_step


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def _init_caches(cfg, mesh, batch: int, max_len: int, device):
    """Zero caches on ``device``: whole, or under ``mesh`` this rank's
    shards of them (``fused_sharded.rank_cache_specs``), sized from the
    whole caches' shapes alone (``lm.lm_cache_shapes``): no tensor of the
    global caches is made, on any device."""
    if mesh is None:
        return lm.lm_init_caches(cfg, batch, max_len, device=device)
    whole = lm.lm_cache_shapes(cfg, batch, max_len)
    specs = fused_sharded.rank_cache_specs(cfg, whole, mesh)
    return tree_map(lambda leaf, spec: torch.zeros(local_shape(leaf.shape, spec, mesh),
                                                   dtype=leaf.dtype, device=device),
                    whole, specs)


def _under(mesh, sp: bool = False):
    """``use_rules(mesh, sp=sp)``, or nothing without a mesh."""
    return contextlib.nullcontext() if mesh is None else use_rules(mesh, sp=sp)


def build_prefill_step(cfg, mesh=None, *, batch: int, max_len: int, device="cuda", specs=None):
    """``prefill_step(params, inputs) -> (logits, caches)``: fresh zero caches
    on ``device`` (under ``mesh``, this rank's shards of them, for the
    global ``batch``), then one MTS prefill over the prompt.

    ``specs``: the param specs ``params`` are this rank's shards under
    (JAX's ``param_specs(params, mesh, fsdp=cfg.fsdp)``, as its dry run
    serves the ``fsdp`` configs); a leaf sharded over "data" is gathered
    where it is used, a layer at a time (``lm.lm_prefill``'s ``fsdp``,
    :func:`fsdp_plan`). Without them, or with no leaf over "data", the
    params are used as they are."""
    fsdp = fsdp_plan(mesh, specs, False)

    def prefill_step(params, inputs: Dict):
        with torch.inference_mode(), _under(mesh), attention.cache_length(max_len):
            caches = _init_caches(cfg, mesh, batch, max_len, device)
            return lm.lm_prefill(params, cfg, inputs, caches, fsdp)

    return prefill_step


def _copy_into(dst, src):
    for k, v in src.items():
        if isinstance(v, dict):
            _copy_into(dst[k], v)
        else:
            dst[k].copy_(v)


def build_decode_step(cfg, mesh=None, *, max_len: Optional[int] = None, specs=None):
    """``decode_step(params, caches, token) -> (logits, caches)`` (under
    ``mesh``, per rank, as ``build_prefill_step``; ``max_len`` is the
    length the caches were made for, required where the KV heads do not
    divide the model axis (``attention.needs_cache_length``): a rank's cache
    may then hold a slice of the sequence, which its shape does not tell
    apart from a whole cache, and the builder raises without it). The caches
    are updated in place and returned: the port's form of the JAX package's
    ``donate_argnums``, which keeps every cache buffer where it is. Attention
    layers write their new K/V row in place (``models/attention.py``) and
    Mamba layers their conv tails and SSM state (``models/mamba.py``), so
    nothing is copied for them; the small RNN caches come back new and are
    copied into the old buffers. ``specs``: as :func:`build_prefill_step`'s
    (FSDP-sharded weights gathered a layer at a time)."""

    if max_len is None and attention.needs_cache_length(cfg, mesh):
        raise ValueError(
            f"{cfg.name}: {cfg.n_kv_heads} KV heads do not divide the model axis of "
            f"{shd.model_shards(mesh)}, so the KV cache may hold a slice of its sequence; "
            "pass the caches' max_len (build_decode_step(cfg, mesh, max_len=))")

    fsdp = fsdp_plan(mesh, specs, False)

    def decode_step(params, caches, token):
        with torch.inference_mode(), _under(mesh), attention.cache_length(max_len):
            logits, new = lm.lm_decode_step(params, cfg, caches, token, fsdp)
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


def _pool_lanes(mesh, batch: int):
    """This rank's lanes ``[lo, hi)`` of a ``batch``-lane pool under
    ``mesh``, where ``fused_sharded._batch_spec`` shards the batch over
    "data"; None when the rank holds every lane (no mesh, a data axis of
    one rank, or a batch the data axis does not divide)."""
    if mesh is None:
        return None
    spec = fused_sharded._batch_spec(mesh, batch)
    if spec is None:
        return None
    i, k = shd.shard_index(spec, mesh)
    if k == 1:
        return None
    n = batch // k
    return i * n, (i + 1) * n


def _mine(x: torch.Tensor, lanes) -> torch.Tensor:
    """This rank's rows of a global (B, ...) host input."""
    return x if lanes is None else x[lanes[0]:lanes[1]]


def _all_lanes(x: torch.Tensor, mesh, lanes) -> torch.Tensor:
    """The data ranks' (B/D, ...) results side by side along dim 0, in axis
    order: the global (B, ...) result on every rank."""
    return x if lanes is None else mesh.axis("data").all_gather(x, dim=0)


def _masked_decode(cfg, params, caches, token, lane_mask):
    """One lane-masked token step on the lanes the caches hold."""
    logits, new = lm.lm_decode_step(params, cfg, caches, token)
    _copy_into(caches, rnn.rnn_cache_merge_lanes(caches, new, lane_mask))
    return _greedy(cfg, logits), logits


def build_masked_decode_step(cfg, mesh=None):
    """Lane-masked one-token step: ``(params, caches, token (B, 1) int64,
    lane_mask (B,) bool) -> (next_tok (B,), logits, caches)``. Lanes outside
    the mask run on placeholder tokens; the merge discards their compute and
    their cache bits stay as they were.

    Under ``mesh`` (as every lane-masked builder here) the step runs under
    ``use_rules``: ``params`` and ``caches`` are this rank's shards
    (``fused_sharded.rank_cache_specs``: lanes over "data", H over "model"
    where the fused path runs per rank), ``token`` and ``lane_mask`` the
    global arrays, of which the rank takes its lanes; ``next_tok`` is
    gathered over "data" into the global (B,) array, the same on every rank.
    ``logits`` are this rank's lanes' (B/D, 1, V)."""

    def decode_step(params, caches, token, lane_mask):
        with torch.inference_mode(), _under(mesh):
            lanes = _pool_lanes(mesh, lane_mask.shape[0])
            nxt, logits = _masked_decode(cfg, params, caches, _mine(token, lanes),
                                         _mine(lane_mask, lanes))
            return _all_lanes(nxt, mesh, lanes), logits, caches

    return decode_step


def build_chunk_prefill_step(cfg, mesh=None, *, chunk: int):
    """Slot-targeted chunked prefill into the existing caches: ``(params,
    caches, tokens (B, chunk) int64, lane_mask (B,) bool) -> (next_tok (B,),
    logits, caches)``. A prompt is consumed ``chunk`` tokens a call with
    exact carry (the MTS schedule for the paper's RNNs) while resident lanes
    stay as they are under the mask. ``next_tok`` means something only for
    lanes whose prompt ends at this chunk's last position. Under ``mesh``
    as :func:`build_masked_decode_step`."""

    def prefill_step(params, caches, tokens, lane_mask):
        if tokens.shape[-1] != chunk:
            raise ValueError(f"chunk prefill: tokens {tuple(tokens.shape)}, chunk {chunk}")
        with torch.inference_mode(), _under(mesh):
            lanes = _pool_lanes(mesh, lane_mask.shape[0])
            logits, new = lm.lm_prefill(params, cfg, {"inputs": _mine(tokens, lanes)}, caches)
            _copy_into(caches, rnn.rnn_cache_merge_lanes(caches, new, _mine(lane_mask, lanes)))
            return _all_lanes(_greedy(cfg, logits), mesh, lanes), logits, caches

    return prefill_step


def build_verify_step(cfg, mesh=None, *, chunk: int):
    """Speculative-block verification: ``(params, caches, tokens (B, chunk)
    int64, lane_mask (B,) bool) -> (per_pos_tok (B, chunk), logits (B, chunk,
    V), caches)``. The drafted block rides the chunk-prefill path
    (``lm_verify`` keeps every position's logits), and ``per_pos_tok[:, i]``
    is the greedy sample after ``tokens[:, : i + 1]``, so acceptance is
    decided from one (B, chunk) array. Masked lanes keep their cache bits; a
    rejected lane is restored from its pre-block snapshot
    (``build_lane_snapshot`` / ``build_lane_inject``). Under ``mesh`` as
    :func:`build_masked_decode_step`: ``per_pos_tok`` global, ``logits``
    this rank's lanes'."""

    def verify_step(params, caches, tokens, lane_mask):
        if tokens.shape[-1] != chunk:
            raise ValueError(f"verify: tokens {tuple(tokens.shape)}, chunk {chunk}")
        with torch.inference_mode(), _under(mesh):
            lanes = _pool_lanes(mesh, lane_mask.shape[0])
            logits, new = lm.lm_verify(params, cfg, {"inputs": _mine(tokens, lanes)}, caches)
            _copy_into(caches, rnn.rnn_cache_merge_lanes(caches, new, _mine(lane_mask, lanes)))
            toks = torch.argmax(logits[..., : cfg.vocab], dim=-1)
            return _all_lanes(toks, mesh, lanes), logits, caches

    return verify_step


def build_draft_block_step(cfg, mesh=None, *, k: int):
    """The draft half of a speculative block as one step: ``(params, caches,
    host_toks (B, k) int64, host_src (B, k) bool, lane_mask (B,) bool) ->
    block (B, k) int64``. It runs k masked one-token steps of the draft; the
    input at position p is ``host_toks[:, p]`` where ``host_src[:, p]`` (a
    lane's committed, unconsumed queue), else the draft's own output of the
    step before, chosen on the device. ``block`` holds the k tokens the
    draft consumed: the verify chunk's input. The JAX Scheduler runs these
    k steps one by one (``repro/serving/engine.py::_dispatch_spec``); as
    one step they are one CUDA graph on the card. Under ``mesh`` each rank
    runs its lanes' k steps and ``block`` is gathered over "data" once."""

    def draft_block_step(params, caches, host_toks, host_src, lane_mask):
        if host_toks.shape[-1] != k:
            raise ValueError(f"draft block: tokens {tuple(host_toks.shape)}, k {k}")
        with torch.inference_mode(), _under(mesh):
            lanes = _pool_lanes(mesh, lane_mask.shape[0])
            host_toks, host_src = _mine(host_toks, lanes), _mine(host_src, lanes)
            lane_mask = _mine(lane_mask, lanes)
            prev = torch.zeros_like(host_toks[:, 0])
            cols = []
            for p in range(k):
                col = torch.where(host_src[:, p], host_toks[:, p], prev)
                cols.append(col)
                prev, _ = _masked_decode(cfg, params, caches, col[:, None], lane_mask)
            return _all_lanes(torch.stack(cols, dim=1), mesh, lanes)

    return draft_block_step


def build_lane_reset(cfg, mesh=None):
    """Lane-masked cache reset: ``(caches, lane_mask) -> caches`` with the
    masked lanes zeroed (a freshly admitted stream) and the rest bitwise.
    Under ``mesh`` each rank resets its own lanes of the global mask."""

    def reset_step(caches, lane_mask):
        with torch.inference_mode():
            lanes = _pool_lanes(mesh, lane_mask.shape[0])
            _copy_into(caches, rnn.rnn_cache_reset_lanes(caches, _mine(lane_mask, lanes)))
            return caches

    return reset_step


def _need_batch(mesh, batch) -> None:
    if mesh is not None and batch is None:
        raise ValueError("a lane snapshot or inject under a mesh needs the pool's batch")


def _owner(mesh, lanes, lane):
    """(the data index that holds global lane ``lane``, its index there)."""
    n = lanes[1] - lanes[0]
    lane = int(lane)
    return lane // n, lane % n


def build_lane_snapshot(cfg, mesh=None, *, batch: Optional[int] = None):
    """Chunk-boundary state capture: ``(caches, lane) -> state``, every leaf
    (L, B, ...) -> (L, ...). ``lane`` is a 0-dim int64 tensor on the caches'
    device, so one captured snapshot serves every lane. The caches are only
    read; a captured snapshot's ``state`` is overwritten by its next replay.

    Under ``mesh`` (``batch``: the pool's global lane count) ``lane`` is
    global (an int, or a tensor read on the host): the data rank that holds
    it takes the snapshot of its shard and broadcasts it over "data", so
    every rank returns the same state, whole over "data" and its shard over
    "model" (the prefix cache and the rollback buffers are then alike on
    every rank)."""
    _need_batch(mesh, batch)

    def snapshot_step(caches, lane):
        with torch.inference_mode():
            lanes = None if mesh is None else _pool_lanes(mesh, batch)
            if lanes is None:
                return rnn.rnn_cache_extract_lane(caches, lane)
            src, local = _owner(mesh, lanes, lane)
            data = mesh.axis("data")
            return tree_map(
                lambda leaf: data.broadcast(leaf[:, local] if data.index == src else None, src,
                                            like=leaf[:, 0]), caches)

    return snapshot_step


def build_lane_inject(cfg, mesh=None, *, batch: Optional[int] = None):
    """Prefix-hit admission: ``(caches, lane, state) -> caches`` with
    ``state`` (a ``build_lane_snapshot`` result) written into ``lane`` and
    every other lane bitwise. Under ``mesh`` (``batch`` as for the
    snapshot) only the data rank that holds the global ``lane`` writes; the
    others leave their lanes as they are."""
    _need_batch(mesh, batch)

    def inject_step(caches, lane, state):
        with torch.inference_mode():
            _inject(caches, lane, state, mesh, batch)
            return caches

    return inject_step


def _inject(caches, lane, state, mesh, batch) -> None:
    """``state`` into ``lane`` of the caches, in place; under ``mesh`` only
    on the data rank that holds the global ``lane``."""
    lanes = None if mesh is None else _pool_lanes(mesh, batch)
    if lanes is not None:
        src, lane = _owner(mesh, lanes, lane)
        if mesh.axis("data").index != src:
            return
    _copy_into(caches, rnn.rnn_cache_inject_lane(caches, lane, state))
