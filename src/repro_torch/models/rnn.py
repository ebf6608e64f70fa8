"""LM blocks of the paper's own models, from ``repro/models/rnn.py``:
stacked SRU / QRNN / LSTM layers. Block = pre-norm + cell + residual
(d_in == hidden == d_model).

``cfg.scan_engine`` selects the recurrence schedule of SRU/QRNN blocks
(``core/scan.py``); LSTM ignores it and runs ``core/mts.py::lstm_forward``,
as in the JAX package. Two granularities:

  * per-layer — ``rnn_block_init/apply/prefill/decode`` + ``rnn_init_cache``:
    one block at a time; ``models/lm.py`` loops them over the layers
    (``engine="fused"``: one whole-layer kernel per block).
  * stack-level — ``rnn_stack_apply/prefill/decode``: the whole stack in one call,
    with stacked params ``(L, ...)`` and a stacked cache ``(L, B, H)``. With
    ``cfg.scan_engine == "fused_stack"`` (SRU/QRNN, d_model == hidden) it
    runs the depth-fused stack (``kernels/fused_rnn/stacked.py``).

Under an active mesh (``distribution/sharding.py::use_rules``, entered by
the step builders) whose model axis divides the hidden width
(``distribution/fused_sharded.py::sharding_mesh``, asked once a call here),
every engine runs per rank on the rank's lane shards: the layer through
``core/mts.py``'s ``mesh`` argument (the fused engines in
``distribution/fused_sharded.py``, the others in
``distribution/tensor_parallel.py``), the depth-fused stack here, in the
barrier schedule or, with ``cfg.ring_overlap``, the ring. The LSTM runs on
the rank's columns of its gate-major weights when the model axis divides 4H,
and keeps its lanes of the carries when it divides H.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core import cells, mts
from repro_torch.distribution import fused_sharded, tensor_parallel
from repro_torch.kernels.fused_rnn import stacked
from repro_torch.models.layers import rmsnorm, rmsnorm_init
from repro_torch.tree import tree_map

_INITS = {"sru": cells.sru_init, "qrnn": cells.qrnn_init, "lstm": cells.lstm_init}


def rnn_block_init(gen, cfg, dtype, device) -> Dict:
    d, h = cfg.d_model, cfg.rnn_hidden
    return {
        "ln1": rmsnorm_init(d, dtype, device),
        "cell": _INITS[cfg.cell](gen, d, h, dtype, device),
    }


def rnn_block_apply(params, cfg, x: torch.Tensor) -> torch.Tensor:
    """Train: the full sequence through the MTS executor from a zero state.
    x: (B, T, d). Differentiable on every engine: the fused kernels through
    their autograd Functions, ``pallas`` through the linear scan's."""
    h = rmsnorm(params["ln1"], x)
    mesh = fused_sharded.sharding_mesh(cfg)
    if cfg.cell == "sru":
        out, _ = mts.mts_sru(params["cell"], h, engine=cfg.scan_engine,
                             block_size=cfg.mts_block_size, mesh=mesh)
    elif cfg.cell == "qrnn":
        out, _ = mts.mts_qrnn(params["cell"], h, engine=cfg.scan_engine,
                              block_size=cfg.mts_block_size, mesh=mesh)
    else:
        out, _ = mts.lstm_forward(params["cell"], h, precompute=True, mesh=mesh)
    return x + out


def rnn_cache_shapes(cfg, batch: int, dtype) -> Dict:
    """``{leaf: (shape, dtype)}`` of :func:`rnn_init_cache`, no tensor made."""
    h = cfg.rnn_hidden
    shapes = {"c": ((batch, h), dtype)}
    if cfg.cell == "qrnn":
        shapes["x_tail"] = ((batch, 1, cfg.d_model), dtype)
    if cfg.cell == "lstm":
        shapes["h"] = ((batch, h), dtype)
    return shapes


def rnn_init_cache(cfg, batch: int, dtype, device) -> Dict:
    return {k: torch.zeros(s, dtype=dt, device=device)
            for k, (s, dt) in rnn_cache_shapes(cfg, batch, dtype).items()}


def rnn_block_prefill(params, cfg, x: torch.Tensor, cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """x: (B, T, d). The per-layer path rounds to ``x``'s dtype at every
    layer: the norm, the cell's ``h`` and the residual add, as in JAX."""
    h = rmsnorm(params["ln1"], x)
    mesh = fused_sharded.sharding_mesh(cfg)
    if cfg.cell == "sru":
        out, c_last = mts.mts_sru(
            params["cell"], h, cache["c"],
            engine=cfg.scan_engine, block_size=cfg.mts_block_size, mesh=mesh,
        )
        cache = {"c": c_last}
    elif cfg.cell == "qrnn":
        out, c_last = mts.mts_qrnn(
            params["cell"], h, cache["c"], cache["x_tail"],
            engine=cfg.scan_engine, block_size=cfg.mts_block_size, mesh=mesh,
        )
        cache = {"c": c_last, "x_tail": h[:, -1:]}
    else:
        out, c_last = mts.lstm_forward(params["cell"], h, cache["h"], cache["c"], mesh=mesh)
        width = cache["c"].shape[-1]  # this rank's lanes of the carries at rest
        cache = {"c": tensor_parallel.own_lanes(c_last, width, mesh),
                 "h": tensor_parallel.own_lanes(out[:, -1], width, mesh)}
    return x + out, cache


def rnn_block_decode(params, cfg, x: torch.Tensor, cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """One token; for SRU/QRNN this is MTS with T=1 (the SRU-1 regime)."""
    return rnn_block_prefill(params, cfg, x, cache)


# ---------------------------------------------------------------------------
# Stack-level API: params carry a leading layer dim on every leaf; caches are
# the per-layer caches stacked the same way (``models/lm.py::lm_init_caches``).
# ---------------------------------------------------------------------------

def _depth_fusible(cfg) -> bool:
    """The depth-fused stack covers SRU/QRNN stacks with d_model == hidden
    (the residual stream feeds each layer at full width). LSTM and other
    stacks fall back to the per-layer loop."""
    return (
        cfg.scan_engine == "fused_stack"
        and cfg.cell in ("sru", "qrnn")
        and cfg.d_model == cfg.rnn_hidden
    )


def layer_slice(tree, l: int):
    """Layer ``l`` of a stacked param or cache tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, l) for k, v in tree.items()}
    return None if tree is None else tree[l]


def scan_layers(fn, params, cfg, x: torch.Tensor, cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """Run the per-layer ``fn`` over the stack (JAX's ``lax.scan`` over the
    layer dim), threading each layer's cache. Nothing is written in place:
    the new per-layer caches come back stacked, and the decode step copies
    them into its buffers (``training/steps.py``). The RNN caches are small
    ``(L, B, H)``; the large attention KV caches do not come here but are
    written in place by ``models/lm.py::_run_layers``."""
    new = []
    for l in range(cfg.n_layers):
        x, cache_l = fn(layer_slice(params, l), cfg, x, layer_slice(cache, l))
        new.append(cache_l)
    return x, {k: torch.stack([c[k] for c in new]) for k in new[0]}


def _stack_fused(params, cfg, x: torch.Tensor, cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """All L layers through the depth-fused stack. x: (B, T, d) batch-major.
    Under a sharding mesh, per rank on its lane shards, in the barrier
    schedule or, with ``cfg.ring_overlap``, the ring."""
    xt = x.transpose(0, 1).contiguous()  # time-major for the kernel
    mesh = fused_sharded.sharding_mesh(cfg)
    sharded = mesh is not None
    kw = {"block_t": cfg.mts_block_size}
    if sharded:
        kw.update(mesh=mesh, schedule="ring" if cfg.ring_overlap else "barrier")
    if cfg.cell == "sru":
        fn = fused_sharded.sharded_fused_sru_stack if sharded else stacked.fused_sru_stack
        y, c_last = fn(params["cell"], params["ln1"], xt, cache["c"], **kw)
        new_cache = {"c": c_last}
    else:
        tails = cache["x_tail"][:, :, 0, :].contiguous()  # (L, B, 1, d) -> (L, B, d)
        fn = fused_sharded.sharded_fused_qrnn_stack if sharded else stacked.fused_qrnn_stack
        y, c_last, tails_last = fn(params["cell"], params["ln1"], xt, tails, cache["c"], **kw)
        new_cache = {"c": c_last, "x_tail": tails_last[:, :, None, :]}
    return y.transpose(0, 1), new_cache


def rnn_stack_apply(params, cfg, x: torch.Tensor) -> torch.Tensor:
    """Train: the whole stack from a zero state. x: (B, T, d)."""
    if _depth_fusible(cfg):
        one = rnn_init_cache(cfg, x.shape[0], x.dtype, x.device)
        # Under a sharding mesh the carries are this rank's lanes.
        k = fused_sharded.model_shards(fused_sharded.sharding_mesh(cfg))
        cache = {name: v.new_zeros((cfg.n_layers, *v.shape[:-1],
                                    v.shape[-1] // k if name == "c" else v.shape[-1]))
                 for name, v in one.items()}
        y, _ = _stack_fused(params, cfg, x, cache)
        return y
    for l in range(cfg.n_layers):
        x = rnn_block_apply(layer_slice(params, l), cfg, x)
    return x


def rnn_stack_prefill(params, cfg, x: torch.Tensor, cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """Whole-stack prefill with exact carry of the stacked (L, B, H) cache."""
    if _depth_fusible(cfg):
        return _stack_fused(params, cfg, x, cache)
    return scan_layers(rnn_block_prefill, params, cfg, x, cache)


def rnn_stack_decode(params, cfg, x: torch.Tensor, cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """One token through all L layers: L kernel launches under ``fused_stack``."""
    return rnn_stack_prefill(params, cfg, x, cache)


# ---------------------------------------------------------------------------
# Per-slot (lane) cache ops, for continuous batching (``serving/``).
#
# A stream's whole serving state is one lane of the stacked cache: every leaf
# is (L, B, ...) with the batch at axis 1. These ops work on any tree of
# dicts honouring that layout, the ``{"layers": ...}`` wrapper of
# ``models/lm.py::lm_init_caches`` included, and return new trees, as the JAX
# package's do; the serving steps (``training/steps.py``) copy their results
# into the pool's own buffers. Masks select with ``torch.where``, never an
# arithmetic blend, so a lane outside the mask keeps its exact bits. A lane
# is a device tensor (an int is turned into one): a CUDA graph captures a
# tensor's address, where an int would be baked into the graph.
# ---------------------------------------------------------------------------

def _lane_index(lane, device) -> torch.Tensor:
    """``lane`` as a (K,) int64 index on ``device``: an int, a 0-dim tensor
    or a (K,) tensor."""
    return torch.as_tensor(lane, dtype=torch.int64, device=device).reshape(-1)


def _lane_bcast(lane_mask: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """Broadcast a (B,) lane mask against a (L, B, ...) cache leaf."""
    return lane_mask.reshape((1, -1) + (1,) * (leaf.dim() - 2))


def rnn_cache_reset_lanes(cache, lane_mask: torch.Tensor):
    """Zero the state of masked lanes; unmasked lanes keep their bits.
    ``lane_mask``: (B,) bool. Fixed shape (a ``where``, not a gather), so one
    captured reset serves any admission pattern."""
    return tree_map(
        lambda leaf: torch.where(_lane_bcast(lane_mask, leaf), torch.zeros_like(leaf), leaf),
        cache)


def rnn_cache_merge_lanes(old, new, lane_mask: torch.Tensor):
    """Masked lanes from ``new``, the rest bitwise from ``old``: what lets one
    fixed-shape step serve many independent streams (the step computes all B
    lanes, the merge commits only the lanes that belong to it)."""
    return tree_map(lambda o, n: torch.where(_lane_bcast(lane_mask, o), n, o), old, new)


def rnn_cache_extract_lane(cache, lane):
    """Lane ``lane``'s per-stream state: each (L, B, ...) leaf -> (L, ...)."""
    return tree_map(
        lambda leaf: leaf.index_select(1, _lane_index(lane, leaf.device)).squeeze(1), cache)


def rnn_cache_inject_lane(cache, lane, state):
    """Write a per-stream state (as ``rnn_cache_extract_lane`` returns it)
    into lane ``lane``. Extract -> inject round-trips bitwise."""
    return tree_map(
        lambda leaf, s: leaf.index_copy(1, _lane_index(lane, leaf.device),
                                        s.to(leaf.dtype).unsqueeze(1)),
        cache, state)


def rnn_cache_extract_lanes(cache, lanes):
    """Batched ``rnn_cache_extract_lane``: ``lanes`` (K,) -> each (L, B, ...)
    leaf gathered to (L, K, ...)."""
    return tree_map(lambda leaf: leaf.index_select(1, _lane_index(lanes, leaf.device)), cache)


def rnn_cache_inject_lanes(cache, lanes, states):
    """Batched ``rnn_cache_inject_lane``: scatter ``states`` (leaves
    (L, K, ...)) into ``lanes`` (K,). Duplicate lanes are a caller error."""
    return tree_map(
        lambda leaf, s: leaf.index_copy(1, _lane_index(lanes, leaf.device), s.to(leaf.dtype)),
        cache, states)
