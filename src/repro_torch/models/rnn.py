"""LM blocks of the paper's own models, from ``repro/models/rnn.py``:
stacked SRU / QRNN / LSTM layers. Block = pre-norm + cell + residual
(d_in == hidden == d_model).

``cfg.scan_engine`` selects the recurrence schedule of SRU/QRNN blocks
(``core/scan.py``); LSTM ignores it and runs ``core/mts.py::lstm_forward``,
as in the JAX package. Two granularities:

  * per-layer — ``rnn_block_init/prefill/decode`` + ``rnn_init_cache``: one
    block at a time; ``models/lm.py`` loops them over the layers
    (``engine="fused"``: one whole-layer kernel per block).
  * stack-level — ``rnn_stack_prefill/decode``: the whole stack in one call,
    with stacked params ``(L, ...)`` and a stacked cache ``(L, B, H)``. With
    ``cfg.scan_engine == "fused_stack"`` (SRU/QRNN, d_model == hidden) it
    runs the depth-fused stack (``kernels/fused_rnn/stacked.py``).

The sharded branches of the JAX package wait for the multi-GPU slice.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core import cells, mts
from repro_torch.kernels.fused_rnn import stacked
from repro_torch.models.layers import rmsnorm, rmsnorm_init

_INITS = {"sru": cells.sru_init, "qrnn": cells.qrnn_init, "lstm": cells.lstm_init}


def tree_map(fn, *trees):
    """``fn`` over the leaves of trees of dicts with the first tree's keys; a
    ``None`` leaf stays ``None``."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    return None if first is None else fn(*trees)


def rnn_block_init(gen, cfg, dtype, device) -> Dict:
    d, h = cfg.d_model, cfg.rnn_hidden
    return {
        "ln1": rmsnorm_init(d, dtype, device),
        "cell": _INITS[cfg.cell](gen, d, h, dtype, device),
    }


def rnn_init_cache(cfg, batch: int, dtype, device) -> Dict:
    h = cfg.rnn_hidden
    cache = {"c": torch.zeros((batch, h), dtype=dtype, device=device)}
    if cfg.cell == "qrnn":
        cache["x_tail"] = torch.zeros((batch, 1, cfg.d_model), dtype=dtype, device=device)
    if cfg.cell == "lstm":
        cache["h"] = torch.zeros((batch, h), dtype=dtype, device=device)
    return cache


def rnn_block_prefill(params, cfg, x: torch.Tensor, cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """x: (B, T, d). The per-layer path rounds to ``x``'s dtype at every
    layer: the norm, the cell's ``h`` and the residual add, as in JAX."""
    h = rmsnorm(params["ln1"], x)
    if cfg.cell == "sru":
        out, c_last = mts.mts_sru(
            params["cell"], h, cache["c"],
            engine=cfg.scan_engine, block_size=cfg.mts_block_size,
        )
        cache = {"c": c_last}
    elif cfg.cell == "qrnn":
        out, c_last = mts.mts_qrnn(
            params["cell"], h, cache["c"], cache["x_tail"],
            engine=cfg.scan_engine, block_size=cfg.mts_block_size,
        )
        cache = {"c": c_last, "x_tail": h[:, -1:]}
    else:
        out, c_last = mts.lstm_forward(params["cell"], h, cache["h"], cache["c"])
        cache = {"c": c_last, "h": out[:, -1]}
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
    """All L layers through the depth-fused stack. x: (B, T, d) batch-major."""
    xt = x.transpose(0, 1).contiguous()  # time-major for the kernel
    if cfg.cell == "sru":
        y, c_last = stacked.fused_sru_stack(
            params["cell"], params["ln1"], xt, cache["c"], block_t=cfg.mts_block_size
        )
        new_cache = {"c": c_last}
    else:
        tails = cache["x_tail"][:, :, 0, :]  # (L, B, 1, d) -> (L, B, d)
        y, c_last, tails_last = stacked.fused_qrnn_stack(
            params["cell"], params["ln1"], xt, tails, cache["c"], block_t=cfg.mts_block_size
        )
        new_cache = {"c": c_last, "x_tail": tails_last[:, :, None, :]}
    return y.transpose(0, 1), new_cache


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
