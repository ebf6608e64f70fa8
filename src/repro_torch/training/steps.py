"""Serving steps, from ``repro/training/steps.py``: the batch
path's ``build_prefill_step`` and ``build_decode_step``, and the fixed-shape
lane-masked steps of continuous batching (``serving/engine.py``).

Each builder closes over the config and returns a plain function that runs
under ``torch.inference_mode()``. The verify step of speculative decode and
the training steps come with later slices.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models import lm, rnn


def build_prefill_step(cfg, *, batch: int, max_len: int, device="cuda"):
    """``prefill_step(params, inputs) -> (logits, caches)``: fresh zero caches
    on ``device``, then one MTS prefill over the prompt."""

    def prefill_step(params, inputs: Dict):
        with torch.inference_mode():
            caches = lm.lm_init_caches(cfg, batch, max_len, device=device)
            return lm.lm_prefill(params, cfg, inputs, caches)

    return prefill_step


def _copy_into(dst, src):
    for k, v in src.items():
        if isinstance(v, dict):
            _copy_into(dst[k], v)
        else:
            dst[k].copy_(v)


def build_decode_step(cfg):
    """``decode_step(params, caches, token) -> (logits, caches)``. The caches
    are updated in place and returned: the port's form of the JAX package's
    ``donate_argnums``, which keeps every cache buffer where it is. Attention
    layers write their new K/V row in place (``models/attention.py``) and
    Mamba layers their conv tails and SSM state (``models/mamba.py``), so
    nothing is copied for them; the small RNN caches come back new and are
    copied into the old buffers."""

    def decode_step(params, caches, token):
        with torch.inference_mode():
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


def build_cache_init(cfg, *, batch: int, max_len: int = 1, device="cuda"):
    """Thunk returning fresh zero decode caches on ``device``: the slot
    pool's backing store."""

    def cache_init():
        return lm.lm_init_caches(cfg, batch, max_len, device=device)

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
