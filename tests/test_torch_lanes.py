"""The lane ops (``repro_torch/models/rnn.py``) and the lane-masked steps
(``repro_torch/training/steps.py``) of continuous batching, against
the JAX package's on the same numpy caches, masks, lanes and (bridged)
params, on the CPU.

The six lane ops move or select bits and compute nothing, so they are held
to JAX bitwise; within the port an extract -> inject round trip is bitwise
and lanes outside a mask keep their bits. The steps (cache init, masked
decode, chunk prefill, reset, snapshot, inject) run the model: their logits
and caches are held to JAX's within 3e-5 (``tests/test_rnn_stack.py``'s
tolerance for a stack or logits), their greedy tokens exactly (fp32
compute), under the ``sequential``, ``pallas``, ``fused`` and
``fused_stack`` engines, SRU and QRNN, and one int8 config.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.models import lm as jlm
from repro.models import rnn as jrnn
from repro.training import steps as jsteps
from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.models import lm, rnn
from repro_torch.training import steps
from repro_torch.training.graphs import leaves

TOL = 3e-5
B = 4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(tree):
    return bridge.caches_from_numpy(tree, device="cpu")


def _random_caches(arch, seed):
    """A numpy cache tree of ``arch``'s reduced config (B lanes) filled with
    random values, so that a lane's bits are its own."""
    caches = _np(jlm.lm_init_caches(jax_get_config(arch).reduced(), B, 1))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(a.dtype), caches)


def _assert_bitwise(got, want):
    got, want = bridge.caches_to_numpy(got), _np(want)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)


MASKS = [np.array([False, True, False, True]), np.zeros(B, bool), np.ones(B, bool)]


@pytest.mark.parametrize("arch", ["sru-paper-small", "qrnn-paper-small", "lstm-paper-small"])
@pytest.mark.parametrize("mask_i", range(len(MASKS)))
def test_reset_and_merge_lanes_are_bitwise_jax(arch, mask_i):
    mask = MASKS[mask_i]
    old, new = _random_caches(arch, 0), _random_caches(arch, 1)
    m_t = torch.from_numpy(mask)
    _assert_bitwise(rnn.rnn_cache_reset_lanes(_t(old), m_t),
                    jrnn.rnn_cache_reset_lanes(old, jnp.asarray(mask)))
    _assert_bitwise(rnn.rnn_cache_merge_lanes(_t(old), _t(new), m_t),
                    jrnn.rnn_cache_merge_lanes(old, new, jnp.asarray(mask)))
    # the lanes outside the mask keep their bits, the others take new's
    merged = bridge.caches_to_numpy(rnn.rnn_cache_merge_lanes(_t(old), _t(new), m_t))
    for g, o, n in zip(*(jax.tree_util.tree_leaves(x) for x in (merged, old, new))):
        assert np.array_equal(g[:, ~mask], o[:, ~mask]) and np.array_equal(g[:, mask], n[:, mask])


@pytest.mark.parametrize("arch", ["sru-paper-small", "qrnn-paper-small", "lstm-paper-small"])
@pytest.mark.parametrize("lane", [0, 3])
def test_extract_and_inject_lane_are_bitwise_jax(arch, lane):
    """The scalar pair with the lane as an int and as a 0-dim tensor (the
    form a CUDA graph captures), and the extract -> inject round trip."""
    caches, other = _random_caches(arch, 2), _random_caches(arch, 3)
    want_state = jrnn.rnn_cache_extract_lane(caches, lane)
    for lane_arg in (lane, torch.tensor(lane)):
        state = rnn.rnn_cache_extract_lane(_t(caches), lane_arg)
        _assert_bitwise(state, want_state)
        _assert_bitwise(rnn.rnn_cache_inject_lane(_t(other), lane_arg, state),
                        jrnn.rnn_cache_inject_lane(other, lane, want_state))
        # extract -> inject into a reset lane restores the caches bitwise
        wiped = rnn.rnn_cache_reset_lanes(_t(caches), torch.arange(B) == lane)
        _assert_bitwise(rnn.rnn_cache_inject_lane(wiped, lane_arg, state), caches)


@pytest.mark.parametrize("arch", ["sru-paper-small", "qrnn-paper-small", "lstm-paper-small"])
def test_extract_and_inject_lanes_are_bitwise_jax(arch):
    caches, other = _random_caches(arch, 4), _random_caches(arch, 5)
    lanes = np.array([3, 0, 2])
    want = jrnn.rnn_cache_extract_lanes(caches, jnp.asarray(lanes))
    got = rnn.rnn_cache_extract_lanes(_t(caches), torch.from_numpy(lanes))
    _assert_bitwise(got, want)
    _assert_bitwise(rnn.rnn_cache_inject_lanes(_t(other), torch.from_numpy(lanes), got),
                    jrnn.rnn_cache_inject_lanes(jax.tree_util.tree_map(jnp.asarray, other),
                                                jnp.asarray(lanes), want))
    # every lane out and back in: the caches bitwise
    everything = torch.arange(B)
    _assert_bitwise(rnn.rnn_cache_inject_lanes(
        _t(other), everything, rnn.rnn_cache_extract_lanes(_t(caches), everything)), caches)


# ---------------------------------------------------------------------------
# The lane-masked steps against JAX's, on bridged params
# ---------------------------------------------------------------------------

# (arch, engine override): the four engines, SRU and QRNN, and one int8 config.
BUILDER_CASES = [
    ("sru-paper-small", "sequential"), ("qrnn-paper-small", "sequential"),
    ("sru-paper-small", "pallas"), ("qrnn-paper-small", "pallas"),
    ("sru-paper-large-fused", None), ("qrnn-paper-large-fused", None),
    ("sru-paper-large-stacked", None), ("qrnn-paper-large-stacked", None),
    ("qrnn-paper-large-stacked-int8", None),
]


def _cfgs(arch, engine):
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    if engine:
        jcfg, cfg = jcfg.with_(scan_engine=engine), cfg.with_(scan_engine=engine)
    return jcfg, cfg


def _close(got, want, what):
    got, want = bridge.caches_to_numpy(got), _np(want)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert g.shape == w.shape, what
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL, err_msg=what)


def _bits(caches):
    return [t.clone() for t in leaves(caches)]


@pytest.mark.parametrize("arch,engine", BUILDER_CASES)
def test_lane_masked_steps_match_jax(arch, engine):
    """A sequence of steps on one pool: two chunk prefills (lanes 0, 2, 3,
    then 0 and 3), two masked decode steps (lanes 1-3, then 0 and 2), a
    reset of lane 2, a snapshot of lane 3 injected into lane 1; after each,
    the port's pool against JAX's, tokens exactly, logits and caches within
    3e-5. Inside the port: every step writes the pool's own buffers, the
    lanes outside a mask keep their bits, and the inject of a snapshot into
    its own lane is bitwise."""
    jcfg, cfg = _cfgs(arch, engine)
    jparams = jlm.lm_init(jax.random.PRNGKey(7), jcfg)
    params = bridge.params_from_numpy(_np(jparams), device="cpu")
    chunk = jcfg.mts_block_size
    rng = np.random.default_rng(11)

    jcaches = jsteps.build_cache_init(jcfg, batch=B)()
    caches = steps.build_cache_init(cfg, batch=B, device="cpu")()
    _assert_bitwise(caches, jcaches)
    ptrs = [t.data_ptr() for t in leaves(caches)]

    jprefill = jsteps.build_chunk_prefill_step(jcfg, chunk=chunk)
    prefill = steps.build_chunk_prefill_step(cfg, chunk=chunk)
    jdecode, decode = jsteps.build_masked_decode_step(jcfg), steps.build_masked_decode_step(cfg)

    def check(what, got, want, mask):
        g_tok, g_logits, g_caches = got
        w_tok, w_logits, w_caches = want
        assert g_caches is caches, what
        assert np.array_equal(g_tok.numpy(), np.asarray(w_tok)), what
        _close(g_logits, w_logits, what)
        _close(g_caches, w_caches, what)
        for b, a in zip(before, leaves(caches)):
            assert torch.equal(a[:, ~torch.from_numpy(mask)], b[:, ~torch.from_numpy(mask)]), what

    for i, lanes in enumerate(([0, 2, 3], [0, 3])):
        mask = np.isin(np.arange(B), lanes)
        tokens = rng.integers(0, cfg.vocab, (B, chunk))
        want = jprefill(jparams, jcaches, jnp.asarray(tokens, jnp.int32), jnp.asarray(mask))
        jcaches = want[2]
        before = _bits(caches)
        check(f"prefill {i}", prefill(params, caches, torch.from_numpy(tokens),
                                      torch.from_numpy(mask)), want, mask)
    for i, lanes in enumerate(([1, 2, 3], [0, 2])):
        mask = np.isin(np.arange(B), lanes)
        token = rng.integers(0, cfg.vocab, (B, 1))
        want = jdecode(jparams, jcaches, jnp.asarray(token, jnp.int32), jnp.asarray(mask))
        jcaches = want[2]
        before = _bits(caches)
        check(f"decode {i}", decode(params, caches, torch.from_numpy(token),
                                    torch.from_numpy(mask)), want, mask)

    mask = np.arange(B) == 2
    jcaches = jsteps.build_lane_reset(jcfg)(jcaches, jnp.asarray(mask))
    assert steps.build_lane_reset(cfg)(caches, torch.from_numpy(mask)) is caches
    _close(caches, jcaches, "reset")
    assert all(not t[:, 2].any() for t in leaves(caches))

    jstate = jsteps.build_lane_snapshot(jcfg)(jcaches, np.int32(3))
    state = steps.build_lane_snapshot(cfg)(caches, torch.tensor(3))
    _close(state, jstate, "snapshot")
    inject = steps.build_lane_inject(cfg)
    jcaches = jsteps.build_lane_inject(jcfg)(jcaches, np.int32(1), jstate)
    before = _bits(caches)
    assert inject(caches, torch.tensor(1), state) is caches
    _close(caches, jcaches, "inject")
    for b, a in zip(before, leaves(caches)):
        assert torch.equal(a[:, [0, 2, 3]], b[:, [0, 2, 3]])
        assert torch.equal(a[:, 1], a[:, 3])
    before = _bits(caches)
    inject(caches, torch.tensor(3), steps.build_lane_snapshot(cfg)(caches, torch.tensor(3)))
    assert all(torch.equal(a, b) for a, b in zip(leaves(caches), before))
    assert [t.data_ptr() for t in leaves(caches)] == ptrs


@pytest.mark.parametrize("arch,engine", [("sru-paper-small", "pallas"),
                                         ("qrnn-paper-large-stacked", None)])
def test_masked_decode_of_placeholder_lanes_keeps_their_bits(arch, engine):
    """A masked-out lane runs the step on a placeholder token; its cache
    keeps its bits, and an all-False mask leaves the whole pool bitwise."""
    _, cfg = _cfgs(arch, engine)
    params = lm.lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    caches = bridge.caches_from_numpy(_random_caches(arch, 9), device="cpu")
    decode = steps.build_masked_decode_step(cfg)
    before = _bits(caches)
    decode(params, caches, torch.full((B, 1), 5), torch.zeros(B, dtype=torch.bool))
    assert all(torch.equal(a, b) for a, b in zip(leaves(caches), before))
    mask = torch.tensor([True, False, False, True])
    decode(params, caches, torch.full((B, 1), 5), mask)
    for a, b in zip(leaves(caches), before):
        assert torch.equal(a[:, 1:3], b[:, 1:3]) and not torch.equal(a[:, 0], b[:, 0])


def test_chunk_prefill_refuses_another_chunk_length():
    cfg = get_config("sru-paper-small").reduced()
    prefill = steps.build_chunk_prefill_step(cfg, chunk=16)
    params = lm.lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    caches = steps.build_cache_init(cfg, batch=2, device="cpu")()
    with pytest.raises(ValueError, match="chunk 16"):
        prefill(params, caches, torch.zeros((2, 8), dtype=torch.int64),
                torch.ones(2, dtype=torch.bool))
