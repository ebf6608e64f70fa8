"""The port's optimizer (``repro_torch.optim``: AdamW, the cosine schedule,
gradient compression with error feedback) against the JAX package's
(``repro.optim``), on the same numpy trees.

Tolerance: 2e-6 relative and 1e-9 absolute (a few fp32 ulps: both sides run
the same fp32 operations in the same order; ``pow`` and ``cos`` may round an
ulp apart). The int8 compression's quantized values are compared exactly
(the same ``round`` half to even on the same fp32 quotients).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.optim import compression as jcompression
from repro_torch.optim import adamw, compression
from repro_torch.tree import tree_map

RTOL, ATOL = 2e-6, 1e-9


def _tree(rng, scale=1.0):
    return {
        "embed": {"embed": (scale * rng.normal(size=(16, 8))).astype(np.float32)},
        "layers": {"cell": {"w": (scale * rng.normal(size=(2, 8, 3, 8))).astype(np.float32),
                            "b": (scale * rng.normal(size=(2, 2, 8))).astype(np.float32),
                            "w_skip": None},
                   "ln1": (1.0 + 0.1 * scale * rng.normal(size=(2, 8))).astype(np.float32)},
        "final_norm": np.ones((8,), np.float32),
    }


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch(tree):
    return tree_map(lambda a: torch.tensor(np.asarray(a)), tree)


def _close(got, want, rtol=RTOL, atol=ATOL):
    got_l = jax.tree_util.tree_leaves(tree_map(lambda t: t.numpy(), got))
    want_l = jax.tree_util.tree_leaves(want)
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        np.testing.assert_allclose(g, np.asarray(w), rtol=rtol, atol=atol)


@pytest.mark.parametrize("clip", [1.0, 1e-3], ids=["unclipped", "clipped"])
def test_adamw_update_matches_jax(clip):
    """Five steps from zero moments, with the grads clipped or not; the
    decay skips the 1-D leaves. The port updates in place and returns the
    same tensors."""
    rng = np.random.default_rng(0)
    params = _tree(rng)
    jp, tp = _jax(params), _torch(params)
    jstate, tstate = jadamw.adamw_init(jp), adamw.adamw_init(tp)
    sched_j = jadamw.cosine_schedule(1e-2, 2, 5)
    sched_t = adamw.cosine_schedule(1e-2, 2, 5)
    for _ in range(5):
        grads = _tree(rng, scale=0.3)
        lr_j, lr_t = sched_j(jstate.step), sched_t(tstate.step)
        jp, jstate, jm = jadamw.adamw_update(_jax(grads), jstate, jp, lr_j, clip_norm=clip)
        leaf = tp["layers"]["cell"]["w"]
        tp, tstate, tm = adamw.adamw_update(_torch(grads), tstate, tp, lr_t, clip_norm=clip)
        assert tp["layers"]["cell"]["w"] is leaf  # in place
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), rtol=RTOL)
        np.testing.assert_allclose(tm["lr"].item(), float(jm["lr"]), rtol=RTOL)
    assert int(tstate.step) == int(jstate.step) == 5
    _close(tp, jp)
    _close(tstate.m, jstate.m)
    _close(tstate.v, jstate.v)


def test_adamw_bf16_moments_match_jax():
    """``moment_dtype="bfloat16"``: fp32 math, moments stored in bf16."""
    rng = np.random.default_rng(1)
    params = _tree(rng)
    jp, tp = _jax(params), _torch(params)
    jstate, tstate = jadamw.adamw_init(jp, "bfloat16"), adamw.adamw_init(tp, "bfloat16")
    assert tstate.m["final_norm"].dtype == torch.bfloat16
    for _ in range(3):
        grads = _tree(rng, scale=0.3)
        jp, jstate, _ = jadamw.adamw_update(_jax(grads), jstate, jp, jnp.float32(1e-3))
        tp, tstate, _ = adamw.adamw_update(_torch(grads), tstate, tp, torch.tensor(1e-3))
    _close(tp, jp)
    _close(tree_map(lambda t: t.float(), tstate.m),
           jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jstate.m), rtol=2 ** -7)


def test_cosine_schedule_matches_jax():
    """Warmup, the cosine decay, its floor and past the end."""
    for base, warmup, total in [(3e-4, 20, 100), (1e-2, 0, 7), (1.0, 5, 5)]:
        sj, st = jadamw.cosine_schedule(base, warmup, total), adamw.cosine_schedule(base, warmup,
                                                                                   total)
        for step in [0, 1, warmup - 1, warmup, (warmup + total) // 2, total - 1, total, total + 9]:
            step = max(step, 0)
            want = float(sj(jnp.asarray(step, jnp.int32)))
            got = st(torch.tensor(step, dtype=torch.int32)).item()
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_global_norm_matches_jax():
    tree = _tree(np.random.default_rng(2))
    np.testing.assert_allclose(adamw.global_norm(_torch(tree)).item(),
                               float(jadamw.global_norm(_jax(tree))), rtol=RTOL)


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_compress_grads_matches_jax(mode):
    """Three rounds with the error feedback carried: compressed grads and
    residuals equal JAX's (int8: the dequantized values bit for bit)."""
    rng = np.random.default_rng(3)
    params = _tree(rng)
    je, te = jcompression.ef_init(_jax(params)), compression.ef_init(_torch(params))
    for _ in range(3):
        grads = _tree(rng, scale=0.3)
        jg, je = jcompression.compress_grads(_jax(grads), je, mode)
        tg, te = compression.compress_grads(_torch(grads), te, mode)
        _close(tg, jg, rtol=0.0, atol=0.0)
        _close(te, je)


def test_compress_grads_none_passes_through():
    tree = _torch(_tree(np.random.default_rng(4)))
    for mode in (None, "none"):
        g, e = compression.compress_grads(tree, None, mode)
        assert g is tree and e is None
    with pytest.raises(ValueError, match="unknown compression mode"):
        compression.compress_grads(tree, compression.ef_init(tree), "fp8")
