"""The port's Mamba-2 path (``repro_torch.models.mamba``, the Mamba blocks of
``models/lm.py``, ``configs/mamba2_2p7b.py``, ``launch/serve.py``) against the
JAX package's, on the same numpy inputs and the JAX package's own params
bridged across.

fp32 throughout unless said: the causal conv (both impls, with a tail), the
training forward, one block's prefill then 6 decode steps (outputs at 2e-5,
the JAX package's layer tolerance; caches at 3e-5), and the LM's prefill
then 8 greedy decode steps on ``mamba2-2.7b.reduced()`` and a G = 2 variant
(logits and caches at 3e-5, ``tests/test_rnn_stack.py``'s tolerance for
logits; greedy tokens identical). The SSD runs through ``kernels/ssd``'s
plain version here; the kernel is held to it on the card.

Also: the bf16-compute cast of the fp32 ``A_log``/``D``/``dt_bias`` leaves
(bitwise JAX's), the port's own property that decode writes every cache
leaf in place, and the serve CLI.
"""
from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import mamba2_2p7b as jax_mamba2
from repro.configs.registry import get_config as jax_get_config
from repro.models import lm as jlm
from repro.models import mamba as jmamba
from repro.training.steps import build_decode_step as jax_decode_builder
from repro.training.steps import build_prefill_step as jax_prefill_builder
from repro_torch import bridge
from repro_torch.configs import mamba2_2p7b
from repro_torch.configs.registry import get_config
from repro_torch.kernels.fused_rnn import layout
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.launch import serve
from repro_torch.models import lm, mamba
from repro_torch.training import steps

BLOCK_TOL = 2e-5
CACHE_TOL = 3e-5
LOGIT_TOL = 3e-5
B = 3
CACHE_KEYS = ["conv_b", "conv_c", "conv_x", "ssm"]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got: torch.Tensor, want, tol, what=""):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol, err_msg=what)


def _cfgs(overrides=None):
    overrides = overrides or {}
    return (jax_get_config("mamba2-2.7b").reduced().with_(**overrides),
            get_config("mamba2-2.7b").reduced().with_(**overrides))


def test_mamba2_config_is_a_faithful_copy():
    mine, ref = mamba2_2p7b.CONFIG, jax_mamba2.CONFIG
    for cfg, jcfg in ((mine, ref), (mine.reduced(), ref.reduced())):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.padded_vocab == jcfg.padded_vocab
        assert cfg.num_params() == jcfg.num_params()
        assert (cfg.d_inner, cfg.ssm_heads) == (jcfg.d_inner, jcfg.ssm_heads)
    assert get_config("mamba2-2.7b") is mine
    assert (mine.d_inner, mine.ssm_heads, mine.ssm_state, mine.conv_impl) == (5120, 80, 128,
                                                                            "conv")


def test_mamba_init_matches_jax_layout():
    jcfg, cfg = _cfgs()
    want = _np_tree(jmamba.mamba_init(jax.random.PRNGKey(0), jcfg, jnp.bfloat16))
    mine = mamba.mamba_init(torch.Generator().manual_seed(0), cfg, torch.bfloat16, "cpu")
    assert sorted(mine) == sorted(want)
    for k, v in mine.items():
        assert tuple(v.shape) == want[k].shape, k
        assert str(v.dtype).split(".")[-1] == want[k].dtype.name, k
    for k in ("A_log", "D", "dt_bias"):  # deterministic leaves
        np.testing.assert_allclose(mine[k].numpy(), want[k], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("impl", ["shift", "conv"])
@pytest.mark.parametrize("with_tail", [False, True], ids=["zero_tail", "tail"])
@pytest.mark.parametrize("S", [1, 9])
def test_causal_conv_matches_jax(impl, with_tail, S):
    rng = np.random.default_rng(S + 2 * with_tail)
    x = rng.standard_normal((2, S, 12)).astype(np.float32)
    w = (rng.standard_normal((4, 12)) * 0.5).astype(np.float32)
    tail = rng.standard_normal((2, 3, 12)).astype(np.float32) if with_tail else None
    y, new_tail = mamba._causal_conv(torch.tensor(x), torch.tensor(w),
                                     None if tail is None else torch.tensor(tail), impl=impl)
    jy, jtail = jmamba._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                    None if tail is None else jnp.asarray(tail), impl=impl)
    _close(y, jy, BLOCK_TOL)
    _close(new_tail, jtail, 0.0)


def _block_params(jcfg, seed):
    jparams = jmamba.mamba_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    rng = np.random.default_rng(seed)  # non-trivial D and norm gains, so both are seen
    jparams["D"] = jnp.asarray(1.0 + 0.5 * rng.standard_normal(jcfg.ssm_heads), jnp.float32)
    jparams["gnorm"] = jnp.asarray(1.0 + 0.3 * rng.standard_normal(jcfg.d_inner), jnp.float32)
    return jparams, bridge.params_from_numpy(_np_tree(jparams), device="cpu")


@pytest.mark.parametrize("engine", ["chunked", "associative"])
def test_mamba_apply_matches_jax(engine):
    jcfg, cfg = _cfgs()
    jparams, params = _block_params(jcfg, 1)
    x = np.random.default_rng(2).standard_normal((B, 20, cfg.d_model)).astype(np.float32)
    got = mamba.mamba_apply(params, cfg, torch.tensor(x), engine=engine)
    _close(got, jmamba.mamba_apply(jparams, jcfg, jnp.asarray(x), engine=engine), BLOCK_TOL)


# name -> (config overrides on mamba2-2.7b.reduced(), prompt length)
BLOCK_VARIANTS = {
    "reduced": ({}, 20),
    "groups_2": (dict(ssm_ngroups=2), 20),
    "shift_conv": (dict(conv_impl="shift"), 20),
    "prompt_2": ({}, 2),  # shorter than the conv tail
}
DECODE_STEPS = 6


@pytest.mark.parametrize("variant", sorted(BLOCK_VARIANTS))
def test_mamba_prefill_then_decode_matches_jax(variant):
    overrides, prompt = BLOCK_VARIANTS[variant]
    jcfg, cfg = _cfgs(overrides)
    jparams, params = _block_params(jcfg, 3)
    x = np.random.default_rng(4).standard_normal(
        (B, prompt + DECODE_STEPS, cfg.d_model)).astype(np.float32)
    jcache = jmamba.mamba_init_cache(jcfg, B, jnp.float32)
    cache = mamba.mamba_init_cache(cfg, B, torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        k: v.shape for k, v in jcache.items()}
    jout, jcache = jmamba.mamba_prefill(jparams, jcfg, jnp.asarray(x[:, :prompt]), jcache)
    out, cache2 = mamba.mamba_prefill(params, cfg, torch.tensor(x[:, :prompt]), cache)
    assert cache2 is cache
    _close(out, jout, BLOCK_TOL, "prefill")
    for k in CACHE_KEYS:
        _close(cache[k], jcache[k], CACHE_TOL, f"prefill {k}")
    for t in range(prompt, prompt + DECODE_STEPS):
        xt = x[:, t:t + 1]
        jout, jcache = jmamba.mamba_decode(jparams, jcfg, jnp.asarray(xt), jcache)
        out, cache2 = mamba.mamba_decode(params, cfg, torch.tensor(xt), cache)
        assert cache2 is cache
        _close(out, jout, BLOCK_TOL, f"decode at {t}")
        for k in CACHE_KEYS:
            _close(cache[k], jcache[k], CACHE_TOL, f"decode at {t} {k}")


def test_prefill_ignores_the_incoming_cache():
    """As JAX's ``mamba_prefill``: zero state and zero conv tails, whatever
    the cache holds."""
    _, cfg = _cfgs()
    _, params = _block_params(_cfgs()[0], 5)
    x = torch.randn((2, 7, cfg.d_model), generator=torch.Generator().manual_seed(6))
    fresh = mamba.mamba_init_cache(cfg, 2, torch.float32, "cpu")
    dirty = {k: torch.randn(v.shape) for k, v in fresh.items()}
    out_fresh, _ = mamba.mamba_prefill(params, cfg, x, fresh)
    out_dirty, _ = mamba.mamba_prefill(params, cfg, x, dirty)
    assert torch.equal(out_fresh, out_dirty)
    for k in CACHE_KEYS:
        assert torch.equal(fresh[k], dirty[k]), k


def _lm_prefill_and_decode(jcfg, cfg, steps_n=8, prompt_len=20, same_tokens=True):
    """Prefill and ``steps_n`` greedy decode steps on both sides, yielding
    each step's (logits, caches). ``same_tokens``: the greedy tokens must
    be identical (fp32); else both sides are fed JAX's (bf16, where argmax
    ties break differently)."""
    jparams = jlm.lm_init(jax.random.PRNGKey(3), jcfg)
    params = bridge.params_from_numpy(_np_tree(jparams), device="cpu")
    prompt = np.random.default_rng(4).integers(0, cfg.vocab, (B, prompt_len)).astype(np.int32)
    jprefill = jax.jit(jax_prefill_builder(jcfg, batch=B, max_len=prompt_len + steps_n))
    jdecode = jax.jit(jax_decode_builder(jcfg))
    prefill = steps.build_prefill_step(cfg, batch=B, max_len=prompt_len + steps_n, device="cpu")
    decode = steps.build_decode_step(cfg)
    jlogits, jcaches = jprefill(jparams, {"inputs": jnp.asarray(prompt)})
    logits, caches = prefill(params, {"inputs": torch.tensor(prompt, dtype=torch.long)})
    for step in range(steps_n + 1):
        yield step, (logits, caches), (jlogits, jcaches)
        jtok = jnp.argmax(jlogits[:, -1, : jcfg.vocab], axis=-1)[:, None]
        tok = torch.argmax(logits[:, -1, : cfg.vocab], dim=-1)[:, None]
        if same_tokens:
            assert np.array_equal(tok.numpy(), np.asarray(jtok)), f"tokens differ at {step}"
        else:
            tok = torch.tensor(np.asarray(jtok), dtype=torch.long)
        if step < steps_n:
            jlogits, jcaches = jdecode(jparams, jcaches, jtok)
            logits, caches = decode(params, caches, tok)


@pytest.mark.parametrize("overrides", [{}, dict(ssm_ngroups=2)], ids=["reduced", "groups_2"])
def test_mamba_lm_matches_jax(overrides):
    jcfg, cfg = _cfgs(overrides)
    for step, (logits, caches), (jlogits, jcaches) in _lm_prefill_and_decode(jcfg, cfg):
        assert logits.shape == jlogits.shape
        _close(logits, jlogits, LOGIT_TOL, f"logits at step {step}")
        assert sorted(caches["layers"]) == sorted(jcaches["layers"]) == CACHE_KEYS
        for k, v in jcaches["layers"].items():
            _close(caches["layers"][k], v, LOGIT_TOL, f"cache {k} at step {step}")


def test_bf16_compute_casts_the_ssm_leaves_as_jax():
    """Under bf16 compute JAX's ``_cast_params`` casts every floating leaf,
    so ``A_log``, ``D`` and ``dt_bias`` reach the block in bf16; the port's
    ``layout.cast_params`` gives the same bits. The bf16 LM then follows
    JAX's within bf16 rounding: each side rounds every product and norm to
    bf16 (2^-8 relative) at other places, through two layers and the head,
    so the logits agree within 2^-5 of their scale."""
    jcfg, cfg = _cfgs(dict(compute_dtype="bfloat16"))
    jlayers = _np_tree(jlm.lm_init(jax.random.PRNGKey(9), jcfg)["layers"])
    want = _np_tree(jlm._cast_params(jlayers, jnp.bfloat16))
    got = bridge.params_to_numpy(layout.cast_params(
        bridge.params_from_numpy(jlayers, device="cpu"), torch.bfloat16))
    for k in ("A_log", "D", "dt_bias"):
        assert jlayers["mamba"][k].dtype == np.float32
        assert np.array_equal(got["mamba"][k], want["mamba"][k].astype(np.float32)), k
    for step, (logits, _), (jlogits, _) in _lm_prefill_and_decode(jcfg, cfg, steps_n=4,
                                                                  same_tokens=False):
        assert logits.dtype == torch.bfloat16
        scale = float(np.abs(np.asarray(jlogits, np.float32)).max())
        err = float(np.abs(logits.float().numpy() - np.asarray(jlogits, np.float32)).max())
        assert err <= 2.0 ** -5 * scale, (step, err, scale)


def test_decode_writes_every_cache_leaf_in_place(monkeypatch):
    """Each decode step writes the conv tails and the SSM state of every
    layer into the stacked cache: the leaves keep their storage, the step
    returns the same cache tree, and nothing is copied back."""
    _, cfg = _cfgs()
    params = lm.lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    prefill = steps.build_prefill_step(cfg, batch=2, max_len=12, device="cpu")
    decode = steps.build_decode_step(cfg)
    logits, caches = prefill(params, {"inputs": torch.randint(0, cfg.vocab, (2, 5))})
    ptrs = {k: v.data_ptr() for k, v in caches["layers"].items()}
    copies = []
    monkeypatch.setattr(steps, "_copy_into", lambda dst, src: copies.append(1))
    for _ in range(3):
        before = {k: v.clone() for k, v in caches["layers"].items()}
        tok = torch.argmax(logits[:, -1, : cfg.vocab], dim=-1)[:, None]
        logits, new = decode(params, caches, tok)
        assert new is caches
        for k, v in caches["layers"].items():
            assert not torch.equal(v, before[k]), f"{k} not written"
    assert not copies
    assert {k: v.data_ptr() for k, v in caches["layers"].items()} == ptrs


def test_prefill_writes_the_state_into_the_given_cache(monkeypatch):
    """Prefill's SSD writes its final state into the cache's ``ssm`` slice
    (``state_out``), not into a new tensor copied afterwards."""
    _, cfg = _cfgs()
    params = lm.lm_init(torch.Generator().manual_seed(1), cfg, device="cpu")
    caches = lm.lm_init_caches(cfg, 2, 8, device="cpu")
    outs = []
    real = ssd_ops.ssd

    def recording(*args, **kw):
        outs.append(kw.get("state_out"))
        return real(*args, **kw)

    monkeypatch.setattr(mamba, "ssd", recording)
    lm.lm_prefill(params, cfg, {"inputs": torch.randint(0, cfg.vocab, (2, 6))}, caches)
    ssm = caches["layers"]["ssm"]
    assert [o.data_ptr() for o in outs] == [ssm[l].data_ptr() for l in range(cfg.n_layers)]
    assert all(bool(ssm[l].abs().sum() > 0) for l in range(cfg.n_layers))


def test_bridge_round_trip_mamba_is_bitwise():
    jcfg, cfg = _cfgs()
    params = _np_tree(jlm.lm_init(jax.random.PRNGKey(5), jcfg))
    assert sorted(params["layers"]) == ["ln1", "mamba"]
    back = bridge.params_to_numpy(bridge.params_from_numpy(params, device="cpu"))
    for k, v in params["layers"]["mamba"].items():
        assert back["layers"]["mamba"][k].dtype == v.dtype and np.array_equal(
            back["layers"]["mamba"][k], v), k
    caches = _np_tree(jlm.lm_init_caches(jcfg, 2, 8))
    rng = np.random.default_rng(0)
    caches = {"layers": {k: rng.standard_normal(v.shape).astype(v.dtype)
                         for k, v in caches["layers"].items()}}
    back = bridge.caches_to_numpy(bridge.caches_from_numpy(caches, device="cpu"))
    for k, v in caches["layers"].items():
        assert np.array_equal(back["layers"][k], v), k
    mine = lm.lm_init_caches(cfg, 2, 8, device="cpu")
    assert {k: tuple(v.shape) for k, v in mine["layers"].items()} == {
        k: v.shape for k, v in caches["layers"].items()}
    assert mine["layers"]["ssm"].dtype == torch.float32


def test_serve_mamba2_runs_on_cpu(capsys):
    rc = serve.main(["--arch", "mamba2-2.7b", "--reduced", "--device", "cpu",
                     "--batch", "2", "--prompt-len", "8", "--gen-len", "4"])
    assert rc == 0
    stats = json.loads(capsys.readouterr().out.split("serve-stats ", 1)[1])
    assert stats["arch"] == "mamba2-2.7b-smoke" and len(stats["tokens"][0]) == 4
