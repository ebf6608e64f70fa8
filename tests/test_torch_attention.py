"""The port's attention path (``repro_torch.models.{layers,attention}``)
against the JAX package's ``models/{layers,attention}.py``, on the same numpy
inputs and the JAX package's own params bridged across: ``rope``, the three
MLP kinds, ``chunked_attention`` with and without a window, and
``attn_prefill`` then 6 ``attn_decode`` steps (outputs and the k / v / pos
cache) on ``llama3-8b.reduced()`` and its padded-head, group-of-3, SWA-ring
and ``qk_norm`` variants and the head shapes of granite-20b (a group of
48), zamba2-7b (head dim 112) and nemotron-4-340b (a group of 12 at head
dim 192). fp32 throughout, tolerance 2e-5 (the JAX
package's layer tolerance). Decode runs through ``gqa_decode``'s plain
version here; the kernel is held to it on the card.

Also the port's own property: a decode step writes the KV cache in place
(the cache tensors' ``data_ptr()`` do not move, nothing is copied back).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.models import attention, layers, lm
from repro_torch.training import steps

TOL = 2e-5
B = 3


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got: torch.Tensor, want, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=TOL, atol=TOL,
                               err_msg=what)


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_rope_matches_jax(theta):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    positions = rng.integers(0, 4096, (2, 5)).astype(np.int32)
    got = layers.rope(torch.tensor(x), torch.tensor(positions), theta)
    _close(got, jlayers.rope(jnp.asarray(x), jnp.asarray(positions), theta))


@pytest.mark.parametrize("kind", ["swiglu", "squared_relu", "gelu"])
def test_mlp_matches_jax(kind):
    jparams = jlayers.mlp_init(jax.random.PRNGKey(1), 32, 48, kind, jnp.float32)
    params = bridge.params_from_numpy(_np_tree(jparams), device="cpu")
    x = np.random.default_rng(1).standard_normal((2, 7, 32)).astype(np.float32)
    got = layers.mlp_apply(params, torch.tensor(x), kind)
    _close(got, jlayers.mlp_apply(jparams, jnp.asarray(x), kind))
    mine = layers.mlp_init(torch.Generator().manual_seed(0), 32, 48, kind, torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in mine.items()} == {
        k: v.shape for k, v in _np_tree(jparams).items()}


@pytest.mark.parametrize("window", [None, 5])
def test_chunked_attention_matches_jax(window):
    """Several q blocks by several KV blocks (chunks of 8 over 24 rows)."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 24, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 24, 2, 16)).astype(np.float32) for _ in range(2))
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24)).copy()
    kw = dict(window=window, chunk_q=8, chunk_k=8)
    got = attention.chunked_attention(*(torch.tensor(a) for a in (q, k, v, pos, pos)), **kw)
    _close(got, jattn.chunked_attention(*(jnp.asarray(a) for a in (q, k, v, pos, pos)), **kw))


# name -> (config overrides on llama3-8b.reduced(), prompt length, max_len)
VARIANTS = {
    "llama3_reduced": ({}, 9, 16),
    "padded_heads": (dict(n_heads=3, n_kv_heads=1, pad_heads_to=4), 9, 16),
    "group_of_3": (dict(n_heads=6, n_kv_heads=2), 9, 16),
    "swa_ring": (dict(sliding_window=8), 10, 16),  # prompt and decode past the window
    "qk_norm": (dict(qk_norm=True), 9, 16),
    # the head shapes of granite-20b (a group of 48), zamba2-7b (head dim
    # 112) and nemotron-4-340b (a group of 12 at head dim 192)
    "granite_g48": (dict(n_heads=48, n_kv_heads=1), 9, 16),
    "zamba2_dh112": (dict(n_heads=2, n_kv_heads=2, d_head=112), 9, 16),
    "nemotron_g12_dh192": (dict(n_heads=12, n_kv_heads=1, d_head=192), 9, 16),
}
DECODE_STEPS = 6


def _cfgs(overrides):
    return (jax_get_config("llama3-8b").reduced().with_(**overrides),
            get_config("llama3-8b").reduced().with_(**overrides))


def _compare_cache(cache, jcache, what):
    for key in ("k", "v"):
        _close(cache[key], jcache[key], f"{what} {key}")
    assert int(cache["pos"]) == int(jcache["pos"]), what


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_attn_prefill_then_decode_matches_jax(variant):
    overrides, prompt, max_len = VARIANTS[variant]
    jcfg, cfg = _cfgs(overrides)
    jparams = jattn.attn_init(jax.random.PRNGKey(3), jcfg, jnp.float32)
    if cfg.qk_norm:  # non-trivial norm gains, so the norm is seen
        rng = np.random.default_rng(5)
        for key in ("q_norm", "k_norm"):
            jparams[key] = jnp.asarray(1.0 + 0.3 * rng.standard_normal(cfg.d_head), jnp.float32)
    params = bridge.params_from_numpy(_np_tree(jparams), device="cpu")
    x = np.random.default_rng(4).standard_normal(
        (B, prompt + DECODE_STEPS, cfg.d_model)).astype(np.float32)

    jcache = jattn.init_cache(jcfg, B, max_len, jnp.float32)
    cache = attention.init_cache(cfg, B, max_len, torch.float32, "cpu")
    assert tuple(cache["k"].shape) == jcache["k"].shape
    jout, jcache = jattn.attn_prefill(jparams, jcfg, jnp.asarray(x[:, :prompt]), jcache)
    out, cache = attention.attn_prefill(params, cfg, torch.tensor(x[:, :prompt]), cache)
    _close(out, jout, "prefill")
    _compare_cache(cache, jcache, "prefill")
    for t in range(prompt, prompt + DECODE_STEPS):
        xt = x[:, t:t + 1]
        jout, jcache = jattn.attn_decode(jparams, jcfg, jnp.asarray(xt), jcache)
        out, cache = attention.attn_decode(params, cfg, torch.tensor(xt), cache)
        _close(out, jout, f"decode at {t}")
        _compare_cache(cache, jcache, f"decode at {t}")


def test_decode_writes_the_kv_cache_in_place(monkeypatch):
    """The decode step writes one K/V row per layer into the stacked cache
    and advances ``pos``, all in place: the cache tensors keep their storage,
    the step returns the same cache tree, and nothing is copied back."""
    cfg = get_config("llama3-8b").reduced()
    params = lm.lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    prefill = steps.build_prefill_step(cfg, batch=2, max_len=12, device="cpu")
    decode = steps.build_decode_step(cfg)
    logits, caches = prefill(params, {"inputs": torch.randint(0, cfg.vocab, (2, 5))})
    ptrs = {k: v.data_ptr() for k, v in caches["layers"].items()}
    k_before = caches["layers"]["k"].clone()
    copies = []
    monkeypatch.setattr(steps, "_copy_into", lambda dst, src: copies.append(1))
    for i in range(3):
        tok = torch.argmax(logits[:, -1, : cfg.vocab], dim=-1)[:, None]
        logits, new = decode(params, caches, tok)
        assert new is caches
    assert not copies
    assert {k: v.data_ptr() for k, v in caches["layers"].items()} == ptrs
    assert caches["layers"]["pos"].tolist() == [8] * cfg.n_layers
    written = (caches["layers"]["k"] != k_before).any(dim=(1, 3, 4))  # (L, slots)
    assert written[:, 5:8].all() and not written[:, :5].any() and not written[:, 8:].any()
