"""The port's mixture of experts (``repro_torch/models/moe.py``) against the
JAX package's ``models/moe.py``, on the CPU, from the same params (JAX's
``moe_init``, bridged) and the same inputs (a numpy seed).

Every schedule (``dense``, ``einsum``, ``sorted``, and ``shard_map``, which
runs ``sorted`` on one device in both frameworks) with every expert MLP
(swiglu, squared_relu, gelu) against its own JAX schedule at 2e-5, at the
configs' capacity factor and at 0.25, where tokens drop: JAX's own tests
compare the schedules only at a capacity where none drops, so these pin
the drop order (slot-major for ``einsum``, the stable sort by expert for
``sorted``). Then the router's weights and expert ids, the gradients of the
params and the input through ``sorted`` at 5e-4, and a bf16 call.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JaxArchConfig
from repro.models import moe as jmoe
from repro_torch import bridge
from repro_torch.configs.base import ArchConfig
from repro_torch.models import moe
from repro_torch.tree import flatten_with_paths, tree_leaves

TOL = 2e-5
GRAD_TOL = 5e-4
B, S = 2, 16
IMPLS = ("dense", "einsum", "sorted", "shard_map")
MLPS = ("swiglu", "squared_relu", "gelu")


def _cfgs(**kw):
    base = dict(name="moe-test", family="moe", n_layers=1, d_model=32, vocab=64, d_ff=48,
                mlp_type="swiglu", moe=True, n_experts=8, top_k=2, moe_impl="sorted",
                capacity_factor=1.25, renorm_topk=True)
    base.update(kw)
    return JaxArchConfig(**base), ArchConfig(**base)


def _setup(seed=0, **kw):
    jcfg, cfg = _cfgs(**kw)
    jparams = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    params = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                      device="cpu")
    x = np.random.default_rng(seed + 1).standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    return jcfg, cfg, jparams, params, x


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol, err_msg=what)


def test_config_field_and_init_layout_match_jax():
    jcfg, cfg, jparams, _, _ = _setup(d_model=128)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    mine = moe.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32, "cpu")
    assert sorted(mine) == sorted(jparams) == ["e_down", "e_gate", "e_up", "router"]
    for k, v in jparams.items():
        assert tuple(mine[k].shape) == v.shape and mine[k].dtype == torch.float32, k
        fan_in = v.shape[-2]  # normal * fan_in**-0.5, as JAX: >= 1024 draws, std within 10%
        assert abs(float(mine[k].std()) * fan_in ** 0.5 - 1.0) < 0.1, k
    _, gelu = _cfgs(mlp_type="gelu")
    assert "e_gate" not in moe.moe_init(torch.Generator().manual_seed(0), gelu,
                                        torch.bfloat16, "cpu")


@pytest.mark.parametrize("capacity_factor", [1.25, 0.25], ids=["cf1.25", "cf0.25"])
@pytest.mark.parametrize("mlp", MLPS)
@pytest.mark.parametrize("impl", IMPLS)
def test_moe_apply_matches_jax(impl, mlp, capacity_factor):
    """Each schedule against JAX's same schedule at 2e-5; at ``cf0.25`` the
    capacity-bound schedules drop tokens (their output differs from the
    dense one's), and still equal JAX's."""
    jcfg, cfg, jparams, params, x = _setup(mlp_type=mlp, moe_impl=impl,
                                           capacity_factor=capacity_factor)
    want = jmoe.moe_apply(jparams, jcfg, jnp.asarray(x))
    got = moe.moe_apply(params, cfg, torch.from_numpy(x))
    assert got.shape == (B, S, cfg.d_model) and got.dtype == torch.float32
    _close(got, want, TOL, f"{impl} {mlp}")
    if capacity_factor < 1 and impl not in ("dense",):
        dense = moe.moe_apply(params, cfg.with_(moe_impl="dense"), torch.from_numpy(x))
        assert (got - dense).abs().max() > 1e-2, "no token dropped"


def test_route_matches_jax():
    """Weights (renormalised top-k) at 2e-5, ids equal and in descending
    order of probability, the probabilities at 2e-5; and without renorm."""
    for renorm in (True, False):
        jcfg, cfg, jparams, params, x = _setup(renorm_topk=renorm, n_experts=16, top_k=4)
        jw, jids, jprobs = jmoe._route(jparams, jcfg, jnp.asarray(x))
        w, ids, probs = moe._route(params, cfg, torch.from_numpy(x))
        assert np.array_equal(ids.numpy(), np.asarray(jids))
        _close(w, jw, TOL)
        _close(probs, jprobs, TOL)
        assert bool((probs.gather(-1, ids).diff(dim=-1) <= 0).all())


def test_capacity_matches_jax():
    for S_, k, cf, E in ((1, 2, 1.25, 8), (64, 2, 1.25, 8), (256, 8, 1.25, 128), (16, 2, 0.25, 8),
                         (1000, 3, 1.0, 7)):
        jcfg, cfg = _cfgs(top_k=k, capacity_factor=cf, n_experts=E)
        assert moe._capacity(cfg, S_) == jmoe._capacity(jcfg, S_)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.25], ids=["cf1.25", "cf0.25"])
def test_sorted_grads_match_jax(capacity_factor):
    """d/d(params, x) of sum(moe_apply(x)**2) through ``sorted`` at 5e-4."""
    jcfg, cfg, jparams, params, x = _setup(capacity_factor=capacity_factor)
    loss = lambda p, xx: jnp.sum(jmoe.moe_apply(p, jcfg, xx) ** 2)
    jgp, jgx = jax.grad(loss, argnums=(0, 1))(jparams, jnp.asarray(x))
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    xt = torch.from_numpy(x).requires_grad_()
    out = torch.sum(moe.moe_apply(params, cfg, xt) ** 2)
    *gp, gx = torch.autograd.grad(out, leaves + [xt])
    want = jax.tree_util.tree_flatten_with_path(jgp)[0]
    for (path, w), (name, _), g in zip(want, flatten_with_paths(params), gp, strict=True):
        assert name == "/".join(k.key for k in path)
        _close(g, w, GRAD_TOL, name)
    _close(gx, jgx, GRAD_TOL, "x")


@pytest.mark.parametrize("impl", ["einsum", "sorted"])
def test_bf16_call_matches_jax(impl):
    """bf16 params and input: the router product in bf16 then cast to fp32,
    the experts' products in bf16, the combine in fp32; within a few bf16
    ulps of JAX's (the products' summation orders differ)."""
    jcfg, cfg, jparams, params, x = _setup(moe_impl=impl)
    jp16 = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jparams)
    want = jmoe.moe_apply(jp16, jcfg, jnp.asarray(x, jnp.bfloat16))
    got = moe.moe_apply({k: v.to(torch.bfloat16) for k, v in params.items()}, cfg,
                        torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    scale = float(np.abs(np.asarray(want, np.float32)).max())
    _close(got, want, 4 * 2.0 ** -8 * scale)
