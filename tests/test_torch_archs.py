"""The seven archs the port added last against the JAX package, on their
``.reduced()`` configs with the JAX package's own params bridged across:
``granite-20b`` (MQA, the tanh ``gelu`` MLP), the frontend stubs
``internvl2-2b`` and ``musicgen-large`` (``inputs_embeds`` through the
``frontend.adapter`` matrix), the hybrid ``zamba2-7b`` (Mamba-2 blocks
with one shared attention block after every ``attn_every`` of them), the
hybrid also with a tail of blocks that no shared block follows
(``n_layers=5, attn_every=2``), the MoE LMs ``mixtral-8x22b`` (a
sliding-window ring) and ``qwen3-moe-235b-a22b`` (QK-norm, bf16 moments),
each under the reduced config's ``dense`` schedule and its own (``sorted``;
``shard_map``, which runs ``sorted`` on one device), and the dense
``nemotron-4-340b`` (squared-ReLU, bf16 moments).

Per arch: the config copies (full and reduced), the ``lm_init`` layout and
the bridge round trip, a prefill then 8 greedy decode steps run as JAX's
``run_batch`` runs them (a frontend arch is fed the embedding row of the
token it chose) with logits and caches at 3e-5 and the tokens identical in
fp32, ``lm_loss`` at 3e-5 and its gradients at 5e-4 (the tolerances of
``tests/test_torch_train.py``), and ``serve --reduced --device cpu``. Then
a train state of each new family (a frontend, the hybrid) crossing both
ways through the checkpoint managers bit for bit (with bf16 moments: into
the port bit for bit and out of it byte for byte, since JAX's restore cannot
read a bf16 leaf), ``launch.train`` on each, and the hybrid's refusals. The kernels run through their plain versions
here; the card's half is in ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""
from __future__ import annotations

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxManager
from repro.configs.registry import get_config as jax_get_config
from repro.data import pipeline as jpipeline
from repro.models import lm as jlm
from repro.training import steps as jsteps
from repro_torch import bridge
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import (granite_20b, internvl2_2b, mixtral_8x22b, musicgen_large,
                                 nemotron_4_340b, qwen3_moe_235b_a22b, zamba2_7b)
from repro_torch.configs.registry import get_config
from repro_torch.launch import serve, train
from repro_torch.models import lm
from repro_torch.training import steps
from repro_torch.tree import flatten_with_paths, tree_leaves

LOGIT_TOL = 3e-5
LOSS_TOL = 3e-5
GRAD_TOL = 5e-4
B, PROMPT, DECODE_STEPS, S = 3, 12, 8, 16

MODULES = {"granite-20b": granite_20b, "internvl2-2b": internvl2_2b,
           "musicgen-large": musicgen_large, "zamba2-7b": zamba2_7b,
           "mixtral-8x22b": mixtral_8x22b, "qwen3-moe-235b-a22b": qwen3_moe_235b_a22b,
           "nemotron-4-340b": nemotron_4_340b}
# name -> (arch, overrides on its reduced config)
CASES = {
    "granite": ("granite-20b", {}),
    "internvl2": ("internvl2-2b", {}),
    "musicgen": ("musicgen-large", {}),
    "zamba2": ("zamba2-7b", {}),
    "zamba2_tail": ("zamba2-7b", dict(n_layers=5, attn_every=2)),
    "mixtral": ("mixtral-8x22b", {}),
    "mixtral_sorted": ("mixtral-8x22b", dict(moe_impl="sorted")),
    "qwen3": ("qwen3-moe-235b-a22b", {}),
    "qwen3_shard_map": ("qwen3-moe-235b-a22b", dict(moe_impl="shard_map")),
    "nemotron": ("nemotron-4-340b", {}),
}
# The archs whose train states cross the checkpoint managers and run
# ``launch.train``: a frontend, the hybrid, the MoE LMs and nemotron.
TRAIN_ARCHS = ["internvl2-2b", "zamba2-7b", "mixtral-8x22b", "qwen3-moe-235b-a22b",
               "nemotron-4-340b"]


def _cfgs(arch, overrides=None):
    overrides = overrides or {}
    return (jax_get_config(arch).reduced().with_(**overrides),
            get_config(arch).reduced().with_(**overrides))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_params(case):
    """JAX's params of a case (seed 3), made once for the file's tests."""
    jcfg, _ = _cfgs(*CASES[case])
    return jax.jit(lambda key: jlm.lm_init(key, jcfg))(jax.random.PRNGKey(3))


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol, err_msg=what)


@pytest.mark.parametrize("arch", sorted(MODULES))
def test_config_is_a_faithful_copy(arch):
    mine, ref = MODULES[arch].CONFIG, jax_get_config(arch)
    for cfg, jcfg in ((mine, ref), (mine.reduced(), ref.reduced())):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.padded_vocab == jcfg.padded_vocab
        assert cfg.num_params() == jcfg.num_params()
    assert get_config(arch) is mine


@pytest.mark.parametrize("case", sorted(CASES))
def test_lm_init_layout_and_bridge_match_jax(case):
    """Keys, shapes and dtypes of every leaf (``frontend/adapter`` and
    ``shared_attn/*`` among them) and of the decode caches equal JAX's; JAX's
    params and caches cross into the port and back bit for bit."""
    jcfg, cfg = _cfgs(*CASES[case])
    rng = np.random.default_rng(1)
    shapes = jax.eval_shape(lambda: jlm.lm_init(jax.random.PRNGKey(0), jcfg))
    jparams = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(a.dtype), shapes)
    mine = lm.lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    want = jax.tree_util.tree_flatten_with_path(jparams)[0]
    got = flatten_with_paths(mine)
    assert [p for p, _ in got] == ["/".join(k.key for k in path) for path, _ in want]
    for (path, t), (_, w) in zip(got, want):
        assert tuple(t.shape) == w.shape and str(t.dtype).split(".")[-1] == w.dtype.name, path
    assert ("frontend" in mine) == bool(cfg.frontend)
    assert ("shared_attn" in mine) == bool(cfg.attn_every)
    back = bridge.params_to_numpy(bridge.params_from_numpy(jparams, device="cpu"))
    for (path, w), b in zip(want, jax.tree_util.tree_leaves(back)):
        assert b.dtype == w.dtype and np.array_equal(b, w), path

    jcaches = _np_tree(jlm.lm_init_caches(jcfg, 2, 8))
    caches = lm.lm_init_caches(cfg, 2, 8, device="cpu")
    assert sorted(caches) == sorted(jcaches)
    for group, leaves in jcaches.items():
        assert {k: tuple(v.shape) for k, v in caches[group].items()} == {
            k: v.shape for k, v in leaves.items()}
        noisy = {k: rng.standard_normal(v.shape).astype(v.dtype) for k, v in leaves.items()}
        back = bridge.caches_to_numpy(bridge.caches_from_numpy(noisy, device="cpu"))
        assert all(np.array_equal(back[k], v) for k, v in noisy.items())


def _run_batch_both(case):
    """Prefill and DECODE_STEPS greedy steps on both sides as JAX's
    ``run_batch`` feeds them, yielding each step's (logits, caches)."""
    jcfg, cfg = _cfgs(*CASES[case])
    jparams = _jax_params(case)
    params = bridge.params_from_numpy(_np_tree(jparams), device="cpu")
    rng = np.random.default_rng(4)
    if cfg.frontend:
        prompt = rng.standard_normal((B, PROMPT, cfg.d_model)).astype(np.float32)
        key = "inputs_embeds"
    else:
        prompt = rng.integers(0, cfg.vocab, (B, PROMPT)).astype(np.int32)
        key = "inputs"
    max_len = PROMPT + DECODE_STEPS
    jprefill = jax.jit(jsteps.build_prefill_step(jcfg, batch=B, max_len=max_len))
    jdecode = jax.jit(jsteps.build_decode_step(jcfg))
    prefill = steps.build_prefill_step(cfg, batch=B, max_len=max_len, device="cpu")
    decode = steps.build_decode_step(cfg)
    jlogits, jcaches = jprefill(jparams, {key: jnp.asarray(prompt)})
    logits, caches = prefill(params, {key: torch.from_numpy(prompt).to(
        torch.float32 if cfg.frontend else torch.long)})
    for step in range(DECODE_STEPS + 1):
        yield step, (logits, caches), (jlogits, jcaches)
        jtok = jnp.argmax(jlogits[:, -1, : jcfg.vocab], axis=-1)[:, None]
        tok = serve._greedy(cfg, logits)
        assert np.array_equal(tok.numpy(), np.asarray(jtok)), f"tokens differ at {step}"
        if step == DECODE_STEPS:
            return
        if jcfg.frontend:  # as JAX's run_batch: the argmax token's embedding row
            jin = jax.nn.one_hot(jtok, jcfg.padded_vocab) @ jparams["embed"]["embed"]
            mine = serve.step_input(cfg, params, tok)
            assert mine.shape == (B, 1, cfg.d_model)
            assert np.array_equal(mine.numpy(), np.asarray(jin))  # bit for bit
        else:
            jin, mine = jtok, serve.step_input(cfg, params, tok)
        jlogits, jcaches = jdecode(jparams, jcaches, jin)
        logits, caches = decode(params, caches, mine)


@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_and_greedy_decode_match_jax(case):
    for step, (logits, caches), (jlogits, jcaches) in _run_batch_both(case):
        assert logits.shape == jlogits.shape
        _close(logits, jlogits, LOGIT_TOL, f"logits at step {step}")
        assert sorted(caches) == sorted(jcaches)
        for group in jcaches:
            assert sorted(caches[group]) == sorted(jcaches[group])
            for k, v in jcaches[group].items():
                _close(caches[group][k], v, LOGIT_TOL, f"cache {group}/{k} at step {step}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_lm_loss_and_grads_match_jax(case):
    """The loss at 3e-5 and every leaf's gradient at 5e-4 (the adapter's and
    the shared block's among them), on one batch of JAX's pipeline
    (``inputs_embeds`` for a frontend), under the config's remat ("block":
    the shared block checkpointed, as in JAX)."""
    jcfg, cfg = _cfgs(*CASES[case])
    jparams = _jax_params(case)
    batch = jpipeline.make_pipeline(jcfg, 2, S, seed=3).batch_at(0)
    assert ("inputs_embeds" in batch) == bool(cfg.frontend)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.lm_loss(p, jcfg, b), has_aux=True))(
        jparams, jax.tree_util.tree_map(jnp.asarray, batch))
    params = bridge.params_from_numpy(_np_tree(jparams), device="cpu")
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    loss, _ = lm.lm_loss(params, cfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    # a frontend's untied input table takes no part (JAX's gradient: zeros)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
    _close(loss, jloss, LOSS_TOL)
    want = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(want) == len(grads)
    for (path, w), (name, _), g in zip(want, flatten_with_paths(params), grads):
        assert name == "/".join(k.key for k in path)
        _close(g, w, GRAD_TOL, name)


@pytest.mark.parametrize("arch", sorted(MODULES))
def test_serve_runs_on_cpu(arch, capsys):
    assert serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "8", "--gen-len", "4"]) == 0
    stats = json.loads(capsys.readouterr().out.split("serve-stats ", 1)[1])
    assert stats["arch"] == arch + "-smoke" and stats["cache_in_place"]
    assert len(stats["tokens"]) == 2 and len(stats["tokens"][0]) == 4
    assert all(0 <= t < get_config(arch).reduced().vocab for row in stats["tokens"] for t in row)


def _jax_train_state(arch, seed):
    jcfg = jax_get_config(arch).reduced()
    state = jax.jit(lambda key: jsteps.init_train_state(key, jcfg))(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)  # distinct moments and a step, so a swap would show
    noise = lambda a: jnp.asarray(rng.normal(size=a.shape).astype(np.float32)).astype(a.dtype)
    return state._replace(opt=state.opt._replace(
        step=jnp.asarray(5, jnp.int32), m=jax.tree_util.tree_map(noise, state.opt.m),
        v=jax.tree_util.tree_map(noise, state.opt.v)))


def _bits(a):
    """A leaf's bits: bf16 (torch, or numpy through ml_dtypes) as its 2-byte words."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


# The leaf that shows each arch's family in a train state's paths.
FAMILY_LEAF = {"internvl2-2b": "params/frontend/adapter", "zamba2-7b": "params/shared_attn/",
               "mixtral-8x22b": "params/layers/moe/e_gate",
               "qwen3-moe-235b-a22b": "params/layers/moe/router",
               "nemotron-4-340b": "params/layers/mlp/w_up"}


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_state_checkpoints_cross_both_ways(arch, tmp_path):
    """A JAX-saved train state restores in the port (into the port's own
    ``init_train_state``) bit for bit, and the port's save of it writes
    JAX's manifest and JAX's files byte for byte, and restores in JAX bit for
    bit where JAX can read it back (no bf16 leaf); the family's leaves
    (``frontend/adapter``, ``shared_attn/*``, ``moe/*``) among the paths."""
    jstate = _jax_train_state(arch, 0)
    data_state = {"kind": "synthetic", "seed": 7}
    JaxManager(str(tmp_path / "jax")).save(3, jstate, data_state)
    target = steps.init_train_state(torch.Generator().manual_seed(1),
                                    get_config(arch).reduced(), device="cpu")
    restored, got_data = CheckpointManager(str(tmp_path / "jax")).restore(3, target)
    assert got_data == data_state
    want = jax.tree_util.tree_leaves(jstate)
    port = flatten_with_paths(restored)
    assert len(port) == len(want)
    for (path, t), w in zip(port, want):
        assert str(t.dtype).split(".")[-1] == np.asarray(w).dtype.name, path
        assert np.array_equal(_bits(t), _bits(w)), path
    paths = [p for p, _ in port]
    assert any(p.startswith(FAMILY_LEAF[arch]) for p in paths)
    bf16 = get_config(arch).moment_dtype == "bfloat16"
    assert any(t.dtype == torch.bfloat16 for _, t in port) == bf16

    CheckpointManager(str(tmp_path / "port")).save(3, restored, data_state)
    manifest = lambda d: json.loads((tmp_path / d / "step_3" / "MANIFEST.json").read_text())
    assert manifest("port") == manifest("jax")
    for e in manifest("port")["leaves"]:
        assert ((tmp_path / "port" / "step_3" / e["file"]).read_bytes()
                == (tmp_path / "jax" / "step_3" / e["file"]).read_bytes()), e["path"]
    if not bf16:  # JAX's restore cannot read a bf16 leaf (ROADMAP.md §C)
        back, _ = JaxManager(str(tmp_path / "port")).restore(3, jax.eval_shape(lambda: jstate))
        for a, b in zip(jax.tree_util.tree_leaves(back), want):
            assert a.dtype == b.dtype and np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_launch_train_runs(arch, tmp_path, capsys):
    out = tmp_path / "m.json"
    assert train.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
                       "--seq", "8", "--steps", "2", "--log-every", "1",
                       "--metrics-out", str(out)]) == 0
    history = json.loads(out.read_text())
    assert [h["step"] for h in history] == [0, 1]
    assert all(np.isfinite(h["loss"]) for h in history)


def test_hybrid_refusals():
    """``fuse_depth`` with ``attn_every`` raises JAX's ValueError; continuous
    batching refuses the hybrid and the frontends, as JAX's engine does."""
    cfg = get_config("sru-paper-large-stacked").reduced().with_(
        attn_every=2, n_heads=2, n_kv_heads=1, d_head=16, d_ff=32)
    params = lm.lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = {"inputs": torch.zeros((1, 4), dtype=torch.long),
             "targets": torch.zeros((1, 4), dtype=torch.long)}
    with pytest.raises(ValueError, match="fuse_depth does not support attn_every hybrids"):
        lm.lm_loss(params, cfg, batch)
    with pytest.raises(ValueError, match="fuse_depth does not support attn_every hybrids"):
        lm.lm_prefill(params, cfg, batch, lm.lm_init_caches(cfg, 1, 4, device="cpu"))
    for arch in ("zamba2-7b", "internvl2-2b", "musicgen-large"):
        with pytest.raises(ValueError, match="continuous batching"):
            serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--mode", "continuous",
                        "--requests", "2"])
