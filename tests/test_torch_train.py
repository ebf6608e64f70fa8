"""The port's training path (``repro_torch``: ``lm_loss``, the fused
kernels' autograd Functions, ``training/steps.py``, the data pipeline and
``launch/train.py``) against the JAX package's, on the ``.reduced()``
configs with the JAX package's own params bridged across.

Tolerances are the JAX package's own: 3e-5 for a loss (a stack's logits,
``tests/test_rnn_stack.py``), 5e-4 for gradients and for params after
three steps (``tests/test_mts.py``), 2e-4 for microbatches 1 against 4
(``tests/test_train_loop.py``). The data pipeline and a restart inside the
port are bit for bit. JAX's fused kernels run in interpret mode; the port's
wrappers run their plain versions on the CPU, through the same autograd
Functions as on the card. The card's half of these checks is in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``'s ``train`` phase.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.data import pipeline as jpipeline
from repro.kernels.fused_rnn import layout as jlayout
from repro.kernels.fused_rnn import ops as jops
from repro.kernels.fused_rnn import stacked as jstacked
from repro.models import lm as jlm
from repro.training import steps as jsteps
from repro_torch import bridge
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import get_config
from repro_torch.data import pipeline
from repro_torch.kernels.fused_rnn import layout, ops, stacked
from repro_torch.launch import train
from repro_torch.models import lm
from repro_torch.runtime import PreemptionHandler
from repro_torch.training import steps
from repro_torch.tree import flatten_with_paths, tree_leaves

LOSS_TOL = 3e-5
GRAD_TOL = 5e-4
MICROBATCH_TOL = 2e-4
B, S = 2, 16

# name: (arch, config overrides). The SRU/QRNN engines on a two-layer
# per-layer LM (B1 under "fused"), the depth-fused stacks (B2), LSTM, the
# attention and Mamba LMs, the chunked loss and both remat policies.
LOSS_CASES = {
    **{f"{cell}_{engine}": (f"{cell}-paper-small", dict(n_layers=2, scan_engine=engine))
       for cell in ("sru", "qrnn") for engine in ("sequential", "chunked", "pallas", "fused")},
    "sru_fused_stack": ("sru-paper-large-stacked", {}),
    "qrnn_fused_stack": ("qrnn-paper-large-stacked", {}),
    "lstm": ("lstm-paper-small", dict(n_layers=2)),
    "llama3": ("llama3-8b", {}),
    "smollm": ("smollm-360m", {}),
    "mamba2": ("mamba2-2.7b", {}),
    "loss_chunk": ("llama3-8b", dict(loss_chunk=4)),
    "remat_none": ("sru-paper-large-stacked", dict(remat="none")),
    "remat_dots": ("llama3-8b", dict(remat="dots")),
    "remat_dots_fused_stack": ("qrnn-paper-large-stacked", dict(remat="dots")),
    "cast_per_layer": ("sru-paper-large-stacked", dict(cast_params_once=False)),
}


def _cfgs(arch, overrides=None):
    overrides = overrides or {}
    return (jax_get_config(arch).reduced().with_(**overrides),
            get_config(arch).reduced().with_(**overrides))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_lm_loss_and_grads_match_jax(case):
    """The loss at 3e-5 and the gradient of every param leaf at 5e-4, from
    the JAX package's params on one batch of its pipeline."""
    arch, overrides = LOSS_CASES[case]
    jcfg, cfg = _cfgs(arch, overrides)
    jparams = jlm.lm_init(jax.random.PRNGKey(1), jcfg)
    batch = jpipeline.make_pipeline(jcfg, B, S, seed=3).batch_at(0)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jlm.lm_loss(p, jcfg, jax.tree_util.tree_map(jnp.asarray, batch)),
        has_aux=True)(jparams)

    params = bridge.params_from_numpy(_np_tree(jparams), device="cpu")
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    loss, metrics = lm.lm_loss(params, cfg, _torch_batch(batch))
    grads = torch.autograd.grad(loss, leaves)
    _close(loss, jloss, LOSS_TOL)
    assert metrics["tokens"].item() == B * S
    want = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(want) == len(grads)
    for (path, w), (mine, g) in zip(want, zip(flatten_with_paths(params), grads)):
        assert mine[0] == "/".join(str(getattr(p, "key", p)) for p in path)
        _close(g, w, GRAD_TOL)


# ---------------------------------------------------------------------------
# The fused kernels' autograd Functions (B1 layer, B2 stack; fp and int8)
# ---------------------------------------------------------------------------

T, D, L = 6, 8, 2


def _function_inputs(rng, kind, cell, quant):
    """The operands of one call, as numpy: cell params (stacked for the
    stack), pre-norm gains, input, carries, QRNN tails."""
    lead = (L,) if kind == "stack" else ()

    def slab():
        return (rng.uniform(-1.0, 1.0, lead + (D, 3, D)) / np.sqrt(D)).astype(np.float32)

    nb = 2 if cell == "sru" else 3
    params = {"b": rng.normal(0.0, 0.5, lead + (nb, D)).astype(np.float32)}
    if cell == "sru":
        params.update(w=slab(), w_skip=None)
    else:
        params.update(w0=slab(), w1=slab())
    if quant:
        params = _np_tree(jlayout.quantize_cell(jax.tree_util.tree_map(jnp.asarray, params)))
    return {
        "params": params,
        "ln": (1.0 + 0.2 * rng.uniform(-1.0, 1.0, (L, D))).astype(np.float32),
        "x": rng.normal(size=(T, B, D)).astype(np.float32),
        "c0": rng.normal(0.0, 0.5, lead + (B, D)).astype(np.float32),
        "tail": rng.normal(size=((L, B, D) if kind == "stack" else (1, B, D))).astype(np.float32),
    }


def _call(mod, kind, cell, params, a):
    """The JAX or port wrapper on one set of operands; outputs as a tuple."""
    if kind == "layer":
        if cell == "sru":
            return mod["layer"].fused_sru(params, a["x"], a["c0"], block_t=4)
        return mod["layer"].fused_qrnn(params, a["x"], a["tail"], a["c0"], block_t=4)
    if cell == "sru":
        return mod["stack"].fused_sru_stack(params, a["ln"], a["x"], a["c0"], block_t=4)
    return mod["stack"].fused_qrnn_stack(params, a["ln"], a["x"], a["tail"], a["c0"], block_t=4)


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("kind", ["layer", "stack"])
@pytest.mark.parametrize("cell", ["sru", "qrnn"])
def test_fused_function_grads_match_jax(cell, kind, quant):
    """The gradient of every fp operand (input, carries, tails, gains,
    biases, slabs or, int8, the scales) through ``_FusedCore`` /
    ``_StackCore`` against ``jax.vjp`` of the JAX wrappers, whose
    ``custom_vjp`` rules differentiate ``fused_rnn_ref(_q)`` /
    ``fused_rnn_stack_ref(_q)``. Int8 slabs get none (straight-through)."""
    rng = np.random.default_rng(["sru", "qrnn"].index(cell) * 4 + 2 * (kind == "stack") + quant)
    a = _function_inputs(rng, kind, cell, quant)
    fp_keys = [k for k, v in a["params"].items()
               if v is not None and np.issubdtype(v.dtype, np.floating)]
    args = ["x", "c0"] + (["ln"] if kind == "stack" else []) + (["tail"] if cell == "qrnn" else [])

    def run_jax(*fp):
        p = {k: (jnp.asarray(v) if v is not None else None) for k, v in a["params"].items()}
        p.update(zip(fp_keys, fp[:len(fp_keys)]))
        ops_in = dict(a, **dict(zip(args, fp[len(fp_keys):])))
        return _call({"layer": jops, "stack": jstacked}, kind, cell, p, ops_in)

    primals = [jnp.asarray(a["params"][k]) for k in fp_keys] + [jnp.asarray(a[k]) for k in args]
    outs, vjp = jax.vjp(run_jax, *primals)
    cots = [rng.normal(size=o.shape).astype(np.float32) for o in outs]
    want = vjp(tuple(jnp.asarray(c) for c in cots))

    params = bridge.params_from_numpy(a["params"], device="cpu")
    tensors = {k: torch.tensor(v, requires_grad=True) for k, v in a.items() if k in args}
    for k in fp_keys:
        params[k].requires_grad_()
    got_outs = _call({"layer": ops, "stack": stacked}, kind, cell, params,
                     dict(a, **tensors))
    assert layout.is_quantized(params) == quant
    for o, w in zip(got_outs, outs):
        _close(o, w, LOSS_TOL)
    wrt = [params[k] for k in fp_keys] + [tensors[k] for k in args]
    got = torch.autograd.grad(got_outs, wrt, [torch.tensor(c) for c in cots])
    for name, g, w in zip(fp_keys + args, got, want):
        _close(g, w, GRAD_TOL)


# ---------------------------------------------------------------------------
# Train steps
# ---------------------------------------------------------------------------

def _run_port(cfg, state, n_steps, start=0, batch=4, seq=S, **kw):
    pipe = pipeline.make_pipeline(cfg, batch, seq, seed=0)
    step_fn = steps.build_train_step(cfg, base_lr=1e-3, warmup=2, total_steps=6, **kw)
    losses = []
    for s in range(start, n_steps):
        state, metrics = step_fn(state, _torch_batch(pipe.batch_at(s)))
        losses.append(metrics["loss"].item())
    return state, losses


TRAIN_CASES = {
    "sru_stack": ("sru-paper-large-stacked", {}, None),        # B2
    "qrnn_fused": ("qrnn-paper-large-fused", {}, None),        # B1
    "sru_pallas": ("sru-paper-large", dict(scan_engine="pallas"), None),  # B3
    # bf16 compression: under int8 a gradient 1e-7 off a rounding boundary
    # moves its residual by a whole quantization step (the int8 round trip
    # itself is held to JAX's bit for bit in tests/test_torch_optim.py).
    "llama3_bf16_compression": ("llama3-8b", {}, "bf16"),
    "mamba2_microbatched": ("mamba2-2.7b", dict(microbatches=2), None),
}


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_train_steps_match_jax(case):
    """Three steps of the port's train step against JAX's jitted
    ``build_train_step`` from one JAX ``init_train_state``: the loss per
    step at 3e-5, every param, moment and the step after at 5e-4."""
    arch, overrides, compression = TRAIN_CASES[case]
    jcfg, cfg = _cfgs(arch, overrides)
    jstate = jsteps.init_train_state(jax.random.PRNGKey(2), jcfg, compression)
    state = bridge.train_state_from_numpy(_np_tree(jstate), device="cpu")
    jstep = jax.jit(jsteps.build_train_step(jcfg, None, base_lr=1e-3, warmup=2, total_steps=6,
                                            compression=compression))
    pipe = jpipeline.make_pipeline(jcfg, 4, S, seed=0)
    jlosses = []
    for s in range(3):
        jstate, m = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, pipe.batch_at(s)))
        jlosses.append(float(m["loss"]))
    state, losses = _run_port(cfg, state, 3, compression=compression)
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_TOL, atol=LOSS_TOL)
    got = bridge.train_state_to_numpy(state)
    assert int(got.opt.step) == int(jstate.opt.step) == 3
    paths = [p for p, _ in flatten_with_paths(state)]
    want = jax.tree_util.tree_leaves(_np_tree(jstate))
    for path, g, w in zip(paths, jax.tree_util.tree_leaves(got), want, strict=True):
        np.testing.assert_allclose(g, w, rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=path)


@pytest.mark.parametrize("case", ["sru_stack", "mamba2_microbatched"])
def test_step_grads_is_the_train_steps_first_half(case):
    """``steps.step_grads`` and the global norm of its grads give the train
    step's ``loss`` and ``grad_norm`` bit for bit (one microbatch and two),
    and JAX's jitted step's at 3e-5 and 5e-4."""
    from repro_torch.optim.adamw import global_norm

    arch, overrides, _ = TRAIN_CASES[case]
    jcfg, cfg = _cfgs(arch, overrides)
    jstate = jsteps.init_train_state(jax.random.PRNGKey(2), jcfg)
    batch = jpipeline.make_pipeline(jcfg, 4, S, seed=0).batch_at(0)
    _, jm = jax.jit(jsteps.build_train_step(jcfg, None))(
        jstate, jax.tree_util.tree_map(jnp.asarray, batch))
    state = bridge.train_state_from_numpy(_np_tree(jstate), device="cpu")
    loss, grads = steps.step_grads(cfg, state.params, _torch_batch(batch))
    norm = global_norm(grads)
    assert [g.dtype for g in tree_leaves(grads)] == [torch.float32] * len(tree_leaves(grads))
    _, m = steps.build_train_step(cfg)(state, _torch_batch(batch))
    assert torch.equal(loss, m["loss"]) and torch.equal(norm, m["grad_norm"])
    _close(loss, jm["loss"], LOSS_TOL)
    _close(norm, jm["grad_norm"], GRAD_TOL)


def test_microbatches_do_not_change_the_math():
    """Microbatches 1 and 4 give the same params after three steps, within
    the JAX package's own test's tolerance."""
    _, cfg = _cfgs("llama3-8b")
    init = lambda: steps.init_train_state(torch.Generator().manual_seed(0), cfg, device="cpu")
    s1, _ = _run_port(cfg, init(), 3, batch=8)
    s4, _ = _run_port(cfg.with_(microbatches=4), init(), 3, batch=8)
    for a, b in zip(tree_leaves(s1.params), tree_leaves(s4.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=MICROBATCH_TOL, atol=MICROBATCH_TOL)


def test_restart_is_exact(tmp_path):
    """3 steps, a checkpoint, a restore into a fresh state, 3 more steps ==
    6 steps straight, bit for bit (CPU)."""
    _, cfg = _cfgs("sru-paper-large-stacked")
    init = lambda: steps.init_train_state(torch.Generator().manual_seed(0), cfg, device="cpu")
    full, losses_full = _run_port(cfg, init(), 6)
    half, losses_half = _run_port(cfg, init(), 3)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, half, pipeline.make_pipeline(cfg, 4, S, seed=0).state())
    restored, data_state = mgr.restore(3, init())
    assert data_state == {"kind": "synthetic", "seed": 0}
    resumed, losses_resumed = _run_port(cfg, restored, 6, start=3)
    assert losses_half + losses_resumed == losses_full
    for a, b in zip(tree_leaves(full), tree_leaves(resumed)):
        assert torch.equal(a, b)


def test_eval_step_matches_jax():
    jcfg, cfg = _cfgs("qrnn-paper-large-stacked")
    jparams = jlm.lm_init(jax.random.PRNGKey(4), jcfg)
    batch = jpipeline.make_pipeline(jcfg, B, S, seed=5).batch_at(2)
    want = jsteps.build_eval_step(jcfg)(jparams, jax.tree_util.tree_map(jnp.asarray, batch))
    params = bridge.params_from_numpy(_np_tree(jparams), device="cpu")
    got = steps.build_eval_step(cfg)(params, _torch_batch(batch))
    _close(got["loss"], want["loss"], LOSS_TOL)
    assert not got["loss"].requires_grad


def test_int8_configs_are_refused_by_both_frameworks():
    jcfg, cfg = _cfgs("sru-paper-large-stacked-int8")
    jstate = jsteps.init_train_state(jax.random.PRNGKey(0), jcfg)
    batch = jax.tree_util.tree_map(jnp.asarray,
                                   jpipeline.make_pipeline(jcfg, 2, 8, seed=0).batch_at(0))
    with pytest.raises(TypeError, match="int8"):
        jsteps.build_train_step(jcfg)(jstate, batch)
    with pytest.raises(TypeError, match="int8 weight-quantized configs do not train"):
        steps.build_train_step(cfg)


def test_unported_families_are_refused_for_training():
    """The MoE configs, once refused, now train (the name is kept from the
    refusal this test held): one step of each reduced config under the full
    config's schedule (``shard_map`` runs ``sorted`` on one device; qwen3
    keeps its bf16 moments) against JAX's jitted step from one JAX
    ``init_train_state``: the loss at 3e-5, every param and moment at 5e-4."""
    for arch, moe_impl in (("mixtral-8x22b", "sorted"), ("qwen3-moe-235b-a22b", "shard_map")):
        _one_moe_train_step_matches_jax(arch, moe_impl)


def _one_moe_train_step_matches_jax(arch, moe_impl):
    jcfg, cfg = _cfgs(arch, dict(moe_impl=moe_impl))
    assert isinstance(cfg, ArchConfig) and cfg.moe and cfg.moe_impl == moe_impl
    jstate = jsteps.init_train_state(jax.random.PRNGKey(4), jcfg)
    state = bridge.train_state_from_numpy(_np_tree(jstate), device="cpu")
    batch = jpipeline.make_pipeline(jcfg, 4, S, seed=0).batch_at(0)
    jstep = jax.jit(jsteps.build_train_step(jcfg, None, base_lr=1e-3, warmup=2, total_steps=6))
    jstate, jm = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, batch))
    state, losses = _run_port(cfg, state, 1)
    _close(torch.tensor(losses[0]), jm["loss"], LOSS_TOL)
    got = bridge.train_state_to_numpy(state)
    paths = [p for p, _ in flatten_with_paths(state)]
    assert "params/layers/moe/e_down" in paths
    assert (state.opt.m["layers"]["moe"]["e_up"].dtype
            == {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.moment_dtype])
    want = jax.tree_util.tree_leaves(_np_tree(jstate))
    for path, g, w in zip(paths, jax.tree_util.tree_leaves(got), want, strict=True):
        np.testing.assert_allclose(g, np.asarray(w, np.float32), rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=path)


# ---------------------------------------------------------------------------
# Data pipeline and launch/train.py
# ---------------------------------------------------------------------------

def test_pipelines_match_jax_bitwise(tmp_path):
    for kw in (dict(vocab=256, batch=3, seq_len=17, seed=4),
               dict(vocab=300, batch=2, seq_len=9, seed=1, frontend_dim=8)):
        mine, theirs = pipeline.SyntheticLM(**kw), jpipeline.SyntheticLM(**kw)
        assert mine.state() == theirs.state()
        for step in (0, 1, 7):
            got, want = mine.batch_at(step), theirs.batch_at(step)
            assert sorted(got) == sorted(want)
            for k in got:
                assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])
    path = tmp_path / "text.bin"
    path.write_bytes(bytes(range(256)) * 3)
    mine, theirs = (m.TextFileTokens(str(path), vocab=97, batch=2, seq_len=11, offset=5)
                    for m in (pipeline, jpipeline))
    for step in (0, 3):
        for k, v in mine.batch_at(step).items():
            assert np.array_equal(v, theirs.batch_at(step)[k])
    assert mine.state() == theirs.state()
    jcfg, cfg = _cfgs("smollm-360m")
    assert np.array_equal(pipeline.make_pipeline(cfg, 2, 8, seed=3).batch_at(1)["inputs"],
                          jpipeline.make_pipeline(jcfg, 2, 8, seed=3).batch_at(1)["inputs"])


def _main(tmp_path, *extra):
    return train.main(["--arch", "sru-paper-large-stacked", "--reduced", "--device", "cpu",
                       "--batch", "4", "--seq", "16", "--checkpoint-dir", str(tmp_path),
                       "--save-every", "100", "--log-every", "1", *extra])


def test_main_preemption_saves_and_resumes(tmp_path, capsys, monkeypatch):
    """A preemption requested during step 2 saves step 3 and exits 0; a
    resume runs on to the end, and its loss curve is the uninterrupted
    run's."""
    handler = PreemptionHandler(install=False)
    fake = lambda: handler
    monkeypatch.setattr(train, "PreemptionHandler", fake)
    real_step = steps.build_train_step

    def build(cfg, **kw):
        step_fn = real_step(cfg, **kw)

        def counted(state, batch):
            out = step_fn(state, batch)
            if int(state.opt.step) == 3:
                handler.trigger()
            return out

        return counted

    monkeypatch.setattr(train, "build_train_step", build)
    assert _main(tmp_path / "a", "--steps", "6", "--metrics-out", str(tmp_path / "a.json")) == 0
    assert "[preempt] checkpoint saved" in capsys.readouterr().out
    assert CheckpointManager(str(tmp_path / "a")).latest_step() == 3
    monkeypatch.setattr(train, "build_train_step", real_step)
    handler._requested = False
    assert _main(tmp_path / "a", "--steps", "6", "--resume", "auto",
                 "--metrics-out", str(tmp_path / "resumed.json")) == 0
    out = capsys.readouterr().out
    assert "[resume] step 3" in out and "done:" in out
    assert CheckpointManager(str(tmp_path / "a")).latest_step() == 6
    assert _main(tmp_path / "b", "--steps", "6", "--metrics-out",
                 str(tmp_path / "full.json")) == 0
    import json
    full = json.loads((tmp_path / "full.json").read_text())
    resumed = json.loads((tmp_path / "resumed.json").read_text())
    assert [h["step"] for h in resumed] == [3, 4, 5]
    assert resumed == full[3:]


def test_main_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "sru-paper-large-stacked", "--reduced", "--steps", "1"])
