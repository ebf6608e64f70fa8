"""The port's examples (``repro_torch/examples/``) on the CPU against the
JAX package's, on the same inputs:

* ``quickstart``: five train steps from JAX's ``init_train_state`` carried
  over by the bridge, on the example's batches, then the greedy
  generation, both computing in fp32 (the config's bf16 compute rounds the
  chunked engine's products otherwise in the two frameworks: 1.7e-4 on the
  first loss): every loss within 3e-5 of JAX's jitted step, the tokens
  equal;
* ``streaming_asr`` at 64 frames of width 64, both engines: every (engine,
  n) output within 3e-5 of JAX's ``rnn_stack_prefill`` on the bridged
  params and stream, and the example's SRU-n / SRU-1 check;
* ``train_lm`` at ``--steps 4 --batch 2 --seq 32``: it saves and resumes,
  and resumed from the checkpoint JAX's ``launch.train`` wrote with the
  same flags it gives JAX's next losses within 3e-5, both computing in
  fp32 (in the config's bf16 the two differ by 8.5e-4). JAX's ``launch.train``
  runs on a mesh of Auto axes (``make_local_mesh`` patched here: under jax
  0.9 its own mesh has Explicit axes, which the reference's steps refuse).

None runs ``--full``. No example imports ``repro`` or ``jax``.
"""
from __future__ import annotations

import ast
import contextlib
import importlib.util
import io
import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.checkpoint import CheckpointManager
from repro_torch.examples import quickstart, streaming_asr, train_lm
from repro_torch.launch import train as port_train

REPO = Path(__file__).resolve().parents[1]
TOL = 3e-5
QUICK_STEPS = 5
ASR = {"frames": 64, "width": 64, "layers": 2, "blocks": [1, 8, 32],
       "engines": ["sequential", "fused"]}
TRAIN_ARGV = ["--steps", "4", "--batch", "2", "--seq", "32", "--device", "cpu"]
CPU = torch.device("cpu")
FP32 = {"compute_dtype": "float32"}


def _jax_example(name: str):
    """The JAX package's ``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                  REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["quickstart", "train_lm", "streaming_asr"])
def test_examples_import_no_jax(name):
    """Each example imports neither ``jax`` nor the JAX package, and has
    ``--device`` with default ``cuda``."""
    src = (REPO / "src" / "repro_torch" / "examples" / f"{name}.py").read_text()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""]
        else:
            continue
        assert not any(m.split(".")[0] in ("jax", "repro") for m in mods), mods
    assert '"--device", default="cuda"' in src


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------

def _jax_quickstart(cfg_port):
    """JAX's quickstart body at QUICK_STEPS steps: its initial state (numpy),
    every loss, the prompt's tail and the generated tokens."""
    from repro.configs.registry import get_config
    from repro.data import make_pipeline
    from repro.models import lm
    from repro.training.steps import build_train_step, init_train_state

    cfg = get_config("sru-paper-small").with_(
        n_layers=2, d_model=128, rnn_hidden=128, vocab=256, mts_block_size=16, **FP32)
    assert cfg.name == cfg_port.name and cfg.num_params() == cfg_port.num_params()
    state = init_train_state(jax.random.PRNGKey(0), cfg)
    init = jax.tree_util.tree_map(np.asarray, state)
    step_fn = jax.jit(build_train_step(cfg, None, base_lr=1e-3, total_steps=quickstart.STEPS))
    pipe = make_pipeline(cfg, batch=quickstart.BATCH, seq_len=quickstart.SEQ)
    losses = []
    for step in range(QUICK_STEPS):
        state, metrics = step_fn(state, jax.tree_util.tree_map(jnp.asarray, pipe.batch_at(step)))
        losses.append(float(metrics["loss"]))
    prompt = jnp.asarray(pipe.batch_at(999)["inputs"][:1, :quickstart.PROMPT])
    caches = lm.lm_init_caches(cfg, 1, max_len=48)
    logits, caches = lm.lm_prefill(state.params, cfg, {"inputs": prompt}, caches)
    tok = jnp.argmax(logits[:, -1, :cfg.vocab], -1)[:, None]
    toks = [int(tok[0, 0])]
    for _ in range(quickstart.GEN):
        logits, caches = lm.lm_decode_step(state.params, cfg, caches, tok)
        tok = jnp.argmax(logits[:, -1, :cfg.vocab], -1)[:, None]
        toks.append(int(tok[0, 0]))
    return init, losses, list(map(int, prompt[0][-8:])), toks


def test_quickstart_matches_jax():
    """Five steps of the port's quickstart from JAX's initial state, in
    fp32: every loss within 3e-5 of JAX's, the printed lines JAX's, the
    prompt and the 25 greedy tokens equal."""
    cfg = quickstart.make_cfg().with_(**FP32)
    init, want_losses, want_prompt, want_toks = _jax_quickstart(cfg)
    state = bridge.train_state_from_numpy(init, device=CPU)
    lines = []
    _, losses, prompt, toks = quickstart.train_and_generate(
        cfg, state, CPU, steps=QUICK_STEPS, say=lambda *a: lines.append(" ".join(map(str, a))))
    np.testing.assert_allclose(losses, want_losses, rtol=0, atol=TOL)
    assert prompt == want_prompt and toks == want_toks
    assert lines[0].startswith("step   0  loss ") and lines[1].startswith("step   4  loss ")
    assert lines[-2] == f"prompt: {want_prompt}" and lines[-1] == f"generated: {want_toks}"


# ---------------------------------------------------------------------------
# streaming_asr
# ---------------------------------------------------------------------------

def test_streaming_asr_matches_jax():
    """The port's streaming run (both engines, SRU-1/8/32) on JAX's params
    and stream: each output within 3e-5 of JAX's ``rnn_stack_prefill`` of
    the whole stream under the same engine; SRU-n against SRU-1 bitwise per
    engine but (fused, cpu), held to its ``MTS_BOUNDS`` entry; the engines
    within 1e-4."""
    from repro.models import rnn as jrnn

    jex = _jax_example("streaming_asr")
    key = jax.random.PRNGKey(0)
    cfg0 = jex.make_cfg(ASR["width"], ASR["layers"], "sequential", 1)
    jparams = jrnn.rnn_stack_init(key, cfg0, jnp.float32)
    jstream = jax.random.normal(key, (1, ASR["frames"], ASR["width"]))
    params = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device=CPU)
    stream = torch.tensor(np.asarray(jstream))
    results = streaming_asr.run(params, stream, layers=ASR["layers"], blocks=ASR["blocks"],
                                engines=ASR["engines"], device=CPU, say=lambda *a: None)
    for engine in ASR["engines"]:
        cfg = jex.make_cfg(ASR["width"], ASR["layers"], engine, 16)
        want, _ = jrnn.rnn_stack_prefill(jparams, cfg, jstream,
                                         jrnn.rnn_stack_init_cache(cfg, 1, jnp.float32))
        for n in ASR["blocks"]:
            np.testing.assert_allclose(results[(engine, n)][1], np.asarray(want), rtol=0,
                                       atol=TOL, err_msg=f"{engine} SRU-{n}")
    errs = streaming_asr.check(results, ASR["blocks"], ASR["engines"], CPU, say=lambda *a: None)
    assert all(errs[("sequential", n)] == 0 for n in ASR["blocks"][1:])
    assert 0 < max(errs[("fused", n)] for n in ASR["blocks"][1:]) <= \
        streaming_asr.MTS_BOUNDS[("fused", "cpu")]


def test_streaming_asr_cli_on_the_cpu(capsys):
    """``python -m repro_torch.examples.streaming_asr --device cpu`` at 64
    frames prints JAX's lines: one per (engine, n), the checks, the
    speedup."""
    assert streaming_asr.main(["--frames", "64", "--width", "64", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert sum("frames/s" in line and "realtime" in line for line in out) == 6
    assert "sequential: SRU-8 vs SRU-1: bitwise" in out
    assert out[-1].startswith("speedup SRU-32 vs SRU-1 (sequential): ")


# ---------------------------------------------------------------------------
# train_lm
# ---------------------------------------------------------------------------

def test_train_lm_configs_are_jaxs():
    """``llama-10m`` and ``llama-100m`` have the JAX example's fields."""
    jex = _jax_example("train_lm")
    for fn in ("model_10m", "model_100m"):
        want = getattr(jex, fn)()
        got = getattr(train_lm, fn)()
        assert {k: getattr(got, k) for k in vars(want)} == vars(want), fn


@pytest.fixture
def port_registry(monkeypatch):
    """The port's registry, restored after the test (``train_lm`` adds its
    config)."""
    from repro_torch.configs import registry

    monkeypatch.setattr(registry, "REGISTRY", dict(registry.REGISTRY))
    return registry.REGISTRY


def test_train_lm_saves_and_resumes(tmp_path, capsys, port_registry):
    """``--steps 4`` saves step 4; the same command at ``--steps 6`` resumes
    from it and trains steps 4 and 5."""
    ckpt = str(tmp_path / "ckpt")
    assert train_lm.main(TRAIN_ARGV + ["--checkpoint-dir", ckpt]) == 0
    assert CheckpointManager(ckpt).latest_step() == 4
    first = capsys.readouterr().out
    assert first.startswith("training llama-10m: ") and "step     3 loss" in first
    argv = ["--steps", "6"] + TRAIN_ARGV[2:] + ["--checkpoint-dir", ckpt]
    assert train_lm.main(argv) == 0
    out = capsys.readouterr().out
    assert "[resume] step 4" in out and "step     5 loss" in out and "step     3" not in out
    assert CheckpointManager(ckpt).latest_step() == 6


def test_train_lm_resumes_jaxs_checkpoint(tmp_path, monkeypatch, port_registry):
    """JAX's ``launch.train`` with the example's flags writes step 4; the
    port's run of ``train_lm.train_argv`` at ``--steps 6`` resumes from a
    copy of it and gives JAX's losses at steps 4 and 5 (JAX resumed from
    the same checkpoint) within 3e-5; ``llama-10m`` computes in fp32 on
    both sides."""
    from repro.configs import registry as jax_registry
    from repro.launch import train as jax_train

    from jax.sharding import AxisType

    monkeypatch.setattr(jax_train, "make_local_mesh", lambda model_axis=1: jax.make_mesh(
        (len(jax.devices()) // model_axis, model_axis), ("data", "model"),
        axis_types=(AxisType.Auto,) * 2))
    jex = _jax_example("train_lm")
    monkeypatch.setitem(jax_registry.REGISTRY, "llama-10m", jex.model_10m().with_(**FP32))
    args = train_lm.parse_args(TRAIN_ARGV + ["--checkpoint-dir", str(tmp_path / "jax")])
    port_registry["llama-10m"] = train_lm.register(args).with_(**FP32)
    argv = train_lm.train_argv(args)
    jax_argv = argv[:argv.index("--device")]
    with contextlib.redirect_stdout(io.StringIO()):
        jax_train.main(jax_argv)
    shutil.copytree(tmp_path / "jax", tmp_path / "port")

    def at_six(a, ckpt, out):
        a = list(a)
        a[a.index("--steps") + 1] = "6"
        a[a.index("--checkpoint-dir") + 1] = str(ckpt)
        return a + ["--metrics-out", str(out)]

    with contextlib.redirect_stdout(io.StringIO()):
        jax_train.main(at_six(jax_argv, tmp_path / "jax", tmp_path / "jax.json"))
        assert port_train.main(at_six(argv, tmp_path / "port", tmp_path / "port.json")) == 0
    want = json.loads((tmp_path / "jax.json").read_text())
    got = json.loads((tmp_path / "port.json").read_text())
    assert [r["step"] for r in got] == [r["step"] for r in want] == [4, 5]
    np.testing.assert_allclose([r["loss"] for r in got], [r["loss"] for r in want], rtol=0,
                               atol=TOL)
