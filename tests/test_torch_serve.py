"""The port's serving path (``repro_torch``: bridge, LM, step builders,
``launch/serve.py``) against the JAX package's, on the ``.reduced()`` forms of the fused,
stacked and ``*-int8`` configs and of the paper's seven base SRU/QRNN/LSTM configs
(under their own ``chunked`` engine, under ``pallas``, and under the
sequential and associative engines), with the JAX package's own params
bridged across.

Prefill and 8 greedy decode steps: logits and every cache leaf within 3e-5
(``tests/test_rnn_stack.py``'s tolerance for a stack or logits), greedy
tokens identical (fp32 compute, where argmax ties do not occur).
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_rnn as jax_paper_rnn
from repro.configs.registry import get_config as jax_get_config
from repro.models import lm as jlm
from repro.training.steps import build_decode_step as jax_decode_builder
from repro.training.steps import build_prefill_step as jax_prefill_builder
from repro_torch import bridge
from repro_torch.configs import paper_rnn
from repro_torch.configs.registry import get_config
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.training.steps import build_decode_step, build_prefill_step

REPO = Path(__file__).resolve().parents[1]
SLICE_ARCHS = [
    "sru-paper-large-stacked", "qrnn-paper-large-stacked",
    "sru-paper-large-fused", "qrnn-paper-large-fused",
    "sru-paper-large-int8", "qrnn-paper-large-int8",
    "sru-paper-large-stacked-int8", "qrnn-paper-large-stacked-int8",
]
BASE_ARCHS = [
    "sru-paper-small", "sru-paper-large", "qrnn-paper-small", "qrnn-paper-large",
    "lstm-paper-small", "lstm-paper-large", "sru-paper-draft",
]
# (arch, engine override): each base config on its own engine; the SRU/QRNN
# ones under pallas too; one config of each cell under sequential and
# associative (LSTM ignores the engine, as in JAX).
BASE_CASES = (
    [(a, None) for a in BASE_ARCHS]
    + [(a, "pallas") for a in BASE_ARCHS if not a.startswith("lstm")]
    + [(a, e) for a in ("sru-paper-small", "qrnn-paper-small", "lstm-paper-small")
       for e in ("sequential", "associative")]
)
LOGIT_TOL = 3e-5
B, PROMPT, STEPS = 3, 20, 8


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_same_tree(a, b):
    assert isinstance(a, dict) == isinstance(b, dict)
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_same_tree(a[k], b[k])
    elif a is None:
        assert b is None
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)


def test_configs_are_faithful_copies():
    assert [c.name for c in paper_rnn.CONFIGS] == [c.name for c in jax_paper_rnn.CONFIGS]
    for mine, ref in zip(paper_rnn.CONFIGS, jax_paper_rnn.CONFIGS):
        for cfg, jcfg in ((mine, ref), (mine.reduced(), ref.reduced())):
            assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
            assert cfg.padded_vocab == jcfg.padded_vocab


def test_bridge_round_trip_is_bitwise():
    jcfg = jax_get_config("qrnn-paper-large-stacked").reduced()
    params = _np_tree(jlm.lm_init(jax.random.PRNGKey(0), jcfg))
    sru = _np_tree(jlm.lm_init(jax.random.PRNGKey(1), jax_get_config("sru-paper-small").reduced()))
    assert sru["layers"]["cell"]["w_skip"] is None
    for tree in (params, sru):
        _assert_same_tree(bridge.params_to_numpy(bridge.params_from_numpy(tree, device="cpu")),
                          tree)
    caches = _np_tree(jlm.lm_init_caches(jcfg, 2, 8))
    _assert_same_tree(bridge.caches_to_numpy(bridge.caches_from_numpy(caches, device="cpu")),
                      caches)
    bf16 = {"a": np.asarray(jnp.linspace(-3.0, 3.0, 17, dtype=jnp.bfloat16))}
    back = bridge.params_to_numpy(bridge.params_from_numpy(bf16, device="cpu"))
    assert np.array_equal(back["a"], bf16["a"].astype(np.float32))


def _compare_caches(port, ref):
    for k, v in ref["layers"].items():
        got = port["layers"][k].numpy()
        assert got.shape == v.shape, k
        np.testing.assert_allclose(got, np.asarray(v), atol=LOGIT_TOL, rtol=0, err_msg=k)


def test_bridge_round_trip_lstm_is_bitwise():
    """The LSTM leaves (flat ``wx``, ``uh``, ``b``) and its ``h`` cache."""
    jcfg = jax_get_config("lstm-paper-small").reduced()
    params = _np_tree(jlm.lm_init(jax.random.PRNGKey(2), jcfg))
    assert sorted(params["layers"]["cell"]) == ["b", "uh", "wx"]
    _assert_same_tree(bridge.params_to_numpy(bridge.params_from_numpy(params, device="cpu")),
                      params)
    caches = _np_tree(jlm.lm_init_caches(jcfg, 2, 8))
    caches["layers"]["h"] = np.random.default_rng(0).normal(
        size=caches["layers"]["h"].shape).astype(np.float32)
    _assert_same_tree(bridge.caches_to_numpy(bridge.caches_from_numpy(caches, device="cpu")),
                      caches)
    mine = lm.lm_init_caches(get_config("lstm-paper-small").reduced(), 2, 8, device="cpu")
    assert sorted(mine["layers"]) == sorted(caches["layers"]) == ["c", "h"]
    for k, v in mine["layers"].items():
        assert tuple(v.shape) == caches["layers"][k].shape


def test_lm_init_defaults_to_the_card():
    """The port's entry points build on the card unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a CUDA device")
    cfg = get_config("sru-paper-small").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.lm_init(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.lm_init_caches(cfg, 2, 8)


@pytest.mark.parametrize("arch", SLICE_ARCHS)
def test_prefill_and_decode_match_jax(arch):
    _check_prefill_and_decode(arch, None)


@pytest.mark.parametrize("arch,engine", BASE_CASES)
def test_base_configs_match_jax(arch, engine):
    _check_prefill_and_decode(arch, engine)


def _check_prefill_and_decode(arch, engine):
    jcfg = jax_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    if engine is not None:
        jcfg, cfg = jcfg.with_(scan_engine=engine), cfg.with_(scan_engine=engine)
    jparams = jlm.lm_init(jax.random.PRNGKey(3), jcfg)
    params = bridge.params_from_numpy(_np_tree(jparams), device="cpu")
    prompt = np.random.default_rng(4).integers(0, cfg.vocab, (B, PROMPT)).astype(np.int32)

    jprefill = jax.jit(jax_prefill_builder(jcfg, batch=B, max_len=PROMPT + STEPS))
    jdecode = jax.jit(jax_decode_builder(jcfg))
    prefill = build_prefill_step(cfg, batch=B, max_len=PROMPT + STEPS, device="cpu")
    decode = build_decode_step(cfg)

    jlogits, jcaches = jprefill(jparams, {"inputs": jnp.asarray(prompt)})
    logits, caches = prefill(params, {"inputs": torch.tensor(prompt, dtype=torch.long)})
    for step in range(STEPS + 1):
        assert logits.shape == jlogits.shape
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=LOGIT_TOL, rtol=0,
                                   err_msg=f"step {step}")
        _compare_caches(caches, jcaches)
        jtok = jnp.argmax(jlogits[:, -1, : jcfg.vocab], axis=-1)[:, None]
        tok = torch.argmax(logits[:, -1, : cfg.vocab], dim=-1)[:, None]
        assert np.array_equal(tok.numpy(), np.asarray(jtok)), f"greedy tokens differ at {step}"
        if step < STEPS:
            jlogits, jcaches = jdecode(jparams, jcaches, jtok)
            logits, caches = decode(params, caches, tok)


@pytest.mark.parametrize("arch", SLICE_ARCHS)
def test_serve_main_runs_on_cpu(arch, capsys):
    rc = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                     "--batch", "2", "--prompt-len", "8", "--gen-len", "4"])
    assert rc == 0
    assert "serve-stats " in capsys.readouterr().out


@pytest.mark.parametrize("engine", serve.ENGINES)
def test_serve_main_runs_every_engine_on_cpu(engine, capsys):
    for arch in ("qrnn-paper-small", "lstm-paper-small"):
        rc = serve.main(["--arch", arch, "--engine", engine, "--reduced", "--device", "cpu",
                         "--batch", "2", "--prompt-len", "8", "--gen-len", "4"])
        assert rc == 0
        assert "serve-stats " in capsys.readouterr().out


def test_serve_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "sru-paper-large-stacked", "--reduced"])


def test_serve_int8_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qrnn-paper-large-stacked-int8", "--reduced"])


@pytest.mark.parametrize("arch,quant", [("sru-paper-large-fused", "int8"),
                                        ("qrnn-paper-large-stacked", "int8"),
                                        ("sru-paper-large-int8", "none")])
def test_serve_weight_quant_flag(arch, quant, capsys, monkeypatch):
    """``--weight-quant`` overrides the config's knob; ``lm_init`` then
    quantizes (or not) the gate slabs the run serves."""
    inits = []
    real_init = lm.lm_init

    def recording_init(gen, cfg, device):
        inits.append(cfg)
        return real_init(gen, cfg, device=device)

    monkeypatch.setattr(lm, "lm_init", recording_init)
    rc = serve.main(["--arch", arch, "--weight-quant", quant, "--reduced", "--device", "cpu",
                     "--batch", "2", "--prompt-len", "8", "--gen-len", "4"])
    assert rc == 0 and "serve-stats " in capsys.readouterr().out
    assert [c.weight_quant for c in inits] == [quant]


@pytest.mark.parametrize("argv,match", [
    (["--arch", "lstm-paper-small", "--weight-quant", "int8"], "does not apply to LSTM"),
    (["--arch", "sru-paper-large-int8", "--engine", "chunked"], "requires engine 'fused'"),
    (["--arch", "qrnn-paper-large-stacked-int8", "--engine", "pallas"],
     "requires engine 'fused'"),
    (["--arch", "sru-paper-large", "--weight-quant", "int8"], "requires engine 'fused'"),
])
def test_serve_refuses_int8_where_no_kernel_dequantizes(argv, match):
    """JAX's int8 checks (``validate_engine_mesh``), with its messages."""
    with pytest.raises(SystemExit) as exc:
        serve.main(argv + ["--reduced", "--device", "cpu"])
    assert match in str(exc.value)


def test_serve_base_config_on_pallas_runs_as_a_module():
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "sru-paper-large",
           "--engine", "pallas", "--reduced", "--device", "cpu",
           "--batch", "2", "--prompt-len", "8", "--gen-len", "4"]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=120, cwd=REPO,
                         env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    stats = json.loads(out.stdout.split("serve-stats ", 1)[1])
    assert stats["arch"] == "sru-paper-large-smoke" and len(stats["tokens"][0]) == 4


def test_serve_rejects_unknown_flags_and_engines(capsys):
    with pytest.raises(SystemExit):
        serve.main(["--arch", "sru-paper-large-stacked", "--mode", "continuous"])
    with pytest.raises(SystemExit) as exc:
        serve.main(["--arch", "sru-paper-large", "--engine", "bogus", "--device", "cpu"])
    msg = str(exc.value)
    assert "unknown engine 'bogus'" in msg
    assert all(e in msg for e in serve.ENGINES)


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "sys.path.insert(0, sys.argv[1]); import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "assert len(mods) >= 15, mods\n"
        "print(len(mods))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code, str(REPO)], capture_output=True, text=True,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"}, timeout=120,
    )
    assert out.returncode == 0, out.stderr
