"""The port's serving path (``repro_torch``: bridge, LM, step builders,
``launch/serve.py``) against the JAX package's, on the ``.reduced()`` forms of the fused,
stacked and ``*-int8`` configs and of the paper's seven base SRU/QRNN/LSTM configs
(under their own ``chunked`` engine, under ``pallas``, and under the
sequential and associative engines), and of the GQA attention LMs
(``llama3-8b``, ``smollm-360m`` and a padded-head variant), with the JAX
package's own params bridged across. The Mamba-2 LM has its own file,
``tests/test_torch_mamba.py``.

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

from repro.configs import llama3_8b as jax_llama3_8b
from repro.configs import paper_rnn as jax_paper_rnn
from repro.configs import smollm_360m as jax_smollm_360m
from repro.configs.registry import REGISTRY as JAX_REGISTRY
from repro.configs.registry import get_config as jax_get_config
from repro.models import lm as jlm
from repro.training.steps import build_decode_step as jax_decode_builder
from repro.training.steps import build_prefill_step as jax_prefill_builder
from repro_torch import bridge
from repro_torch.configs import llama3_8b, paper_rnn, smollm_360m
from repro_torch.configs.base import ArchConfig
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
# (arch, config overrides): the attention LMs; the padded-head variant keeps
# the head padding that ``reduced()`` drops (smollm's 15 -> 16 at full size).
ATTN_CASES = {
    "llama3-8b": ("llama3-8b", {}),
    "smollm-360m": ("smollm-360m", {}),
    "padded_heads": ("smollm-360m", dict(n_heads=3, n_kv_heads=1, pad_heads_to=4)),
}
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


@pytest.mark.parametrize("mine,ref", [(llama3_8b.CONFIG, jax_llama3_8b.CONFIG),
                                      (smollm_360m.CONFIG, jax_smollm_360m.CONFIG)],
                         ids=["llama3-8b", "smollm-360m"])
def test_attention_configs_are_faithful_copies(mine, ref):
    for cfg, jcfg in ((mine, ref), (mine.reduced(), ref.reduced())):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.padded_vocab == jcfg.padded_vocab
        assert cfg.num_params() == jcfg.num_params()
    assert get_config(mine.name) is mine


def test_bridge_round_trip_attention_is_bitwise():
    """The attention params (``w_q``, ``w_kv``, ``w_o``, norms, MLP, tied and
    untied embeddings) and the ``{"k", "v", "pos"}`` caches; int32 ``pos``
    bitwise, bf16 through fp32."""
    for arch in ("llama3-8b", "smollm-360m"):
        jcfg = jax_get_config(arch).reduced()
        params = _np_tree(jlm.lm_init(jax.random.PRNGKey(5), jcfg))
        assert sorted(params["layers"]["attn"]) == ["w_kv", "w_o", "w_q"]
        _assert_same_tree(bridge.params_to_numpy(bridge.params_from_numpy(params, device="cpu")),
                          params)
        caches = _np_tree(jlm.lm_init_caches(jcfg, 2, 8))
        rng = np.random.default_rng(0)
        caches["layers"]["pos"] = rng.integers(0, 1 << 30, jcfg.n_layers).astype(np.int32)
        caches["layers"]["k"] = np.asarray(
            jnp.asarray(rng.standard_normal(caches["layers"]["k"].shape), jnp.bfloat16))
        back = bridge.caches_to_numpy(bridge.caches_from_numpy(caches, device="cpu"))
        assert back["layers"]["pos"].dtype == np.int32
        assert np.array_equal(back["layers"]["pos"], caches["layers"]["pos"])
        assert np.array_equal(back["layers"]["k"], caches["layers"]["k"].astype(np.float32))
        mine = lm.lm_init_caches(get_config(arch).reduced(), 2, 8, device="cpu")
        assert sorted(mine["layers"]) == sorted(caches["layers"]) == ["k", "pos", "v"]
        for k, v in mine["layers"].items():
            assert tuple(v.shape) == caches["layers"][k].shape
        assert mine["layers"]["pos"].dtype == torch.int32


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


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_lms_match_jax(case):
    arch, overrides = ATTN_CASES[case]
    _check_prefill_and_decode(arch, None, overrides)


def _check_prefill_and_decode(arch, engine, overrides=None):
    jcfg = jax_get_config(arch).reduced().with_(**(overrides or {}))
    cfg = get_config(arch).reduced().with_(**(overrides or {}))
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


@pytest.mark.parametrize("arch", SLICE_ARCHS + ["llama3-8b", "smollm-360m"])
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

    def recording_init(gen, cfg, device, **kw):
        inits.append(cfg)
        return real_init(gen, cfg, device=device, **kw)

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


def _serve_tokens(argv, capsys):
    assert serve.main(argv + ["--reduced", "--device", "cpu", "--batch", "2",
                              "--prompt-len", "8", "--gen-len", "4"]) == 0
    out = capsys.readouterr().out
    return json.loads(out.split("serve-stats ", 1)[1])["tokens"]


@pytest.mark.parametrize("arch", ["llama3-8b", "smollm-360m"])
def test_serve_attention_does_not_consult_the_engine(arch, capsys):
    """As in JAX, ``--engine`` is validated but an attention LM does not
    consult it: every engine gives the same tokens; an unknown one exits."""
    tokens = _serve_tokens(["--arch", arch], capsys)
    for engine in ("pallas", "fused_stack", "sequential"):
        assert _serve_tokens(["--arch", arch, "--engine", engine], capsys) == tokens
    with pytest.raises(SystemExit, match="unknown engine 'bogus'"):
        serve.main(["--arch", arch, "--engine", "bogus", "--reduced", "--device", "cpu"])


def test_serve_attention_weight_quant_leaves_every_leaf(capsys, monkeypatch):
    """``--weight-quant int8`` on an attention LM: ``quantize_tree`` has no
    cell to quantize, so the params (and the tokens) are those of fp."""
    made = []
    real_init = lm.lm_init

    def recording_init(gen, cfg, device, **kw):
        made.append(real_init(gen, cfg, device=device, **kw))
        return made[-1]

    monkeypatch.setattr(lm, "lm_init", recording_init)
    tokens = _serve_tokens(["--arch", "llama3-8b"], capsys)
    assert _serve_tokens(["--arch", "llama3-8b", "--weight-quant", "int8"], capsys) == tokens
    fp, q = (bridge.params_to_numpy(p) for p in made)
    _assert_same_tree(q, fp)


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "qwen3-moe-235b-a22b", "zamba2-7b",
                                  "musicgen-large", "internvl2-2b"])
def test_unserved_families_are_refused_naming_the_queue(arch):
    """The MoE, hybrid (Mamba-2 plus shared attention) and frontend configs
    (the JAX package's, rebuilt as the port's ``ArchConfig``) are refused by
    ``lm_init`` and ``lm_init_caches`` with the ROADMAP queue in the
    message."""
    cfg = ArchConfig(**dataclasses.asdict(JAX_REGISTRY[arch])).reduced()
    for make in (lambda: lm.lm_init(torch.Generator().manual_seed(0), cfg, device="cpu"),
                 lambda: lm.lm_init_caches(cfg, 2, 8, device="cpu")):
        with pytest.raises(NotImplementedError, match=r"ROADMAP\.md §A6"):
            make()


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
        serve.main(["--arch", "sru-paper-large-stacked", "--mode", "continuous",
                    "--speculative"])
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
        "assert 'repro_torch.training.graphs' in mods, mods\n"
        "print(len(mods))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code, str(REPO)], capture_output=True, text=True,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"}, timeout=120,
    )
    assert out.returncode == 0, out.stderr
