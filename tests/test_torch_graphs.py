"""The CUDA graph wrapper of the serving steps (``repro_torch/training/graphs.py``)
and ``run_batch``'s use of it, on the CPU.

A graph captures and replays only on the card (``tests/test_torch_cuda.py``
holds the captured steps against the eager ones there). Here: the launch
accounting on stand-in counter modules and a stand-in graph (warm-ups and
captures take their launches out, each replay adds the captured rise), the
copy of arguments into the static inputs, the warm-up leaving the caches it
is given bitwise as they were (attention, Mamba-2 and RNN LMs, reduced), the
refusal of CPU tensors, and ``run_batch(..., graphs=True)`` on the CPU
running the eager steps, with the tokens of ``graphs=False`` and of the JAX
package's jitted steps on bridged params (fp32, reduced configs).
"""
from __future__ import annotations

import argparse
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.models import lm as jlm
from repro.training.steps import build_decode_step as jax_build_decode_step
from repro.training.steps import build_prefill_step as jax_build_prefill_step
from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.training import graphs
from repro_torch.training.steps import build_decode_step, build_prefill_step


def _stand_in_counters():
    mods = (types.SimpleNamespace(LAUNCHES=5, LAUNCHES_INT8=1), types.SimpleNamespace(LAUNCHES=0))
    return mods, ((mods[0], "LAUNCHES"), (mods[0], "LAUNCHES_INT8"), (mods[1], "LAUNCHES"))


def _counts(counters):
    return [getattr(mod, attr) for mod, attr in counters]


def _launching_step(mods):
    """A stand-in step that launches two kernels of the first module, one
    int8 instance and three of the second module, and doubles its input."""
    def step(x):
        mods[0].LAUNCHES += 2
        mods[0].LAUNCHES_INT8 += 1
        mods[1].LAUNCHES += 3
        return x * 2
    return step


def test_uncounted_takes_the_launches_out_and_reports_the_rise():
    mods, counters = _stand_in_counters()
    step = _launching_step(mods)
    with graphs.uncounted(counters) as rise:
        step(torch.ones(2))
        step(torch.ones(2))
    assert rise == [4, 2, 6]
    assert _counts(counters) == [5, 1, 0]
    with pytest.raises(RuntimeError, match="inside"):
        with graphs.uncounted(counters) as rise:
            step(torch.ones(2))
            raise RuntimeError("inside")
    assert rise == [2, 1, 3] and _counts(counters) == [5, 1, 0]


def test_warm_up_is_not_counted():
    mods, counters = _stand_in_counters()
    out = graphs.warm_up(lambda params, x: _launching_step(mods)(x + params), 1.0,
                         torch.ones(3), counters=counters)
    assert torch.equal(out, torch.full((3,), 4.0))
    assert _counts(counters) == [5, 1, 0]


class _StandInGraph:
    """Replays by running the step again on the static inputs, in place of
    the outputs it captured (what a CUDA graph's replay computes)."""

    def __init__(self, fn, inputs, outputs):
        self.fn, self.inputs, self.outputs, self.replays = fn, inputs, outputs, 0

    def replay(self):
        self.outputs.copy_(self.fn(*self.inputs))
        self.replays += 1


def test_each_replay_adds_the_captured_launches():
    """Warm-up and capture counted nothing; each replay adds the rise the
    capture counted, and replays nothing else."""
    mods, counters = _stand_in_counters()
    step = _launching_step(mods)
    static_x = torch.arange(4.0)
    graphs.warm_up(lambda _, x: step(x), None, static_x, counters=counters)
    with graphs.uncounted(counters) as rise:
        out = step(static_x)  # what a capture runs of the step's Python
    assert _counts(counters) == [5, 1, 0]
    captured = graphs.CapturedStep(_StandInGraph(lambda x: x * 2, (static_x,), out),
                                   (static_x,), out, rise, counters)
    for n in range(1, 4):
        assert captured(torch.full((4,), float(n))) is out
        assert torch.equal(out, torch.full((4,), 2.0 * n))
        assert _counts(counters) == [5 + 2 * n, 1 + n, 3 * n]
    assert captured.graph.replays == 3


def test_replay_copies_only_what_is_not_the_static_input():
    """The very objects captured (params, caches) are taken as they are; a
    new tensor is copied in; another shape, dtype, structure or non-tensor
    value is refused."""
    params = {"w": torch.ones(3)}
    caches = {"layers": {"c": torch.zeros(2, 3)}, "pos": None}
    token = torch.zeros((2, 1), dtype=torch.long)
    graph = types.SimpleNamespace(replay=lambda: None)
    captured = graphs.CapturedStep(graph, (params, caches, token), "out", (), ())
    with torch.inference_mode():
        ptrs = [t.data_ptr() for t in graphs.leaves((params, caches, token))]
        assert captured(params, caches, torch.tensor([[3], [4]])) == "out"
        assert token.tolist() == [[3], [4]]
        assert [t.data_ptr() for t in graphs.leaves((params, caches, token))] == ptrs
        captured(params, {"layers": {"c": torch.full((2, 3), 7.0)}, "pos": None}, token)
        assert torch.equal(caches["layers"]["c"], torch.full((2, 3), 7.0))
        for bad, match in (
                ((params, caches, torch.zeros((3, 1), dtype=torch.long)), r"args\[2\] is a"),
                ((params, caches, token.int()), "torch.int32"),
                (({"v": torch.ones(3)}, caches, token), "other keys"),
                ((params, {"layers": {"c": caches["layers"]["c"]}, "pos": 1}, token),
                 r"args\[1\]\['pos'\] is 1"),
                ((params, caches), "another length")):
            with pytest.raises(ValueError, match=match):
                captured(*bad)


def test_capture_refuses_cpu_tensors_naming_the_cuda_device():
    with pytest.raises(ValueError, match="needs its tensors on a CUDA device; got tensors on cpu"):
        graphs.capture(lambda x: x * 2, torch.ones(3))
    with pytest.raises(ValueError, match="on a CUDA device; got no tensor"):
        graphs.capture(lambda: None)


@pytest.mark.parametrize("arch", ["llama3-8b", "mamba2-2.7b", "qrnn-paper-large-stacked",
                                  "sru-paper-large"])
def test_warm_up_leaves_the_given_caches_bitwise(arch):
    """The decode warm-up runs on clones of the caches it is given (the
    buffers a graph replays over), and computes what the step computes on
    them."""
    cfg = get_config(arch).reduced()
    params = lm.lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    prompt = torch.randint(0, cfg.vocab, (2, 8), generator=torch.Generator().manual_seed(1))
    prefill = build_prefill_step(cfg, batch=2, max_len=12, device="cpu")
    decode = build_decode_step(cfg)
    logits, caches = prefill(params, {"inputs": prompt})
    token = serve._greedy(cfg, logits)
    before = [t.clone() for t in graphs.leaves(caches)]
    ptrs = [t.data_ptr() for t in graphs.leaves(caches)]
    warm_logits, warm_caches = graphs.warm_up(decode, params, caches, token)
    after = graphs.leaves(caches)
    assert [t.data_ptr() for t in after] == ptrs
    assert all(torch.equal(a, b) for a, b in zip(after, before))
    want_logits, want_caches = decode(params, caches, token)
    assert torch.equal(warm_logits, want_logits)
    assert all(torch.equal(a, b) for a, b in zip(graphs.leaves(warm_caches),
                                                 graphs.leaves(want_caches)))


def _jax_greedy_tokens(arch, engine, params_np, prompt, gen_len):
    """The loop of the JAX package's ``repro/launch/serve.py::run_batch``:
    its jitted prefill and decode steps, greedy argmax outside them."""
    jcfg = jax_get_config(arch).reduced()
    if engine:
        jcfg = jcfg.with_(scan_engine=engine)
    batch, prompt_len = prompt.shape
    prefill = jax.jit(jax_build_prefill_step(jcfg, batch=batch, max_len=prompt_len + gen_len))
    decode = jax.jit(jax_build_decode_step(jcfg), donate_argnums=(1,))
    params = jax.tree_util.tree_map(jnp.asarray, params_np)
    logits, caches = prefill(params, {"inputs": jnp.asarray(prompt, dtype=jnp.int32)})
    tok = jnp.argmax(logits[:, -1, : jcfg.vocab], axis=-1)[:, None]
    out = [tok]
    for _ in range(gen_len - 1):
        logits, caches = decode(params, caches, tok)
        tok = jnp.argmax(logits[:, -1, : jcfg.vocab], axis=-1)[:, None]
        out.append(tok)
    return np.concatenate([np.asarray(t) for t in out], axis=1).tolist()


@pytest.mark.parametrize("arch,engine", [("sru-paper-large-stacked", None),
                                         ("qrnn-paper-large", "pallas"),
                                         ("lstm-paper-large", None),
                                         ("llama3-8b", None), ("mamba2-2.7b", None)])
def test_run_batch_on_the_cpu_runs_the_eager_steps(arch, engine):
    """``graphs=True`` on the CPU: the eager steps (no capture, no
    ``capture_ms``), the tokens of ``graphs=False`` and of the JAX package's
    jitted steps on the same params (bridged) and prompt."""
    jcfg = jax_get_config(arch).reduced()
    if engine:
        jcfg = jcfg.with_(scan_engine=engine)
    params_np = jax.tree_util.tree_map(np.asarray, jlm.lm_init(jax.random.PRNGKey(3), jcfg))
    cfg = get_config(arch).reduced()
    if engine:
        cfg = cfg.with_(scan_engine=engine)
    params = bridge.params_from_numpy(params_np, device="cpu")
    args = argparse.Namespace(batch=2, prompt_len=8, gen_len=5, seed=4)
    cpu = torch.device("cpu")
    captured = serve.run_batch(cfg, params, args, cpu, graphs=True)
    eager = serve.run_batch(cfg, params, args, cpu, graphs=False)
    assert captured["graphs"] is False and captured["capture_ms"] is None
    assert captured["cache_in_place"] and eager["cache_in_place"]
    assert captured["tokens"] == eager["tokens"]
    prompt = torch.randint(0, cfg.vocab, (2, 8), generator=torch.Generator().manual_seed(4))
    assert captured["tokens"] == _jax_greedy_tokens(arch, engine, params_np, prompt.numpy(), 5)
