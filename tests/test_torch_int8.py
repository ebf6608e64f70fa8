"""The port's int8 gate slabs against the JAX package's, on the same numpy
inputs: the quantization scheme (``kernels/fused_rnn/layout.py``), the int8
forms of the fused layer (B1) and the depth-fused stack (B2) through
``ops.fused_sru/fused_qrnn`` and ``stacked.fused_{sru,qrnn}_stack``, the
int8 cells through ``core/mts.py``'s fused engine, and the LM's int8 init
and casts; then JAX's quality gate (``tests/test_quantized.py``)
re-asserted inside the port.

JAX's Pallas kernels run in interpret mode on the CPU; the port's wrappers
run the kernels' plain versions there (``ref.py::fused_rnn_ref_q``,
``fused_rnn_stack_ref_q``), which ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold the CUDA kernels to on the card.
Quantization is held bitwise. Tolerances are the JAX package's own: 2e-5
for a layer, 3e-5 for a stack and for streaming against one-shot.
"""
from __future__ import annotations

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.core import mts as jmts
from repro.kernels.fused_rnn import layout as jlayout
from repro.kernels.fused_rnn import ops as jops
from repro.kernels.fused_rnn import stacked as jstacked
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.core import mts
from repro_torch.kernels.fused_rnn import layout
from repro_torch.kernels.fused_rnn import ops as tops
from repro_torch.kernels.fused_rnn import stacked as tstacked
from repro_torch.models import lm
from repro_torch.training.steps import build_decode_step, build_prefill_step

LAYER_TOL = 2e-5
STACK_TOL = 3e-5
STREAM_TOL = 3e-5
INT8_ARCHS = [
    "sru-paper-large-int8", "qrnn-paper-large-int8",
    "sru-paper-large-stacked-int8", "qrnn-paper-large-stacked-int8",
]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _bits_equal(got: torch.Tensor, want) -> bool:
    want = np.asarray(want)
    got = got.numpy()
    return got.dtype == want.dtype and got.shape == want.shape and np.array_equal(
        got.view(np.uint8), want.view(np.uint8)
    )


def _assert_same_tree(got, want):
    """Port tree (torch) vs JAX tree (numpy): same keys, dtypes and bits."""
    assert isinstance(got, dict) == isinstance(want, dict)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_same_tree(got[k], want[k])
    elif want is None:
        assert got is None
    else:
        assert _bits_equal(got, want), (got.dtype, np.asarray(want).dtype)


def _slab(rng, shape):
    return (rng.uniform(-1.0, 1.0, shape) / np.sqrt(shape[-3])).astype(np.float32)


# ---------------------------------------------------------------------------
# the quantization scheme, bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(40, 3, 64), (40, 3, 128), (24, 3, 200), (2, 24, 3, 200)],
                         ids=["H64", "H128", "H200", "stacked_H200"])
def test_quantize_slabs_bitwise(shape):
    w = 0.5 * np.random.default_rng(shape[-1]).normal(size=shape).astype(np.float32)
    jq, js = jlayout.quantize_slabs(jnp.asarray(w))
    q, s = layout.quantize_slabs(torch.tensor(w))
    assert _bits_equal(q, jq) and _bits_equal(s, js)
    assert s.shape[-1] == layout.n_scale_blocks(shape[-1]) == jlayout.n_scale_blocks(shape[-1])
    assert _bits_equal(layout.dequantize_slabs(q, s), jlayout.dequantize_slabs(jq, js))
    assert _bits_equal(layout.expand_scales(s, shape[-1]),
                       jlayout.expand_scales(js, shape[-1]))


@pytest.mark.parametrize("lead", [(), (3,)], ids=["layer", "stacked"])
@pytest.mark.parametrize("H", [64, 200])
def test_quantize_qrnn_slabs_bitwise(lead, H):
    rng = np.random.default_rng(H + len(lead))
    w0, w1 = _slab(rng, lead + (24, 3, H)), _slab(rng, lead + (24, 3, H))
    got = layout.quantize_qrnn_slabs(torch.tensor(w0), torch.tensor(w1))
    want = jlayout.quantize_qrnn_slabs(jnp.asarray(w0), jnp.asarray(w1))
    for g, w in zip(got, want):
        assert _bits_equal(g, w)
    assert got[0].is_contiguous() and got[1].is_contiguous()


@pytest.mark.parametrize("arch", ["sru-paper-large-stacked-int8", "qrnn-paper-large-int8",
                                  "lstm-paper-small"])
def test_quantize_tree_bitwise(arch):
    """The layers of a JAX fp init, quantized on both sides; dequantized back;
    LSTM passes through untouched."""
    jcfg = jax_get_config(arch).reduced().with_(weight_quant="none")
    jlayers = jlm.lm_init(jax.random.PRNGKey(5), jcfg)["layers"]
    layers = bridge.params_from_numpy(_np(jlayers), device="cpu")
    jq = jlayout.quantize_tree(jlayers)
    q = layout.quantize_tree(layers)
    _assert_same_tree(q, _np(jq))
    _assert_same_tree(layout.dequantize_tree(q), _np(jlayout.dequantize_tree(jq)))
    if arch.startswith("lstm"):
        _assert_same_tree(q, _np(jlayers))


def test_quantize_cell_keeps_w_skip_fp():
    rng = np.random.default_rng(9)
    cell = {"w": _slab(rng, (24, 3, 40)), "b": rng.normal(size=(2, 40)).astype(np.float32),
            "w_skip": _slab(rng, (24, 1, 40))[:, 0]}
    q = layout.quantize_cell(bridge.params_from_numpy(cell, device="cpu"))
    _assert_same_tree(q, _np(jlayout.quantize_cell(_jax(cell))))
    assert q["w_skip"].dtype == torch.float32 and sorted(q) == ["b", "w_skip", "wq", "wq_scale"]
    assert layout.quantize_cell(q) is q  # already quantized: unchanged


def test_kernel_scale_block_is_the_layout_scale_block():
    """The CUDA kernel reads lane j's scale at ``j // kScaleBlock`` from the
    compact scales that ``layout`` makes with ``SCALE_BLOCK`` lanes per
    block, as the JAX package does: the three are one number."""
    src = (pathlib.Path(layout.__file__).parent / "csrc" / "fused_rnn_layer.cu").read_text()
    kernel_block = re.search(r"constexpr int kScaleBlock = (\d+);", src)
    assert kernel_block is not None
    assert int(kernel_block.group(1)) == layout.SCALE_BLOCK == jlayout.SCALE_BLOCK


# ---------------------------------------------------------------------------
# B1 int8: the whole-layer kernel's plain version against JAX's kernel
# ---------------------------------------------------------------------------

LAYER_CASES = {
    # name: (cell, T, B, d, H, block_t, with_tail); SRU with d != H is sru_proj
    "sru_identity": ("sru", 16, 3, 64, 64, 8, False),
    "sru_proj": ("sru", 16, 3, 48, 64, 8, False),
    "qrnn_tail": ("qrnn", 16, 3, 64, 64, 8, True),
    "qrnn_no_tail": ("qrnn", 16, 3, 64, 64, 8, False),
    "sru_H200_block_t": ("sru", 12, 2, 200, 200, 4, False),
    "qrnn_H200_block_t": ("qrnn", 12, 2, 40, 200, 4, True),
}


def _cell(rng, cell, d, H):
    """A cell's fp params; an SRU cell with d != H gets its fp ``w_skip``."""
    if cell == "sru":
        return {"w": _slab(rng, (d, 3, H)), "b": rng.normal(0.0, 0.5, (2, H)).astype(np.float32),
                "w_skip": _slab(rng, (d, 1, H))[:, 0] if d != H else None}
    return {"w0": _slab(rng, (d, 3, H)), "w1": _slab(rng, (d, 3, H)),
            "b": rng.normal(0.0, 0.5, (3, H)).astype(np.float32)}


def _quantized_pair(params):
    """JAX's quantization of ``params``, and the port's copy of it."""
    jq = jlayout.quantize_cell(_jax(params))
    return jq, bridge.params_from_numpy(_np(jq), device="cpu")


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_int8_layer_matches_jax(case):
    cell, T, B, d, H, block_t, with_tail = LAYER_CASES[case]
    rng = np.random.default_rng(100 + sorted(LAYER_CASES).index(case))
    jq, tq = _quantized_pair(_cell(rng, cell, d, H))
    assert tq["wq_scale"].dtype == torch.float32
    x = rng.normal(size=(T, B, d)).astype(np.float32)
    c0 = rng.normal(0.0, 0.5, (B, H)).astype(np.float32)
    if cell == "sru":
        want = jops.fused_sru(jq, jnp.asarray(x), jnp.asarray(c0), block_t=block_t)
        got = tops.fused_sru(tq, torch.tensor(x), torch.tensor(c0), block_t=block_t)
    else:
        tail = rng.normal(size=(1, B, d)).astype(np.float32) if with_tail else None
        want = jops.fused_qrnn(jq, jnp.asarray(x), None if tail is None else jnp.asarray(tail),
                               jnp.asarray(c0), block_t=block_t)
        got = tops.fused_qrnn(tq, torch.tensor(x), None if tail is None else torch.tensor(tail),
                              torch.tensor(c0), block_t=block_t)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=LAYER_TOL, rtol=0)


@pytest.mark.parametrize("cell", ["sru", "qrnn"])
def test_int8_layer_streaming_equals_one_shot(cell):
    rng = np.random.default_rng(11)
    T, B, d, H, cut = 16, 2, 64, 200, 7
    _, params = _quantized_pair(_cell(rng, cell, d, H))
    x = torch.tensor(rng.normal(size=(T, B, d)).astype(np.float32))
    c0 = torch.zeros((B, H))
    if cell == "sru":
        h, c = tops.fused_sru(params, x, c0, block_t=4)
        h1, c1 = tops.fused_sru(params, x[:cut], c0, block_t=4)
        h2, c2 = tops.fused_sru(params, x[cut:], c1, block_t=4)
    else:
        h, c = tops.fused_qrnn(params, x, None, c0, block_t=4)
        h1, c1 = tops.fused_qrnn(params, x[:cut], None, c0, block_t=4)
        h2, c2 = tops.fused_qrnn(params, x[cut:], x[cut - 1:cut], c1, block_t=4)
    np.testing.assert_allclose(torch.cat([h1, h2]).numpy(), h.numpy(), atol=STREAM_TOL, rtol=0)
    np.testing.assert_allclose(c2.numpy(), c.numpy(), atol=STREAM_TOL, rtol=0)


@pytest.mark.parametrize("cell", ["sru", "qrnn"])
def test_int8_cell_through_mts_fused_engine(cell):
    """``mts_sru``/``mts_qrnn`` size the zero carry from the int8 slab when
    no ``c0`` is given (batch-major API), as JAX's do."""
    rng = np.random.default_rng(12)
    jq, tq = _quantized_pair(_cell(rng, cell, 24, 40))
    x = rng.normal(size=(2, 10, 24)).astype(np.float32)
    fn, jfn = (mts.mts_sru, jmts.mts_sru) if cell == "sru" else (mts.mts_qrnn, jmts.mts_qrnn)
    got = fn(tq, torch.tensor(x), engine="fused", block_size=4)
    want = jfn(jq, jnp.asarray(x), engine="fused", block_size=4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=LAYER_TOL, rtol=0)


# ---------------------------------------------------------------------------
# B2 int8: the depth-fused stack's plain version against JAX's kernel
# ---------------------------------------------------------------------------

ST, SB, SD, SBLOCK_T = 12, 2, 64, 4


def _stack_inputs(seed, cell, L, t=ST):
    rng = np.random.default_rng(seed)
    layers = [_cell(rng, cell, SD, SD) for _ in range(L)]
    stacked = {k: None if v is None else np.stack([c[k] for c in layers])
               for k, v in layers[0].items()}
    jq, tq = _quantized_pair(stacked)
    ln = (1.0 + 0.2 * rng.uniform(-1.0, 1.0, (L, SD))).astype(np.float32)
    x = rng.normal(size=(t, SB, SD)).astype(np.float32)
    c0 = rng.normal(0.0, 0.5, (L, SB, SD)).astype(np.float32)
    tails = rng.normal(size=(L, SB, SD)).astype(np.float32)
    return jq, tq, ln, x, c0, tails


def _stack_port(cell, tq, ln, x, c0, tails):
    t = torch.tensor
    if cell == "sru":
        y, c = tstacked.fused_sru_stack(tq, t(ln), t(x), t(c0), block_t=SBLOCK_T)
        return y, c, None
    return tstacked.fused_qrnn_stack(tq, t(ln), t(x), t(tails), t(c0), block_t=SBLOCK_T)


@pytest.mark.parametrize("L", [1, 2, 4])
@pytest.mark.parametrize("cell", ["sru", "qrnn"])
def test_int8_stack_matches_jax(cell, L):
    jq, tq, ln, x, c0, tails = _stack_inputs(10 * L + (cell == "qrnn"), cell, L)
    a = jnp.asarray
    if cell == "sru":
        want = jstacked.fused_sru_stack(jq, a(ln), a(x), a(c0), block_t=SBLOCK_T) + (None,)
    else:
        want = jstacked.fused_qrnn_stack(jq, a(ln), a(x), a(tails), a(c0), block_t=SBLOCK_T)
    got = _stack_port(cell, tq, ln, x, c0, tails)
    for name, g, w in zip(("y", "c_last", "tails_last"), got, want):
        if w is None:
            assert g is None
            continue
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=STACK_TOL, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("cell", ["sru", "qrnn"])
def test_int8_stack_streaming_equals_one_shot(cell):
    _, tq, ln, x, c0, tails = _stack_inputs(99, cell, 2)
    cut = 5
    one = _stack_port(cell, tq, ln, x, c0, tails)
    first = _stack_port(cell, tq, ln, x[:cut], c0, tails)
    tails_mid = tails if first[2] is None else first[2].numpy()
    second = _stack_port(cell, tq, ln, x[cut:], first[1].numpy(), tails_mid)
    np.testing.assert_allclose(torch.cat([first[0], second[0]]).numpy(), one[0].numpy(),
                               atol=STACK_TOL, rtol=0)
    for a, b in zip(second[1:], one[1:]):
        if b is not None:
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=STACK_TOL, rtol=0)


# ---------------------------------------------------------------------------
# the LM: int8 init, casts, bridge, and JAX's quality gate inside the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", INT8_ARCHS)
def test_lm_init_quantizes_and_casts_keep_scales_fp32(arch):
    cfg = get_config(arch).reduced()
    assert cfg.weight_quant == "int8"  # reduced() keeps the knob
    params = lm.lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    cell = params["layers"]["cell"]
    slabs, extra = (("wq",), ("w_skip",)) if cfg.cell == "sru" else (("w0q", "w1q"), ())
    assert sorted(cell) == sorted(slabs + extra + ("b", "wq_scale"))
    L, H = cfg.n_layers, cfg.rnn_hidden
    for k in slabs:
        assert cell[k].dtype == torch.int8 and tuple(cell[k].shape) == (L, cfg.d_model, 3, H)
    assert tuple(cell["wq_scale"].shape) == (L, 3, layout.n_scale_blocks(H))
    cast = layout.cast_params(params, torch.bfloat16)
    assert cast["layers"]["cell"]["wq_scale"].dtype == torch.float32
    assert all(cast["layers"]["cell"][k].dtype == torch.int8 for k in slabs)
    assert cast["layers"]["cell"]["b"].dtype == cast["embed"]["embed"].dtype == torch.bfloat16


def test_bridge_int8_tree_round_trips_and_keeps_scales_fp32():
    jcfg = jax_get_config("qrnn-paper-large-stacked-int8").reduced()
    params = _np(jlm.lm_init(jax.random.PRNGKey(0), jcfg))
    assert params["layers"]["cell"]["w0q"].dtype == np.int8
    port = bridge.params_from_numpy(params, device="cpu")
    assert port["layers"]["cell"]["w0q"].dtype == torch.int8
    back = bridge.params_to_numpy(port)
    _assert_same_tree(bridge.params_from_numpy(back, device="cpu"), params)
    bf = bridge.params_from_numpy(params, device="cpu", dtype=torch.bfloat16)
    cell = bf["layers"]["cell"]
    assert cell["wq_scale"].dtype == torch.float32
    assert _bits_equal(cell["wq_scale"], params["layers"]["cell"]["wq_scale"])
    assert cell["w0q"].dtype == cell["w1q"].dtype == torch.int8
    assert cell["b"].dtype == bf["final_norm"].dtype == torch.bfloat16


def _teacher_forced_logits(cfg, params, prompts, n_prefill):
    """Prefill on the first ``n_prefill`` tokens, then decode the rest one at
    a time: the logits at every position from ``n_prefill - 1`` on."""
    B, S = prompts.shape
    prefill = build_prefill_step(cfg, batch=B, max_len=S, device="cpu")
    decode = build_decode_step(cfg)
    logits, caches = prefill(params, {"inputs": prompts[:, :n_prefill]})
    out = [logits]
    for t in range(n_prefill, S):
        logits, caches = decode(params, caches, prompts[:, t:t + 1])
        out.append(logits)
    return torch.cat(out, dim=1)[..., : cfg.vocab]


def _greedy(cfg, params, prompts, gen_len):
    B, S = prompts.shape
    prefill = build_prefill_step(cfg, batch=B, max_len=S + gen_len, device="cpu")
    decode = build_decode_step(cfg)
    logits, caches = prefill(params, {"inputs": prompts})
    toks = []
    for _ in range(gen_len):
        tok = torch.argmax(logits[:, -1, : cfg.vocab], dim=-1)[:, None]
        toks.append(tok)
        logits, caches = decode(params, caches, tok)
    return torch.cat(toks, dim=1)


@pytest.mark.parametrize("name", ["sru-paper-large-int8", "qrnn-paper-large-int8"])
def test_int8_quality_gate(name):
    """JAX's gate (``tests/test_quantized.py``): int8 logits within 0.1 of the
    fp logits on fixed prompts, greedy agreement >= 0.9 over 16 tokens. The
    same generator seed gives both configs the same fp weights."""
    cfg_q = get_config(name).reduced()
    cfg_f = cfg_q.with_(weight_quant="none")
    params_f, params_q = (lm.lm_init(torch.Generator().manual_seed(0), c, device="cpu")
                          for c in (cfg_f, cfg_q))
    prompts = torch.tensor(np.random.default_rng(7).integers(0, cfg_q.vocab, (2, 24)))
    lf = _teacher_forced_logits(cfg_f, params_f, prompts, 8)
    lq = _teacher_forced_logits(cfg_q, params_q, prompts, 8)
    err = (lf - lq).abs().max().item()
    assert err < 0.1, f"{name}: int8 logit max-abs-error {err:.4f}"
    agree = (_greedy(cfg_f, params_f, prompts, 16) == _greedy(cfg_q, params_q, prompts, 16))
    assert agree.float().mean().item() >= 0.9
