"""The port's whole-layer fused SRU/QRNN (``repro_torch.kernels.fused_rnn.ops``)
against the JAX package's (``repro.kernels.fused_rnn.ops``, its Pallas kernel
run in interpret mode on the CPU), on the same numpy inputs.

On the CPU the port's wrapper runs the kernel's plain version; the CUDA
kernel itself is held to that plain version on the card by
``chip_smoke.py``. Tolerances are the JAX package's own: 2e-5 for a layer,
3e-5 for streaming against one-shot (``tests/test_fused_rnn.py``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_rnn import ops as jops
from repro_torch.bridge import params_from_numpy
from repro_torch.kernels.fused_rnn import fused_rnn
from repro_torch.kernels.fused_rnn import ops as tops

LAYER_TOL = 2e-5
STREAM_TOL = 3e-5


def _uniform(rng, shape, fan_in):
    return (rng.uniform(-1.0, 1.0, shape) / np.sqrt(fan_in)).astype(np.float32)


def _params(rng, cell, d, H, proj=False):
    if cell == "sru":
        return {
            "w": _uniform(rng, (d, 3, H), d),
            "b": rng.normal(0.0, 0.5, (2, H)).astype(np.float32),
            "w_skip": _uniform(rng, (d, H), d) if proj else None,
        }
    return {
        "w0": _uniform(rng, (d, 3, H), d),
        "w1": _uniform(rng, (d, 3, H), d),
        "b": rng.normal(0.0, 0.5, (3, H)).astype(np.float32),
    }


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(a):
    return torch.tensor(a)


CASES = {
    # name: (cell, T, B, d, H, block_t, proj, with_tail)
    "sru_identity": ("sru", 16, 3, 64, 64, 8, False, False),
    "sru_proj": ("sru", 16, 3, 48, 64, 8, True, False),
    "qrnn_tail": ("qrnn", 16, 3, 64, 64, 8, False, True),
    "qrnn_no_tail": ("qrnn", 16, 3, 64, 64, 8, False, False),
    "sru_H_not_128": ("sru", 12, 2, 72, 72, 4, False, False),
    "qrnn_H_not_128": ("qrnn", 12, 2, 40, 200, 4, False, True),
    "sru_T_ragged": ("sru", 13, 2, 64, 64, 4, False, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_layer_matches_jax(case):
    cell, T, B, d, H, block_t, proj, with_tail = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    params = _params(rng, cell, d, H, proj)
    x = rng.normal(size=(T, B, d)).astype(np.float32)
    c0 = rng.normal(0.0, 0.5, (B, H)).astype(np.float32)
    tail = rng.normal(size=(1, B, d)).astype(np.float32) if with_tail else None

    if cell == "sru":
        h_j, c_j = jops.fused_sru(_jax(params), jnp.asarray(x), jnp.asarray(c0), block_t=block_t)
        h_t, c_t = tops.fused_sru(
            params_from_numpy(params, device="cpu"), _t(x), _t(c0), block_t=block_t
        )
    else:
        tail_j = None if tail is None else jnp.asarray(tail)
        tail_t = None if tail is None else _t(tail)
        h_j, c_j = jops.fused_qrnn(
            _jax(params), jnp.asarray(x), tail_j, jnp.asarray(c0), block_t=block_t
        )
        h_t, c_t = tops.fused_qrnn(
            params_from_numpy(params, device="cpu"), _t(x), tail_t, _t(c0), block_t=block_t
        )
    assert h_t.shape == (T, B, H) and c_t.shape == (B, H)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=LAYER_TOL, rtol=0)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=LAYER_TOL, rtol=0)


@pytest.mark.parametrize("cell", ["sru", "qrnn"])
def test_fused_layer_streaming_equals_one_shot(cell):
    rng = np.random.default_rng(11)
    T, B, d, H, cut = 16, 2, 64, 64, 7
    params = params_from_numpy(_params(rng, cell, d, H), device="cpu")
    x = _t(rng.normal(size=(T, B, d)).astype(np.float32))
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


@pytest.mark.parametrize("batch,match", [(1, "CUDA tensors"), (129, "batch <= 128")])
def test_wrapper_refuses_what_the_kernel_does_not_take(batch, match):
    """Off the CPU the wrapper launches the CUDA kernel, takes its meta
    branch on meta tensors (meta outputs, the call recorded, no launch) or
    raises; it never falls back to the plain version. A batch above the
    kernel's is refused on meta too; the CUDA path's operand check refuses
    any tensor off the card."""
    from repro_torch.kernels.common import recorded_kernel_calls

    u = torch.zeros((2, batch, 8), device="meta")
    w = torch.zeros((8, 3, 8), device="meta")

    def call():
        return fused_rnn.fused_rnn_layer(
            u, (w,), torch.zeros((3, 8), device="meta"), torch.zeros((batch, 8), device="meta"),
            mode="sru_identity",
        )

    if batch > fused_rnn.MAX_BATCH:
        with pytest.raises(ValueError, match=match):
            call()
        return
    before = fused_rnn.LAUNCHES
    with recorded_kernel_calls() as calls:
        h, c_last = call()
    assert h.device.type == c_last.device.type == "meta"
    assert [k["name"] for k in calls] == ["fused_rnn_layer"] and fused_rnn.LAUNCHES == before
    with pytest.raises(ValueError, match=match):
        fused_rnn.kernel_dtype(torch.zeros((2, batch, 8)), batch)


def test_layout_cell_kind_matches_jax():
    from repro.kernels.fused_rnn import layout as jlayout
    from repro_torch.kernels.fused_rnn import layout

    for keys in (("w", "b", "w_skip"), ("w0", "w1", "b"), ("wx", "uh", "b"),
                 ("wq", "wq_scale", "b"), ("w0q", "w1q", "wq_scale", "b"), ("embed",)):
        cell = dict.fromkeys(keys)
        assert layout.cell_kind(cell) == jlayout.cell_kind(cell), keys
        assert layout.is_quantized(cell) == jlayout.is_quantized(cell), keys
