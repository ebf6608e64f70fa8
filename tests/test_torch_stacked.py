"""The port's depth-fused SRU/QRNN stack (``repro_torch.kernels.fused_rnn.stacked``)
against the JAX package's (``repro.kernels.fused_rnn.stacked``, its Pallas
kernel run in interpret mode on the CPU), on the same numpy inputs.

Width 64 takes the JAX side through its padded path (H padded to 128 lanes,
the norm masked to the true width); the port does not pad, and its outputs
must equal the sliced JAX outputs. Tolerance 3e-5, the JAX package's own for
a stack (``tests/test_rnn_stack.py``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_rnn import stacked as jstacked
from repro_torch.bridge import params_from_numpy
from repro_torch.kernels.fused_rnn import stacked as tstacked

STACK_TOL = 3e-5
T, B, D, BLOCK_T = 12, 2, 64, 4


def _stack_params(rng, cell, L, d):
    def slab():
        return (rng.uniform(-1.0, 1.0, (L, d, 3, d)) / np.sqrt(d)).astype(np.float32)

    if cell == "sru":
        p = {"w": slab(), "b": rng.normal(0.0, 0.5, (L, 2, d)).astype(np.float32),
             "w_skip": None}
    else:
        p = {"w0": slab(), "w1": slab(), "b": rng.normal(0.0, 0.5, (L, 3, d)).astype(np.float32)}
    ln = (1.0 + 0.2 * rng.uniform(-1.0, 1.0, (L, d))).astype(np.float32)
    return p, ln


def _inputs(seed, cell, L, t=T):
    rng = np.random.default_rng(seed)
    params, ln = _stack_params(rng, cell, L, D)
    x = rng.normal(size=(t, B, D)).astype(np.float32)
    c0 = rng.normal(0.0, 0.5, (L, B, D)).astype(np.float32)
    tails = rng.normal(size=(L, B, D)).astype(np.float32)
    return params, ln, x, c0, tails


def _run_jax(cell, params, ln, x, c0, tails):
    p = jax.tree_util.tree_map(jnp.asarray, params)
    if cell == "sru":
        y, c = jstacked.fused_sru_stack(p, jnp.asarray(ln), jnp.asarray(x), jnp.asarray(c0),
                                        block_t=BLOCK_T)
        return np.asarray(y), np.asarray(c), None
    y, c, tl = jstacked.fused_qrnn_stack(
        p, jnp.asarray(ln), jnp.asarray(x), jnp.asarray(tails), jnp.asarray(c0), block_t=BLOCK_T
    )
    return np.asarray(y), np.asarray(c), np.asarray(tl)


def _run_port(cell, params, ln, x, c0, tails):
    p = params_from_numpy(params, device="cpu")
    if cell == "sru":
        y, c = tstacked.fused_sru_stack(p, torch.tensor(ln), torch.tensor(x), torch.tensor(c0),
                                        block_t=BLOCK_T)
        return y, c, None
    return tstacked.fused_qrnn_stack(
        p, torch.tensor(ln), torch.tensor(x), torch.tensor(tails), torch.tensor(c0),
        block_t=BLOCK_T,
    )


@pytest.mark.parametrize("L", [1, 2, 4])
@pytest.mark.parametrize("cell", ["sru", "qrnn"])
def test_stack_matches_jax(cell, L):
    inputs = _inputs(10 * L + (cell == "qrnn"), cell, L)
    want = _run_jax(cell, *inputs)
    got = _run_port(cell, *inputs)
    for name, g, w in zip(("y", "c_last", "tails_last"), got, want):
        if w is None:
            assert g is None, name
            continue
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, atol=STACK_TOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("cell", ["sru", "qrnn"])
def test_stack_streaming_equals_one_shot(cell):
    params, ln, x, c0, tails = _inputs(99, cell, 2)
    cut = 5
    one = _run_port(cell, params, ln, x, c0, tails)
    first = _run_port(cell, params, ln, x[:cut], c0, tails)
    tails_mid = tails if first[2] is None else first[2].numpy()
    second = _run_port(cell, params, ln, x[cut:], first[1].numpy(), tails_mid)
    np.testing.assert_allclose(
        torch.cat([first[0], second[0]]).numpy(), one[0].numpy(), atol=STACK_TOL, rtol=0
    )
    np.testing.assert_allclose(second[1].numpy(), one[1].numpy(), atol=STACK_TOL, rtol=0)
    if cell == "qrnn":
        np.testing.assert_allclose(second[2].numpy(), one[2].numpy(), atol=STACK_TOL, rtol=0)
