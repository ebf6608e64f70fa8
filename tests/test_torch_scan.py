"""The port's linear recurrence (``repro_torch.core.scan`` and the B3 kernel
package ``repro_torch.kernels.linear_scan``) against the JAX package's, on
the same numpy inputs.

JAX runs B3 as its own tests do: ``repro.kernels.linear_scan.ops`` in
Pallas interpret mode on the CPU, under both in-kernel schedules, and
``linear_scan_ref``. On the CPU the port's kernel wrapper runs its plain
version (``ref.py``); ``chip_smoke.py`` holds the CUDA kernel to that plain
version on the card. Tolerances are the JAX package's own: 1e-5 (fp32) and
3e-2 (bf16) for the kernel (``tests/test_kernels.py``), 2e-5 for the engines
(``tests/test_scan_engines.py``), 5e-4 for gradients (``tests/test_mts.py``).
"""
from __future__ import annotations

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import scan as jscan
from repro.kernels.linear_scan.ops import linear_scan as jax_linear_scan_kernel
from repro.kernels.linear_scan.ref import linear_scan_ref as jax_linear_scan_ref
from repro_torch.core import scan
from repro_torch.kernels.linear_scan import linear_scan as ls_kernel
from repro_torch.kernels.linear_scan import ops
from repro_torch.kernels.linear_scan.ref import linear_scan_ref

KERNEL_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
ENGINE_TOL = 2e-5
GRAD_TOL = 5e-4
ENGINES = ("sequential", "chunked", "associative", "pallas")


def _data(shape, seed):
    """a = sigmoid(normal), b = normal, c0 = normal, as the JAX tests draw them."""
    rng = np.random.default_rng(seed)
    a = (1.0 / (1.0 + np.exp(-rng.normal(size=shape)))).astype(np.float32)
    b = rng.normal(size=shape).astype(np.float32)
    c0 = rng.normal(size=shape[1:]).astype(np.float32)
    return a, b, c0


def _both(arrs, dtype):
    """The same values for JAX and the port (bf16 rounded from fp32 on both
    sides, round-to-nearest-even, so the inputs agree bit for bit)."""
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return ([jnp.asarray(x).astype(jdt) for x in arrs],
            [torch.tensor(x).to(tdt) for x in arrs])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("T,F", [(32, 128), (128, 128), (256, 64), (96, 200), (64, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("schedule", ["sequential", "hillis_steele"])
def test_kernel_plain_and_ops_match_jax(T, F, dtype, schedule):
    (ja, jb, jc), (ta, tb, tc) = _both(_data((T, F), T * 1000 + F), dtype)
    tol = KERNEL_TOL[dtype]
    j_kernel = jax_linear_scan_kernel(ja, jb, jc, block_size=32, schedule=schedule)
    j_ref = jax_linear_scan_ref(ja, jb, jc)
    plain = linear_scan_ref(ta, tb, tc)
    out = ops.linear_scan(ta, tb, tc, block_size=32)
    assert out.dtype == tb.dtype and out.shape == (T, F)
    np.testing.assert_allclose(_np(out), _np(j_kernel), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(plain), _np(j_ref), rtol=tol, atol=tol)
    # On the CPU the wrapper IS the plain version: bitwise.
    assert torch.equal(out, plain)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ops_trailing_dims_not_a_lane_multiple(dtype):
    """(T, B, H) with B * H = 48: JAX pads F to 128 lanes, the port does not."""
    (ja, jb, jc), (ta, tb, tc) = _both(_data((40, 4, 12), 5), dtype)
    out = ops.linear_scan(ta, tb, tc)
    assert out.shape == (40, 4, 12)
    j = jax_linear_scan_kernel(ja, jb, jc, block_size=16)
    tol = KERNEL_TOL[dtype]
    np.testing.assert_allclose(_np(out), _np(j), rtol=tol, atol=tol)


def test_block_size_changes_no_value():
    _, (ta, tb, tc) = _both(_data((128, 96), 3), "float32")
    ref = ops.linear_scan(ta, tb, tc)
    for bt in (8, 16, 64, 128):
        assert torch.equal(ops.linear_scan(ta, tb, tc, block_size=bt), ref)


def test_wrapper_launches_or_raises_off_the_cpu():
    """Off the CPU the wrapper launches the CUDA kernel or raises; it never
    falls back to the plain version."""
    a = torch.zeros((4, 8), device="meta")
    before = ls_kernel.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensors"):
        ls_kernel.linear_scan_kernel(a, a, torch.zeros((8,), device="meta"))
    assert ls_kernel.LAUNCHES == before


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("T,F", [(64, 24), (48, 7), (37, 5), (1, 16)])
def test_engine_matches_jax(engine, T, F):
    a, b, c0 = _data((T, F), T + F)
    jout = jscan.linear_scan(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c0),
                             engine=engine, block_size=16)
    out = scan.linear_scan(torch.tensor(a), torch.tensor(b), torch.tensor(c0),
                           engine=engine, block_size=16)
    assert out.dtype == torch.float32 and out.shape == (T, F)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=ENGINE_TOL, atol=ENGINE_TOL)


@pytest.mark.parametrize("T,block,shrunk", [(48, 20, 16), (37, 16, 1), (60, 32, 30)])
def test_chunked_shrinks_block_loudly_as_jax(T, block, shrunk, caplog):
    a, b, c0 = _data((T, 6), T)
    with caplog.at_level(logging.WARNING, logger="repro_torch.core.scan"):
        out = scan.linear_scan(torch.tensor(a), torch.tensor(b), torch.tensor(c0),
                               engine="chunked", block_size=block)
    assert f"shrunk to largest divisor {shrunk}" in caplog.text
    jout = jscan.linear_scan_chunked(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c0),
                                     block_size=shrunk)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=ENGINE_TOL, atol=ENGINE_TOL)
    mine = scan.linear_scan_chunked(torch.tensor(a), torch.tensor(b), torch.tensor(c0),
                                    block_size=shrunk)
    assert torch.equal(out, mine)


def test_chunked_clamp_to_short_sequence_is_quiet(caplog):
    a, b, c0 = _data((1, 8), 0)
    with caplog.at_level(logging.WARNING, logger="repro_torch.core.scan"):
        scan.linear_scan(torch.tensor(a), torch.tensor(b), torch.tensor(c0),
                         engine="chunked", block_size=32)
    assert "shrunk" not in caplog.text


def test_plain_engines_compute_in_the_input_dtype():
    """The plain engines carry in the input dtype (JAX's XLA engines do);
    only the kernel carries in fp32."""
    _, (ta, tb, tc) = _both(_data((33, 10), 9), "bfloat16")
    (ja, jb, jc), _ = _both(_data((33, 10), 9), "bfloat16")
    for engine in ("sequential", "associative", "chunked"):
        out = scan.linear_scan(ta, tb, tc, engine=engine, block_size=11)
        assert out.dtype == torch.bfloat16
        jout = jscan.linear_scan(ja, jb, jc, engine=engine, block_size=11)
        np.testing.assert_allclose(_np(out), _np(jout), rtol=3e-2, atol=3e-2)
    seq = scan.linear_scan(ta, tb, tc, engine="sequential")
    assert not torch.equal(seq, ops.linear_scan(ta, tb, tc))


def test_inclusive_prefix_semantics():
    # c_1 must already include a_1*c0 + b_1 (off-by-one guard)
    a = torch.tensor([[0.5], [0.5]])
    b = torch.tensor([[1.0], [1.0]])
    c0 = torch.tensor([2.0])
    for eng in ENGINES:
        out = scan.linear_scan(a, b, c0, engine=eng, block_size=1)
        assert out[:, 0].tolist() == [2.0, 2.0]


def test_unknown_engine_raises():
    with pytest.raises(ValueError, match="unknown engine"):
        scan.linear_scan(torch.ones(2, 2), torch.ones(2, 2), engine="bogus")


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("shape", [(64, 24), (30, 3, 4)])
def test_engine_grads_match_jax(engine, shape):
    a, b, c0 = _data(shape, 17)

    def jloss(a, b, c0):
        return jnp.sum(jscan.linear_scan(a, b, c0, engine=engine, block_size=16) ** 2)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c0))
    ta, tb, tc = (torch.tensor(x, requires_grad=True) for x in (a, b, c0))
    loss = torch.sum(scan.linear_scan(ta, tb, tc, engine=engine, block_size=16) ** 2)
    loss.backward()
    for t, j in zip((ta, tb, tc), jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), rtol=GRAD_TOL, atol=GRAD_TOL)


def test_ops_backward_is_the_reverse_time_kernel():
    """The VJP runs the same kernel on flipped operands: one more plain-scan
    call on the CPU, and the same gradients as autograd through the plain
    version itself."""
    a, b, c0 = _data((25, 9), 2)
    g = np.random.default_rng(1).normal(size=(25, 9)).astype(np.float32)
    grads = []
    for fn in (ops.linear_scan, linear_scan_ref):
        ta, tb, tc = (torch.tensor(x, requires_grad=True) for x in (a, b, c0))
        (fn(ta, tb, tc) * torch.tensor(g)).sum().backward()
        grads.append([t.grad for t in (ta, tb, tc)])
    for mine, ref in zip(*grads):
        torch.testing.assert_close(mine, ref, rtol=1e-6, atol=1e-6)
