"""The port's linear recurrence (``repro_torch.core.scan`` and the B3 kernel
package ``repro_torch.kernels.linear_scan``) against the JAX package's, on
the same numpy inputs.

JAX runs B3 as its own tests do: ``repro.kernels.linear_scan.ops`` in
Pallas interpret mode on the CPU, under both in-kernel schedules, and
``linear_scan_ref``. On the CPU the port's kernel wrapper runs its plain
version (``ref.py``, with the kernel's chunk length); ``chip_smoke.py``
holds the CUDA kernels to that plain version on the card, bit for bit.
Tolerances are the JAX package's own: 1e-5 (fp32) and 3e-2 (bf16) for the
kernel (``tests/test_kernels.py``), 2e-5 for the engines
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
from repro_torch.kernels.linear_scan.ref import (
    CHUNK,
    chunk_len,
    linear_scan_bwd_ref,
    linear_scan_ref,
)

KERNEL_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
ENGINE_TOL = 2e-5
GRAD_TOL = 5e-4
ENGINES = ("sequential", "chunked", "associative", "pallas")


def _data(shape, seed, shift=0.0):
    """a = sigmoid(normal + shift), b = normal, c0 = normal, as the JAX tests
    draw them (shift 0). ``shift=3`` puts a near 0.95, so the carry reaches
    across chunks of 64 steps and the chunked arithmetic differs from the
    walk's; at shift 0 a chunk's product of a is about 1e-20 and the two
    agree bit for bit."""
    rng = np.random.default_rng(seed)
    a = (1.0 / (1.0 + np.exp(-rng.normal(size=shape) - shift))).astype(np.float32)
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
    # On the CPU the wrapper IS the plain version at the kernel's chunk: bitwise.
    assert torch.equal(out, linear_scan_ref(ta, tb, tc, chunk=chunk_len(T)))


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
    """Off the CPU the wrapper launches the CUDA kernel, takes its meta
    branch on meta tensors (a meta output, the call recorded, no launch) or
    raises; it never falls back to the plain version. The CUDA path's
    operand check refuses any tensor off the card."""
    from repro_torch.kernels.common import cuda_dtype_code, recorded_kernel_calls

    a = torch.zeros((4, 8), device="meta")
    before = ls_kernel.LAUNCHES
    with recorded_kernel_calls() as calls:
        c = ls_kernel.linear_scan_kernel(a, a, torch.zeros((8,), device="meta"))
    assert c.device.type == "meta" and [k["name"] for k in calls] == ["linear_scan"]
    assert ls_kernel.LAUNCHES == before
    for t in (a, torch.zeros(4, 8)):
        with pytest.raises(ValueError, match="CUDA tensors"):
            cuda_dtype_code(t)


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
    """The VJP (the reverse-time scan and its products, one backward call)
    gives the same gradients as autograd through the plain walk itself."""
    a, b, c0 = _data((25, 9), 2)
    g = np.random.default_rng(1).normal(size=(25, 9)).astype(np.float32)
    grads = []
    for fn in (ops.linear_scan, linear_scan_ref):
        ta, tb, tc = (torch.tensor(x, requires_grad=True) for x in (a, b, c0))
        (fn(ta, tb, tc) * torch.tensor(g)).sum().backward()
        grads.append([t.grad for t in (ta, tb, tc)])
    for mine, ref in zip(*grads):
        torch.testing.assert_close(mine, ref, rtol=1e-6, atol=1e-6)


# The chunked kernels (B3 redesigned): their plain versions against JAX.

CHUNK_T = (1, 13, 64, 1024, 4096)
CHUNK_F = (1, 7, 128, 1000)
# bf16 gradients: JAX's kernel and the port's carry in fp32 with their own
# rounding, so a stored bf16 cbar can round one ulp apart (2^-7 of the
# largest value), and the product taken of it rounds once more: two ulps.
BF16_GRAD_RTOL = 2.0 ** -6


@pytest.mark.parametrize("schedule", ["sequential", "hillis_steele"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("F", CHUNK_F)
@pytest.mark.parametrize("T", CHUNK_T)
def test_chunked_plain_matches_jax(T, F, dtype, schedule):
    """The chunk emulation and the walk against JAX's ``linear_scan_ref`` and
    its kernel in interpret mode, with a long memory (a near 0.95) so the
    fold across chunks carries weight."""
    (ja, jb, jc), (ta, tb, tc) = _both(_data((T, F), 7 * T + F, shift=3.0), dtype)
    tol = KERNEL_TOL[dtype]
    j_ref = _np(jax_linear_scan_ref(ja, jb, jc))
    j_kernel = _np(jax_linear_scan_kernel(ja, jb, jc, block_size=512, schedule=schedule))
    for chunk in (None, chunk_len(T)):
        out = linear_scan_ref(ta, tb, tc, chunk=chunk)
        assert out.dtype == tb.dtype and out.shape == (T, F)
        np.testing.assert_allclose(_np(out), j_ref, rtol=tol, atol=tol)
        np.testing.assert_allclose(_np(out), j_kernel, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,F", [(1, 7), (13, 7), (64, 128), (65, 3), (1024, 128), (4096, 7)])
def test_bwd_ref_matches_jax_vjp(T, F, dtype):
    """The fused backward's plain version, walked and chunked, against the
    VJP of JAX's kernel (interpret mode) at one cotangent."""
    a, b, c0 = _data((T, F), 11 * T + F, shift=3.0)
    g = np.random.default_rng(T).normal(size=(T, F)).astype(np.float32)
    (ja, jb, jc, jg), (ta, tb, tc, tg) = _both((a, b, c0, g), dtype)
    _, vjp = jax.vjp(lambda a, b, c0: jax_linear_scan_kernel(a, b, c0), ja, jb, jc)
    refs = [_np(x) for x in vjp(jg)]
    for chunk in (None, chunk_len(T)):
        c = linear_scan_ref(ta, tb, tc, chunk=chunk)
        grads = linear_scan_bwd_ref(ta, c, tc, tg, chunk=chunk)
        for mine, ref in zip(grads, refs):
            assert mine.dtype == tb.dtype
            tol = GRAD_TOL + (BF16_GRAD_RTOL * np.abs(ref).max() if dtype == "bfloat16" else 0.0)
            np.testing.assert_allclose(_np(mine), ref, rtol=GRAD_TOL, atol=tol)


@pytest.mark.parametrize("T,F", [(25, 9), (200, 9)])
def test_ops_backward_is_the_chunked_bwd_ref(T, F):
    """On the CPU the VJP of ``ops.linear_scan`` is ``linear_scan_bwd_ref`` at
    the kernel's chunk length, bit for bit, from the forward's own output."""
    a, b, c0 = _data((T, F), 4, shift=3.0)
    g = torch.tensor(np.random.default_rng(2).normal(size=(T, F)).astype(np.float32))
    ta, tb, tc = (torch.tensor(x, requires_grad=True) for x in (a, b, c0))
    out = ops.linear_scan(ta, tb, tc)
    out.backward(g)
    want = linear_scan_bwd_ref(ta.detach(), out.detach(), tc.detach(), g,
                               chunk=chunk_len(T))
    for t, w in zip((ta, tb, tc), want):
        assert torch.equal(t.grad, w)


def test_chunk_len_depends_on_t_alone():
    """64 steps a chunk at any T (T itself when shorter: one chunk); the
    plan of every F, dtype and alignment keeps it."""
    assert CHUNK == 64
    for T in (1, 13, 64, 65, 1024, 4096, 4097, 8193, 65536):
        assert chunk_len(T) == min(T, 64), T
        for dtype in (torch.float32, torch.bfloat16):
            for F in (1, 7, 128, 1000, 1024, 4096, 4097):
                for aligned4 in (True, False):
                    p = ls_kernel.plan(T, F, dtype, aligned4)
                    assert p.chunk == min(T, 64) and p.n_chunks == -(-T // 64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [13, 1024])
def test_column_slice_of_the_chunked_scan_is_bitwise(T, dtype):
    """Column f's result does not depend on the other columns: a slice of
    the emulated scan, and each lane of a (T, B, H) batch, equal the scan of
    that slice alone, bit for bit (the port's lane-of-B == B = 1)."""
    _, (ta, tb, tc) = _both(_data((T, 4 * 24), 3, shift=3.0), dtype)
    chunk = chunk_len(T)
    full = linear_scan_ref(ta, tb, tc, chunk=chunk)
    for cols in (slice(0, 1), slice(5, 12), slice(24, 48), slice(90, 96)):
        assert torch.equal(full[:, cols], linear_scan_ref(ta[:, cols], tb[:, cols], tc[cols],
                                                          chunk=chunk))
    batched = ops.linear_scan(ta.reshape(T, 4, 24), tb.reshape(T, 4, 24), tc.reshape(4, 24))
    for lane in range(4):
        one = ops.linear_scan(ta.reshape(T, 4, 24)[:, lane], tb.reshape(T, 4, 24)[:, lane],
                              tc.reshape(4, 24)[lane])
        assert torch.equal(batched[:, lane], one)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_scan_is_the_walk_within_one_chunk_only(dtype):
    """T <= chunk is the walk bit for bit (every decode step, a 64-token
    prompt); past one chunk the fold rounds otherwise than the walk, within
    the kernel tolerance of it."""
    for T in (1, 13, 64):
        _, (ta, tb, tc) = _both(_data((T, 50), T, shift=3.0), dtype)
        assert torch.equal(linear_scan_ref(ta, tb, tc, chunk=chunk_len(T)),
                           linear_scan_ref(ta, tb, tc))
    _, (ta, tb, tc) = _both(_data((1024, 200), 1, shift=3.0), dtype)
    chunked = linear_scan_ref(ta, tb, tc, chunk=chunk_len(1024))
    walk = linear_scan_ref(ta, tb, tc)
    assert not torch.equal(chunked, walk)
    tol = KERNEL_TOL[dtype]
    np.testing.assert_allclose(_np(chunked), _np(walk), rtol=tol, atol=tol)


def test_chunked_emulation_folds_in_fixed_order():
    """The emulation's carry into chunk k is c0 folded through A_j * c + B_j,
    j = 0 .. k-1, each rounded apart: rebuilt here from the chunks' own
    aggregates, the chunk's walk from that carry gives the emulation's bits."""
    T, F, chunk = 200, 5, 64
    _, (ta, tb, tc) = _both(_data((T, F), 8, shift=3.0), "float32")
    out = linear_scan_ref(ta, tb, tc, chunk=chunk)
    carry = tc.clone()
    for k in range(-(-T // chunk)):
        rows = slice(k * chunk, min(T, (k + 1) * chunk))
        assert torch.equal(out[rows], linear_scan_ref(ta[rows], tb[rows], carry))
        A, B = torch.ones(F), torch.zeros(F)
        for t in range(rows.start, rows.stop):
            A, B = A * ta[t], ta[t] * B + tb[t]
        carry = A * carry + B


def test_plan_columns_and_ctas():
    """Each thread copies and walks 4 bytes of columns (one fp32, a bf16
    pair: pointers 4-byte aligned, F even), else one bf16 column; one CTA
    per (chunk, 32-thread tile)."""
    p = ls_kernel.plan(64, 4096, torch.bfloat16)
    assert (p.chunk, p.n_chunks, p.vec_bytes, p.n_tiles, p.ctas) == (64, 1, 4, 64, 64)
    assert ls_kernel.plan(64, 1024, torch.bfloat16).ctas == 16
    assert ls_kernel.plan(64, 4097, torch.bfloat16).vec_bytes == 2
    assert ls_kernel.plan(64, 4096, torch.bfloat16, aligned4=False).vec_bytes == 2
    assert ls_kernel.plan(64, 4097, torch.float32, aligned4=False).vec_bytes == 4
    p = ls_kernel.plan(4096, 128, torch.float32)
    assert (p.n_chunks, p.n_tiles, p.ctas) == (64, 4, 256)
    p = ls_kernel.plan(1024, 4096, torch.bfloat16)
    assert (p.n_chunks, p.n_tiles, p.ctas) == (16, 64, 1024)
