"""The port's cells and MTS executor (``repro_torch.core.{cells,mts}``)
against the JAX package's (``repro.core.{cells,mts}``) on the same numpy
inputs and params, for every engine of ``core/scan.py``; then the paper's
invariants re-asserted inside the port (``tests/test_mts.py``): streaming in
blocks equals one-shot, the LSTM's precomputed ``W·x`` equals the naive
baseline.

Tolerances are the JAX package's own: 2e-5 for a layer, 3e-5 for streaming
against one-shot, 5e-4 for gradients. JAX's ``pallas`` engine runs its
Pallas kernel in interpret mode on the CPU; the port's runs the kernel's
plain version there.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cells as jcells
from repro.core import mts as jmts
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.core import cells, mts, scan

LAYER_TOL = 2e-5
STREAM_TOL = 3e-5
GRAD_TOL = 5e-4
ENGINES = ("sequential", "chunked", "associative", "pallas")
_JINIT = {"sru": jcells.sru_init, "qrnn": jcells.qrnn_init, "lstm": jcells.lstm_init}
_JFWD = {"sru": jmts.mts_sru, "qrnn": jmts.mts_qrnn}
_FWD = {"sru": mts.mts_sru, "qrnn": mts.mts_qrnn}


def _setup(cell, T=48, B=2, D=24, H=24, seed=0, bias=True):
    """JAX params (with non-zero biases, so the bias paths are exercised) as
    numpy, the port's copy of them, and an input (B, T, D)."""
    jp = jax.tree_util.tree_map(np.asarray, _JINIT[cell](jax.random.PRNGKey(seed), D, H))
    rng = np.random.default_rng(seed)
    if bias:
        jp["b"] = rng.normal(0.0, 0.5, jp["b"].shape).astype(np.float32)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    return jp, params_from_numpy(jp, device="cpu"), x


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)


def test_cells_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a CUDA device")
    for init in (cells.sru_init, cells.qrnn_init, cells.lstm_init):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init(torch.Generator().manual_seed(0), 8, 8)
        p = init(torch.Generator().manual_seed(0), 8, 8, device="cpu")
        assert all(v.device.type == "cpu" for v in p.values() if v is not None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mts.stream_init("qrnn", 2, 8, 8)


@pytest.mark.parametrize("cell,D,H", [("sru", 24, 24), ("sru", 16, 32), ("qrnn", 24, 40)])
def test_gates_match_jax(cell, D, H):
    jp, tp, x = _setup(cell, T=9, D=D, H=H)
    xt = np.swapaxes(x, 0, 1)
    if cell == "sru":
        for got, want in zip(cells.sru_gates(tp, torch.tensor(xt)),
                             jcells.sru_gates(_jax(jp), jnp.asarray(xt))):
            _close(got, want, LAYER_TOL)
        assert (tp["w_skip"] is None) == (D == H)
    else:
        tail = np.random.default_rng(1).normal(size=(1, 2, D)).astype(np.float32)
        for t_tail, j_tail in ((None, None), (torch.tensor(tail), jnp.asarray(tail))):
            for got, want in zip(cells.qrnn_gates(tp, torch.tensor(xt), t_tail),
                                 jcells.qrnn_gates(_jax(jp), jnp.asarray(xt), j_tail)):
                _close(got, want, LAYER_TOL)


def test_lstm_step_matches_jax():
    jp, tp, x = _setup("lstm", T=3, D=20, H=12)
    rng = np.random.default_rng(2)
    h, c = (rng.normal(size=(2, 12)).astype(np.float32) for _ in range(2))
    xp = cells.lstm_x_proj(tp, torch.tensor(x))
    _close(xp, jcells.lstm_x_proj(_jax(jp), jnp.asarray(x)), LAYER_TOL)
    got = cells.lstm_step(tp, xp[:, 0], torch.tensor(h), torch.tensor(c))
    want = jcells.lstm_step(_jax(jp), jcells.lstm_x_proj(_jax(jp), jnp.asarray(x))[:, 0],
                            jnp.asarray(h), jnp.asarray(c))
    for g, w in zip(got, want):
        _close(g, w, LAYER_TOL)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("cell,D,H", [("sru", 24, 24), ("sru", 16, 32), ("qrnn", 24, 24)])
def test_mts_layer_matches_jax(engine, cell, D, H):
    """One layer with a carried state (and a QRNN conv tail) on each engine;
    block 16 does not divide T = 40, so chunked shrinks it on both sides."""
    jp, tp, x = _setup(cell, T=40, D=D, H=H, seed=D + H)
    rng = np.random.default_rng(3)
    c0 = rng.normal(0.0, 0.5, (2, H)).astype(np.float32)
    args_j = [_jax(jp), jnp.asarray(x), jnp.asarray(c0)]
    args_t = [tp, torch.tensor(x), torch.tensor(c0)]
    if cell == "qrnn":
        tail = rng.normal(size=(2, 1, D)).astype(np.float32)
        args_j.append(jnp.asarray(tail))
        args_t.append(torch.tensor(tail))
    hj, cj = _JFWD[cell](*args_j, engine=engine, block_size=16)
    ht, ct = _FWD[cell](*args_t, engine=engine, block_size=16)
    assert ht.shape == (2, 40, H) and ct.shape == (2, H)
    _close(ht, hj, LAYER_TOL)
    _close(ct, cj, LAYER_TOL)


@pytest.mark.parametrize("precompute", [True, False])
def test_lstm_forward_matches_jax(precompute):
    jp, tp, x = _setup("lstm", T=17, D=20, H=12, seed=5)
    rng = np.random.default_rng(4)
    h0, c0 = (rng.normal(0.0, 0.5, (2, 12)).astype(np.float32) for _ in range(2))
    hj, cj = jmts.lstm_forward(_jax(jp), jnp.asarray(x), jnp.asarray(h0), jnp.asarray(c0),
                               precompute=precompute)
    ht, ct = mts.lstm_forward(tp, torch.tensor(x), torch.tensor(h0), torch.tensor(c0),
                              precompute=precompute)
    _close(ht, hj, LAYER_TOL)
    _close(ct, cj, LAYER_TOL)


def test_lstm_precompute_equals_naive():
    _, tp, x = _setup("lstm")
    h1, c1 = mts.lstm_forward(tp, torch.tensor(x), precompute=True)
    h2, c2 = mts.lstm_forward(tp, torch.tensor(x), precompute=False)
    torch.testing.assert_close(h1, h2, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(c1, c2, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("cell", ["sru", "qrnn"])
@pytest.mark.parametrize("n_blocks,block_len", [(3, 16), (5, 7), (1, 24)])
def test_streaming_equals_one_shot(engine, cell, n_blocks, block_len):
    """The paper's deployment: a live stream in blocks, carry (and QRNN conv
    tail) passed between them, against one-shot at JAX's tolerance. Not
    bitwise on the CPU even where the recurrence is (see the next test):
    PyTorch's vectorized sigmoid rounds a tensor's tail elements by another
    code path than its body, so a block's gates can differ from one-shot's
    in the last ulp."""
    T = n_blocks * block_len
    _, tp, x = _setup(cell, T=T, seed=T)
    x = torch.tensor(x)
    ref, c_ref = _FWD[cell](tp, x, engine=engine, block_size=16)
    st = mts.stream_init(cell, 2, 24, 24, device="cpu")
    outs = []
    for i in range(n_blocks):
        h, st = mts.mts_stream_step(cell, tp, st, x[:, i * block_len:(i + 1) * block_len],
                                    engine=engine, block_size=min(16, block_len))
        outs.append(h)
    torch.testing.assert_close(torch.cat(outs, dim=1), ref, rtol=STREAM_TOL, atol=STREAM_TOL)
    torch.testing.assert_close(st.c, c_ref, rtol=STREAM_TOL, atol=STREAM_TOL)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("n_blocks,block_len", [(3, 16), (5, 7), (4, 1)])
def test_recurrence_streaming_is_exact(engine, n_blocks, block_len):
    """The recurrence alone, streamed in blocks with its carry: sequential
    and pallas repeat one-shot's per-step arithmetic, so they are bitwise;
    chunked and associative associate the steps by block (JAX's 3e-5)."""
    rng = np.random.default_rng(n_blocks * block_len)
    a, b = (torch.tensor(rng.normal(size=(n_blocks * block_len, 2, 24)).astype(np.float32))
            for _ in range(2))
    a = torch.sigmoid(a)
    c0 = torch.tensor(rng.normal(size=(2, 24)).astype(np.float32))
    ref = scan.linear_scan(a, b, c0, engine=engine, block_size=16)
    c, outs = c0, []
    for i in range(n_blocks):
        blk = slice(i * block_len, (i + 1) * block_len)
        out = scan.linear_scan(a[blk], b[blk], c, engine=engine, block_size=min(16, block_len))
        c = out[-1]
        outs.append(out)
    out = torch.cat(outs)
    if engine in ("sequential", "pallas"):
        assert torch.equal(out, ref)
    else:
        torch.testing.assert_close(out, ref, rtol=STREAM_TOL, atol=STREAM_TOL)


def test_streaming_refuses_lstm():
    with pytest.raises(ValueError, match="input-gated"):
        mts.mts_stream_step("lstm", {}, mts.StreamState(torch.zeros(1), None), torch.zeros(1, 1, 1))


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("cell", ["sru", "qrnn"])
@pytest.mark.parametrize("H", [24, 128])
def test_grads_match_jax(engine, cell, H):
    """torch.autograd through each engine against jax.grad through JAX's same
    engine (``tests/test_mts.py``'s pallas case: B * H = 48 is not a lane
    multiple, block 16); grads of the params and of the input."""
    jp, tp, x = _setup(cell, T=32, D=H, H=H, seed=H)

    def jloss(p, x):
        h, c = _JFWD[cell](p, x, engine=engine, block_size=16)
        return jnp.sum(h ** 2) + jnp.sum(c)

    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(_jax(jp), jnp.asarray(x))
    leaves = {k: v.requires_grad_(True) for k, v in tp.items() if v is not None}
    xt = torch.tensor(x, requires_grad=True)
    h, c = _FWD[cell](tp, xt, engine=engine, block_size=16)
    (torch.sum(h ** 2) + torch.sum(c)).backward()
    for k, v in leaves.items():
        _close(v.grad, jg_p[k], GRAD_TOL)
    _close(xt.grad, jg_x, GRAD_TOL)


def test_int8_cells_refused_on_the_scan_engines():
    """``_require_fp``: int8 gate slabs dequantize inside the fused kernels
    only, so the scan engines refuse them, as in JAX."""
    q = {"wq": torch.zeros((8, 3, 8), dtype=torch.int8), "wq_scale": torch.ones((3, 1)),
         "b": torch.zeros((2, 8)), "w_skip": None}
    q0 = {"w0q": torch.zeros((8, 3, 8), dtype=torch.int8), "w1q": q["wq"],
          "wq_scale": torch.ones((3, 1)), "b": torch.zeros((3, 8))}
    for engine in ENGINES:
        with pytest.raises(ValueError, match="int8"):
            mts.mts_sru(q, torch.zeros((1, 2, 8)), engine=engine)
        with pytest.raises(ValueError, match="int8"):
            mts.mts_qrnn(q0, torch.zeros((1, 2, 8)), engine=engine)


def test_lstm_params_round_trip_through_the_bridge():
    jp, tp, _ = _setup("lstm", D=20, H=12)
    assert sorted(tp) == ["b", "uh", "wx"]
    back = params_to_numpy(tp)
    for k in jp:
        assert back[k].dtype == jp[k].dtype and np.array_equal(back[k], jp[k])
