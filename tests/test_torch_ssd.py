"""The port's chunked SSD (``repro_torch.core.ssd``, ``repro_torch.kernels.ssd``:
on the CPU the kernel's plain version) against the JAX package's
``core/ssd.py``, ``core/scan.py::matrix_linear_scan`` and ``kernels/ssd``
(the Pallas kernel in interpret mode, and ``ssd_ref``), on the same numpy
inputs.

Tolerances as ``tests/test_kernels.py``: 3e-5 in fp32, 5e-2 for a bf16 x
(both sides round the fp32 result to bf16 once). The CUDA kernel itself is
held to the plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``); here its precision scheme (bf16 tensor-core products
with the fp32 operand split hi + lo) is emulated in fp32 and held to JAX's
``ssd_ref`` at chip_smoke's B4 tolerance, and its host-side plan is checked.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import scan as jscan
from repro.core import ssd as jssd
from repro.kernels.ssd.ops import ssd as jax_ssd_kernel
from repro.kernels.ssd.ref import ssd_ref as jax_ssd_ref
from repro_torch.core import scan, ssd as core_ssd
from repro_torch.kernels.ssd import ssd as ssd_kernel
from repro_torch.kernels.ssd.ops import ssd
from repro_torch.kernels.ssd.ref import ssd_ref

TOL = 3e-5
BF16_TOL = 5e-2
B4_RTOL = 2e-5  # chip_smoke.py's B4 tolerance: of the largest magnitude, y and state each

# name -> (B, S, H, P, N, G, chunk): the four shapes of
# tests/test_kernels.py::test_ssd_kernel
KERNEL_SHAPES = {
    "g2_chunk16": (2, 64, 4, 8, 16, 2, 16),
    "g1_chunk32": (1, 128, 2, 16, 8, 1, 32),
    "g4_chunk8": (2, 32, 8, 4, 4, 4, 8),
    "g1_chunk64": (1, 64, 4, 32, 64, 1, 64),
}


def _inputs(B, S, H, P, N, G, seed, state=True):
    """x, dt, A, B_, C_, D, s0 as numpy fp32, drawn as test_kernels.py draws
    them (softplus dt, negative A, B/C scaled by 0.3)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((B, S, H, P)).astype(f)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(f)
    A = (-np.exp(rng.standard_normal(H))).astype(f)
    Bm = (rng.standard_normal((B, S, G, N)) * 0.3).astype(f)
    Cm = (rng.standard_normal((B, S, G, N)) * 0.3).astype(f)
    D = (rng.standard_normal(H) * 0.1).astype(f)
    s0 = (rng.standard_normal((B, H, N, P)) * 0.1).astype(f) if state else None
    return x, dt, A, Bm, Cm, D, s0


def _t(a):
    return None if a is None else torch.tensor(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol, err_msg=what)


@pytest.mark.parametrize("case", sorted(KERNEL_SHAPES))
def test_ssd_matches_jax_kernel_and_ref(case):
    B, S, H, P, N, G, chunk = KERNEL_SHAPES[case]
    x, dt, A, Bm, Cm, D, s0 = _inputs(B, S, H, P, N, G, sorted(KERNEL_SHAPES).index(case))
    y, st = ssd(*map(_t, (x, dt, A, Bm, Cm, D)), initial_state=_t(s0), chunk=chunk)
    jargs = tuple(map(_j, (x, dt, A, Bm, Cm, D)))
    jy, jst = jax_ssd_kernel(*jargs, initial_state=_j(s0), chunk=chunk)
    ry, rst = jax_ssd_ref(*jargs, chunk=chunk, initial_state=_j(s0))
    for want_y, want_st, what in ((jy, jst, "pallas"), (ry, rst, "ref")):
        _close(y, want_y, what=f"y vs {what}")
        _close(st, want_st, what=f"state vs {what}")
    assert y.dtype == torch.float32 and st.dtype == torch.float32


def test_ssd_bf16_x_matches_jax():
    """test_kernels.py::test_ssd_kernel_bf16: bf16 x, fp32 B/C, no D."""
    x, dt, A, Bm, Cm, _, _ = _inputs(1, 64, 2, 8, 16, 1, 11, state=False)
    xb = torch.tensor(x).to(torch.bfloat16)
    y, _ = ssd(xb, *map(_t, (dt, A, Bm, Cm)), None, chunk=16)
    assert y.dtype == torch.bfloat16
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    jargs = tuple(map(_j, (dt, A, Bm, Cm)))
    jy, _ = jax_ssd_kernel(jx, *jargs, None, chunk=16)
    ry, _ = jax_ssd_ref(jx, *jargs, None, chunk=16)
    _close(y, jy.astype(jnp.float32), BF16_TOL)
    _close(y, ry.astype(jnp.float32), BF16_TOL)


@pytest.mark.parametrize("G", [1, 2])
def test_ssd_one_step_matches_jax_decode_step(G):
    """S = 1 from a random state is JAX's ``ssd_decode_step``; the new state
    is written in place into the state buffer it started from."""
    B, H, P, N = 3, 4, 16, 8
    x, dt, A, Bm, Cm, D, s0 = _inputs(B, 1, H, P, N, G, 20 + G)
    jy, jst = jssd.ssd_decode_step(_j(s0), _j(x[:, 0]), _j(dt[:, 0]), _j(A), _j(Bm[:, 0]),
                                   _j(Cm[:, 0]), _j(D))
    state = _t(s0)
    ptr = state.data_ptr()
    y, st = ssd(*map(_t, (x, dt, A, Bm, Cm, D)), initial_state=state, chunk=1,
                state_out=state)
    assert st is state and state.data_ptr() == ptr
    _close(y[:, 0], jy)
    _close(state, jst)
    mine_y, mine_st = core_ssd.ssd_decode_step(_t(s0), *map(_t, (x[:, 0], dt[:, 0], A,
                                                                 Bm[:, 0], Cm[:, 0], D)))
    _close(mine_y, jy)
    _close(mine_st, jst)


def test_ssd_ragged_length_matches_stepwise_jax():
    """S = 20 is not a multiple of the chunk (16): the plain version shrinks
    its chunk to a divisor, as JAX's; both agree with the step-by-step
    recurrence of JAX's ``ssd_decode_step``."""
    B, S, H, P, N, G = 2, 20, 4, 8, 16, 2
    x, dt, A, Bm, Cm, D, s0 = _inputs(B, S, H, P, N, G, 30)
    y, st = ssd(*map(_t, (x, dt, A, Bm, Cm, D)), initial_state=_t(s0), chunk=16)
    ry, rst = jax_ssd_ref(*map(_j, (x, dt, A, Bm, Cm, D)), chunk=16, initial_state=_j(s0))
    _close(y, ry)
    _close(st, rst)
    state, ys = _j(s0), []
    for t in range(S):
        yt, state = jssd.ssd_decode_step(state, _j(x[:, t]), _j(dt[:, t]), _j(A),
                                         _j(Bm[:, t]), _j(Cm[:, t]), _j(D))
        ys.append(np.asarray(yt))
    _close(y, np.stack(ys, axis=1))
    _close(st, state)


def _refused():
    """name -> (operand overrides, message): each is refused on the CPU as on
    the card."""
    x, dt, A, Bm, Cm, D, s0 = map(_t, _inputs(1, 8, 4, 8, 16, 2, 40))
    base = dict(x=x, dt=dt, A=A, B_=Bm, C_=Cm, D=D, initial_state=s0)
    wide = _t(_inputs(1, 8, 4, 8, 160, 2, 41)[3])
    return base, {
        "x_fp16": (dict(x=x.half()), "x: float32 or bfloat16"),
        "x_3d": (dict(x=x[0]), r"x \(B, S, H, P\)"),
        "bc_dtypes_differ": (dict(C_=Cm.to(torch.bfloat16)), "one dtype"),
        "heads_not_grouped": (dict(B_=torch.cat([Bm, Bm[:, :, :1]], 2),
                                   C_=torch.cat([Cm, Cm[:, :, :1]], 2)), "do not group"),
        "state_too_large": (dict(B_=wide, C_=wide, initial_state=None), "at most 128"),
        "dt_shape": (dict(dt=dt[:, :4]), "dt: shape"),
        "A_shape": (dict(A=A[:2]), "A: shape"),
        "x_strided": (dict(x=x.transpose(2, 3).contiguous().transpose(2, 3)), "unit last"),
        "state_shape": (dict(initial_state=s0[:, :2]), "initial_state: shape"),
        "state_out_bf16": (dict(state_out=torch.zeros_like(s0, dtype=torch.bfloat16)),
                           "contiguous float32"),
    }


@pytest.mark.parametrize("case", sorted(_refused()[1]))
def test_ssd_refuses_what_the_kernel_does_not_take(case):
    base, cases = _refused()
    overrides, match = cases[case]
    kw = {**base, **overrides}
    with pytest.raises(ValueError, match=match):
        ssd(kw.pop("x"), kw.pop("dt"), kw.pop("A"), kw.pop("B_"), kw.pop("C_"), kw.pop("D"),
            **kw)


def test_ssd_refuses_a_partly_overlapping_state_out():
    x, dt, A, Bm, Cm, D, s0 = map(_t, _inputs(2, 8, 4, 8, 16, 2, 42))
    buf = torch.zeros((3,) + tuple(s0.shape[1:]))
    with pytest.raises(ValueError, match="overlaps"):
        ssd(x, dt, A, Bm, Cm, D, initial_state=buf[:2], state_out=buf[1:])


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never runs the plain version: CPU tensors raise."""
    x, dt, A, Bm, Cm, D, s0 = map(_t, _inputs(1, 8, 4, 8, 16, 2, 43))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_kernel.ssd_cuda(x, dt, A, Bm, Cm, D, s0, torch.empty_like(x), s0.clone())


@pytest.mark.parametrize("engine", ["sequential", "chunked", "associative"])
@pytest.mark.parametrize("S,chunk", [(64, 16), (48, 32)])
def test_ssd_chunked_engines_match_jax(engine, S, chunk):
    x, dt, A, Bm, Cm, D, s0 = _inputs(2, S, 4, 8, 16, 2, 50 + S)
    kw = dict(chunk=chunk, engine=engine, return_final_state=True)
    y, st = core_ssd.ssd_chunked(*map(_t, (x, dt, A, Bm, Cm, D)), initial_state=_t(s0), **kw)
    jy, jst = jssd.ssd_chunked(*map(_j, (x, dt, A, Bm, Cm, D)), initial_state=_j(s0), **kw)
    _close(y, jy)
    _close(st, jst)


def test_ssd_chunked_intra_bf16_matches_jax():
    """``intra_dtype=bf16``: the same roundings of the intra-chunk operands
    as JAX's, multiplied in fp32. The two sides can round a score to
    neighbouring bf16 values where their fp32 sums differ in the last bit,
    so the tolerance is a bf16 ulp of the output's scale (2^-8), far below
    the bf16-vs-fp32 difference it must show."""
    x, dt, A, Bm, Cm, _, _ = _inputs(2, 64, 4, 16, 16, 1, 60, state=False)
    y = core_ssd.ssd_chunked(*map(_t, (x, dt, A, Bm, Cm)), chunk=16,
                             intra_dtype=torch.bfloat16)
    jy = jssd.ssd_chunked(*map(_j, (x, dt, A, Bm, Cm)), chunk=16, intra_dtype=jnp.bfloat16)
    fp32 = jssd.ssd_chunked(*map(_j, (x, dt, A, Bm, Cm)), chunk=16)
    scale = float(np.abs(np.asarray(jy)).max())
    err = float(np.abs(y.numpy() - np.asarray(jy)).max())
    assert err <= 2.0 ** -8 * scale, (err, scale)
    assert float(np.abs(np.asarray(jy) - np.asarray(fp32)).max()) > 10 * err


def test_segsum_matches_jax():
    ld = -np.abs(np.random.default_rng(70).standard_normal((3, 2, 9))).astype(np.float32)
    got = core_ssd._segsum(torch.tensor(ld)).numpy()
    want = np.asarray(jssd._segsum(jnp.asarray(ld)))
    assert np.array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got[np.isfinite(got)], want[np.isfinite(want)], atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("engine", ["sequential", "chunked", "associative"])
@pytest.mark.parametrize("with_s0", [False, True], ids=["zero", "s0"])
def test_matrix_linear_scan_matches_jax(engine, with_s0):
    rng = np.random.default_rng(80)
    K, B, H, N, P = 7, 2, 3, 4, 5
    decay = np.exp(-np.abs(rng.standard_normal((K, B, H)))).astype(np.float32)
    dS = rng.standard_normal((K, B, H, N, P)).astype(np.float32)
    S0 = rng.standard_normal((B, H, N, P)).astype(np.float32) if with_s0 else None
    got = scan.matrix_linear_scan(_t(decay), _t(dS), _t(S0), engine=engine)
    want = jscan.matrix_linear_scan(_j(decay), _j(dS), _j(S0), engine=engine)
    assert tuple(got.shape) == dS.shape
    _close(got, want, 1e-5)


def test_ssd_ref_is_the_sequential_chunked_ssd():
    x, dt, A, Bm, Cm, D, s0 = map(_t, _inputs(1, 32, 4, 8, 16, 2, 90))
    y, st = ssd_ref(x, dt, A, Bm, Cm, D, chunk=8, initial_state=s0)
    y2, st2 = core_ssd.ssd_chunked(x, dt, A, Bm, Cm, D, chunk=8, initial_state=s0,
                                   engine="sequential", return_final_state=True)
    assert torch.equal(y, y2) and torch.equal(st, st2)


def _split(v: torch.Tensor, terms: int) -> torch.Tensor:
    """``v`` as the sum of its first ``terms`` bf16 terms (hi, lo, ...),
    in fp32: what the tensor cores multiply in its place."""
    out, rest = torch.zeros_like(v), v
    for _ in range(terms):
        t = rest.to(torch.bfloat16).float()
        out, rest = out + t, rest - t
    return out


def _emulate_mma_chunks(x, dt, A, Bm, Cm, D, terms, L=64):
    """The mma chunk kernel's arithmetic in fp32 on the CPU: 64-step chunks;
    C B^T of the exact bf16 C and B; the scores as tril(C B^T o
    exp(lambda_t - lambda_s)) o dt_s, split, times x (exact); C times the
    split state; the state update as B^T times the split (w o x), w_s =
    exp(lambda_T - lambda_s) dt_s. Products of split operands are exact in
    fp32 (a bf16 term times a bf16 value), so each product here is the fp32
    sum of the kernel's mma terms up to the order of the sums."""
    Bsz, S, H, P = x.shape
    rep = H // Bm.shape[2]
    state = torch.zeros(Bsz, H, Bm.shape[3], P)
    y = torch.empty(Bsz, S, H, P)
    for t0 in range(0, S, L):
        sl = slice(t0, min(S, t0 + L))
        xc, dc = x[:, sl], dt[:, sl]
        Bc, Cc = Bm[:, sl].repeat_interleave(rep, 2), Cm[:, sl].repeat_interleave(rep, 2)
        lam = torch.cumsum(A * dc, 1).permute(0, 2, 1)  # (B, H, t)
        nv = lam.shape[-1]
        cb = torch.einsum("bthn,bshn->bhts", Cc, Bc)
        mask = torch.tril(torch.ones(nv, nv, dtype=torch.bool))
        diff = lam[..., :, None] - lam[..., None, :]
        decay = torch.exp(torch.where(mask, diff, torch.full_like(diff, -torch.inf)))
        scores = cb * decay * dc.permute(0, 2, 1)[..., None, :]
        y1 = torch.einsum("bthn,bhnp->bthp", Cc, _split(state, terms))
        y2 = torch.einsum("bhts,bshp->bthp", _split(scores, terms), xc)
        y[:, sl] = y1 * torch.exp(lam).permute(0, 2, 1)[..., None] + y2 + D[:, None] * xc
        w = torch.exp(lam[..., -1:] - lam) * dc.permute(0, 2, 1)  # (B, H, s)
        wx = w.permute(0, 2, 1)[..., None] * xc
        state = (torch.exp(lam[..., -1])[..., None, None] * state
                 + torch.einsum("bshn,bshp->bhnp", Bc, _split(wx, terms)))
    return y, state


@pytest.mark.parametrize("terms,holds", [(2, True), (1, False)], ids=["hi_lo", "one_term"])
def test_mma_precision_scheme_against_jax_ref(terms, holds):
    """The kernel's split (two bf16 terms) holds B4_RTOL against JAX's
    ``ssd_ref`` at the prompt-1024 serve case with mamba2's decays (A = -1
    .. -16, dt about 0.01: the state carries over all 1024 steps); a single
    bf16 term of the same operands does not, which is why the split is
    there. x, B and C are bf16 values, as on the serve path."""
    rng = np.random.default_rng(18)
    B, S, H, P, N = 1, 1024, 4, 64, 128

    def bf16(a):
        return torch.tensor(a.astype(np.float32)).to(torch.bfloat16).float().numpy()

    x = bf16(rng.standard_normal((B, S, H, P)))
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)) * 0.5 - 4.6)).astype(np.float32)
    A = -np.linspace(1.0, 16.0, H).astype(np.float32)
    Bm, Cm = (bf16(rng.standard_normal((B, S, 1, N)) * 0.3) for _ in range(2))
    D = np.ones(H, np.float32)
    ry, rstate = (np.asarray(v) for v in jax_ssd_ref(*map(_j, (x, dt, A, Bm, Cm, D))))
    y, state = _emulate_mma_chunks(*map(_t, (x, dt, A, Bm, Cm, D)), terms)
    rel_y = np.abs(y.numpy() - ry).max() / np.abs(ry).max()
    rel_state = np.abs(state.numpy() - rstate).max() / np.abs(rstate).max()
    assert (max(rel_y, rel_state) <= B4_RTOL) == holds, (rel_y, rel_state)


def _plan_cover(batch, heads, groups, head_dim, hb, grid, p_slice):
    """(lane, head, column) -> times covered, the kernel's CTA mapping
    walked over ``grid``; asserts the heads of each CTA share a group."""
    rep = heads // groups
    blocks = -(-rep // hb)
    seen = {}
    for bx in range(grid[0]):
        for by in range(grid[1]):
            for bz in range(grid[2]):
                g = by // blocks
                h0 = g * rep + (by % blocks) * hb
                nh = min(hb, (g + 1) * rep - h0)
                assert nh >= 1 and {(h0 + i) // rep for i in range(nh)} == {g}
                for h in range(h0, h0 + nh):
                    for p in range(bx * p_slice, min(head_dim, (bx + 1) * p_slice)):
                        seen[(bz, h, p)] = seen.get((bz, h, p), 0) + 1
    return seen


@pytest.mark.parametrize("batch,heads,groups,head_dim,ctas_per_sm", [
    (4, 80, 1, 64, 1), (4, 80, 1, 64, 2), (2, 13, 1, 64, 1), (2, 14, 2, 64, 1),
    (2, 7, 7, 256, 1), (1, 1, 1, 8, 1), (3, 8, 4, 100, 1), (4, 80, 8, 64, 1)])
def test_chunk_plan_covers_every_head_and_column_once(batch, heads, groups, head_dim,
                                                       ctas_per_sm):
    hb, grid = ssd_kernel.chunk_plan(batch, heads, groups, head_dim, 132, ctas_per_sm, 5, 32)
    assert 1 <= hb <= 5 and (hb >= 2 or heads == groups)
    seen = _plan_cover(batch, heads, groups, head_dim, hb, grid, 32)
    assert set(seen.values()) == {1}
    assert len(seen) == batch * heads * head_dim


def test_chunk_plan_fills_one_round_at_the_mamba2_shape():
    """B = 4, H = 80, P = 64, G = 1 at one CTA per SM on 132 SMs: five heads
    per CTA and two P slices, 128 CTAs in one round (97% of the slots),
    where four heads would take two rounds and three 216 CTAs in two."""
    hb, grid = ssd_kernel.chunk_plan(4, 80, 1, 64, 132, 1, 5, 32)
    assert (hb, grid) == (5, (2, 16, 4))
    assert grid[0] * grid[1] * grid[2] == 128 <= 132
