"""The bf16 tensor-core body of the fused SRU/QRNN kernel, checked on the CPU.

Its arithmetic, emulated in PyTorch at full width (H = 1024, B = 4, T = 64
and T = 1, L = 2): bf16 input times the bf16 slab (an int8 slab widened to
bf16, exactly), fp32 sums taken per CTA of the cluster over its K range and
then added, the int8 scale after the whole sum, before the bias; in stack
mode u = rmsnorm(x) * g in fp32, split as u_hi + u_lo, two bf16 products
into one fp32 sum. It is held to the JAX package's oracles
(``repro.kernels.fused_rnn.ref``: ``fused_rnn_ref``, ``fused_rnn_stack_ref``
and their int8 twins) on the same numpy inputs, within ``chip_smoke``'s
``ATOL``; u_hi alone is not enough at this width.

The widening of int8 to bf16 is exact for every value, by the kernel's
formula. And the pure ``plan`` that sizes each launch: every hidden lane
in exactly one CTA's epilogue, the K split covering the padded contraction,
shared memory within the card's 227 KB for every served shape, and the
grid at H = 1024.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_rnn import ref as jref
from repro_torch.kernels.fused_rnn import fused_rnn, layout
from repro_torch.kernels.fused_rnn.ref import _scan

ATOL = 5e-4  # chip_smoke.ATOL: the kernel against its plain version on the card
H, B, L = 1024, 4, 2
CLUSTER = 2  # the bf16 plan's cluster at H = 1024 on the H100


def _bf16(a):
    """fp32 numpy values that bf16 holds exactly (the kernels' bf16 operands)."""
    return torch.tensor(a).to(torch.bfloat16).float().numpy()


def _split(u):
    hi = u.to(torch.bfloat16).float()
    return hi, (u - hi).to(torch.bfloat16).float()


def _gemm(uu, w, scale=None, *, split, lo=True):
    """The kernel's gate GEMM: uu (T, B, K) fp32, w (K, G, H) whose values
    are bf16-exact (an int8 slab's are). Each CTA of the cluster sums its K
    range in fp32 (hi and lo products into one sum), the cluster adds the
    CTAs' sums in rank order, then the scale."""
    parts = _split(uu) if split else (uu,)
    if not lo:
        parts = parts[:1]
    w = w.float()
    kc = -(-uu.shape[-1] // CLUSTER)
    z = 0.0
    for r in range(CLUSTER):
        ks = slice(r * kc, (r + 1) * kc)
        z = z + sum(torch.einsum("tbk,kgh->tbgh", p[..., ks], w[ks]) for p in parts)
    if scale is not None:
        z = z * scale
    return z


def _emulate_layer(u, w3, s3, b3, wskip, c0, mode):
    """One layer: bf16 u, slab w3 (K, 3, H) [+ the skip column of sru_proj]."""
    w = w3.float() if wskip is None else torch.cat([w3.float(), wskip.float()[:, None]], 1)
    z = _gemm(u, w, split=False)
    zg = z[..., :3, :] * (1.0 if s3 is None else s3) + b3
    x_hat = torch.tanh(zg[..., 0, :]) if mode == "qrnn" else zg[..., 0, :]
    skip = {"sru_identity": u, "sru_proj": z[..., 3, :] if wskip is not None else None}
    h, c = _scan(x_hat, torch.sigmoid(zg[..., 1, :]), torch.sigmoid(zg[..., 2, :]),
                 skip.get(mode), c0)
    return h, c


def _emulate_stack(x, w3L, sL, b3L, lnL, c0L, tailsL, cell, lo=True):
    """The stack: per layer the pre-norm in fp32, the split GEMM, the
    recurrence and x += h, on an fp32 residual stream."""
    qrnn = cell == "qrnn"
    c_lasts, tails = [], []
    for layer in range(w3L.shape[0]):
        u = x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + 1e-6) * lnL[layer]
        uu = u
        if qrnn:
            tails.append(u[-1])
            uu = torch.cat([u, torch.cat([tailsL[layer][None], u[:-1]], 0)], -1)
        w = w3L[layer].reshape(-1, 3, w3L.shape[-1])
        z = _gemm(uu, w, None if sL is None else sL[layer], split=True, lo=lo) + b3L[layer]
        x_hat = torch.tanh(z[..., 0, :]) if qrnn else z[..., 0, :]
        h, c = _scan(x_hat, torch.sigmoid(z[..., 1, :]), torch.sigmoid(z[..., 2, :]),
                     None if qrnn else u, c0L[layer])
        c_lasts.append(c)
        x = x + h
    return x, torch.stack(c_lasts), torch.stack(tails) if qrnn else None


def _slab(rng, shape, int8):
    """A bf16-exact fp32 slab, or an int8 one with its per-lane scales
    (JAX's expanded (..., 3, H) operand)."""
    w = (rng.uniform(-1.0, 1.0, shape) / np.sqrt(shape[-3])).astype(np.float32)
    if not int8:
        return _bf16(w), None
    wq, scale = layout.quantize_slabs(torch.tensor(w))
    return wq.numpy(), layout.expand_scales(scale, shape[-1]).numpy()


def _max_err(got, want):
    return max(float(np.max(np.abs(g.numpy() - np.asarray(w)))) for g, w in zip(got, want))


@pytest.mark.parametrize("int8", [False, True], ids=["bf16_slab", "int8_slab"])
@pytest.mark.parametrize("T", [64, 1])
@pytest.mark.parametrize("mode", ["sru_identity", "qrnn", "sru_proj"])
def test_layer_precision_scheme_matches_jax(mode, T, int8):
    rng = np.random.default_rng(T + 3 * int8 + 7 * ["sru_identity", "qrnn", "sru_proj"].index(mode))
    d = 512 if mode == "sru_proj" else H
    K = 2 * d if mode == "qrnn" else d
    w3, s3 = _slab(rng, (K, 3, H), int8)
    u = _bf16(rng.normal(size=(T, B, d)).astype(np.float32))
    b3 = _bf16(rng.normal(0.0, 0.5, (3, H)).astype(np.float32))
    c0 = _bf16(rng.normal(0.0, 0.5, (B, H)).astype(np.float32))
    wskip = _bf16(rng.uniform(-1, 1, (d, H)).astype(np.float32) / np.sqrt(d)) \
        if mode == "sru_proj" else None
    uu = u
    if mode == "qrnn":  # the shifted-input operand, as the kernel builds it
        tail = _bf16(rng.normal(size=(1, B, d)).astype(np.float32))
        uu = np.concatenate([u, np.concatenate([tail, u[:-1]], 0)], -1)
    j = [jnp.asarray(a) if a is not None else None for a in (uu, w3, s3, b3, wskip, c0)]
    if int8:
        want = jref.fused_rnn_ref_q(j[0], j[1], j[2], j[3], j[4], j[5], mode=mode)
    else:
        want = jref.fused_rnn_ref(j[0], j[1], j[3], j[4], j[5], mode=mode)
    t = [torch.tensor(a) if a is not None else None for a in (uu, w3, s3, b3, wskip, c0)]
    got = _emulate_layer(t[0], t[1], t[2], t[3], t[4], t[5], mode)
    assert _max_err(got, want) <= ATOL


def _stack_inputs(cell, T, int8, seed):
    rng = np.random.default_rng(seed)
    K = 2 if cell == "qrnn" else 1
    w3L, sL = _slab(rng, (L, K * H, 3, H), int8)
    w3L = w3L.reshape(L, K, H, 3, H)
    x = _bf16(rng.normal(size=(T, B, H)).astype(np.float32))
    b3L = _bf16(rng.normal(0.0, 0.5, (L, 3, H)).astype(np.float32))
    lnL = _bf16((1.0 + 0.2 * rng.uniform(-1, 1, (L, H))).astype(np.float32))
    c0L = _bf16(rng.normal(0.0, 0.5, (L, B, H)).astype(np.float32))
    tailsL = _bf16(rng.normal(size=(L, B, H)).astype(np.float32))
    return x, w3L, sL, b3L, lnL, c0L, tailsL


def _jax_stack(cell, int8, x, w3L, sL, b3L, lnL, c0L, tailsL):
    j = [jnp.asarray(a) if a is not None else None for a in (x, w3L, sL, b3L, lnL, c0L, tailsL)]
    if int8:
        out = jref.fused_rnn_stack_ref_q(j[0], j[1], j[2], j[3], j[4], j[5], j[6], cell=cell)
    else:
        out = jref.fused_rnn_stack_ref(j[0], j[1], j[3], j[4], j[5], j[6], cell=cell)
    return out if cell == "qrnn" else out[:2]


@pytest.mark.parametrize("int8", [False, True], ids=["bf16_slab", "int8_slab"])
@pytest.mark.parametrize("T", [64, 1])
@pytest.mark.parametrize("cell", ["sru", "qrnn"])
def test_stack_precision_scheme_matches_jax(cell, T, int8):
    inputs = _stack_inputs(cell, T, int8, seed=100 + T + 3 * int8 + 7 * (cell == "qrnn"))
    want = _jax_stack(cell, int8, *inputs)
    x, w3L, sL, b3L, lnL, c0L, tailsL = (torch.tensor(a) if a is not None else None
                                         for a in inputs)
    got = _emulate_stack(x, w3L, sL, b3L, lnL, c0L, tailsL, cell)
    assert _max_err([g for g in got if g is not None], want) <= ATOL


def test_stack_needs_the_lo_term():
    """With u_hi alone (u rounded to bf16) the stack leaves the tolerance at
    this width: the lo product is what holds it."""
    inputs = _stack_inputs("qrnn", 64, False, seed=5)
    want = _jax_stack("qrnn", False, *inputs)
    x, w3L, sL, b3L, lnL, c0L, tailsL = (torch.tensor(a) if a is not None else None
                                         for a in inputs)
    got = _emulate_stack(x, w3L, sL, b3L, lnL, c0L, tailsL, "qrnn", lo=False)
    assert _max_err(got, want) > ATOL


def test_int8_widens_to_bf16_exactly():
    """Every int8 value survives bf16, and the kernel's formula (2^23 + q + 128
    as fp32 bits, less 2^23 + 128) gives it back."""
    q = np.arange(-128, 128, dtype=np.int32)
    assert np.array_equal(torch.tensor(q).to(torch.int8).to(torch.bfloat16).float().numpy(), q)
    biased = (q.astype(np.uint32) ^ 0x80) & 0xFF
    widened = (biased | 0x4B000000).view(np.float32) - np.float32(8388736.0)
    assert np.array_equal(widened, q.astype(np.float32))
    assert np.array_equal(_bf16(widened), q.astype(np.float32))


# Every served shape of the bf16 body: the paper configs' widths (512,
# 1024), each mode and slab type, and a ragged width. (d, H, ng, stack, taps).
SHAPES = {
    "sru": (1024, 1024, 3, False, 1), "qrnn": (1024, 1024, 3, False, 2),
    "sru_proj": (512, 1024, 4, False, 1), "sru_stack": (1024, 1024, 3, True, 1),
    "qrnn_stack": (1024, 1024, 3, True, 2), "qrnn_ragged": (1000, 1000, 3, False, 2),
    "qrnn_stack_ragged": (1000, 1000, 3, True, 2), "sru_small": (512, 512, 3, False, 1),
    "qrnn_stack_small": (512, 512, 3, True, 2), "sru_proj_ragged": (200, 136, 4, False, 1),
}
TB = [(64, 4), (1, 4), (13, 3), (1, 1), (3, 128)]


def _plans():
    for name, (d, h, ng, stack, taps) in sorted(SHAPES.items()):
        for T, b in TB:
            for int8 in (False, True):
                kw = {"int8": int8, "ng": ng, "stack": stack, "taps": taps, "block_t": 32}
                yield name, T, b, d, h, kw, fused_rnn.plan(T, b, d, h, **kw)


def test_plan_covers_every_lane_once():
    for name, T, b, d, h, kw, p in _plans():
        blocks, ne = p.grid // p.cluster, p.lanes // p.cluster
        assert blocks == -(-h // p.lanes) and ne * p.cluster == p.lanes, name
        lanes = [blk * p.lanes + r * ne + q for blk in range(blocks)
                 for r in range(p.cluster) for q in range(ne)]
        lanes = [lane for lane in lanes if lane < h]
        assert sorted(lanes) == list(range(h)), (name, T, b)


def test_plan_splits_the_contraction_exactly():
    for name, T, b, d, h, kw, p in _plans():
        kp = kw["taps"] * (-(-d // fused_rnn.BOX_K) * fused_rnn.BOX_K)
        ranges = [(min(kp, r * p.k_per_cta), min(kp, (r + 1) * p.k_per_cta))
                  for r in range(p.cluster)]  # a rank past kp has none
        assert p.k_per_cta % fused_rnn.BOX_K == 0 and p.k_tile % 16 == 0, name
        assert sum(hi - lo for lo, hi in ranges) == kp >= kw["taps"] * d, name
        assert ranges[0][0] == 0 and all(a[1] == b_[0] for a, b_ in zip(ranges, ranges[1:]))


def test_plan_fits_shared_memory():
    for name, T, b, d, h, kw, p in _plans():
        assert p.smem_bytes <= fused_rnn.SMEM_MAX, (name, T, b, kw, p)
        assert p.rows == min(T, 32, 128 // b) * b
        assert p.rows * (p.k_tile // 8) <= fused_rnn.THREADS * fused_rnn.MAX_SEG


@pytest.mark.parametrize("int8", [False, True], ids=["bf16_slab", "int8_slab"])
@pytest.mark.parametrize("case", ["sru", "qrnn", "sru_stack", "qrnn_stack"])
def test_plan_fills_the_card_at_width_1024(case, int8):
    """At H = 1024 the grid is 128 CTAs, every cluster resident at once, on
    a card that holds n_sm // size clusters of each size; on one that holds
    fewer clusters of 4 (the H100's GPCs: 132, 66, 30 and 15 clusters of
    1, 2, 4 and 8 at one CTA per SM, as ``cluster_slots`` read them on
    the card), int8 takes clusters of 2."""
    d, h, ng, stack, taps = SHAPES[case]
    kw = {"int8": int8, "ng": ng, "stack": stack, "taps": taps}
    for T in (64, 1):
        p = fused_rnn.plan(T, 4, d, h, **kw)
        assert p.grid == 128 and p.cluster == (4 if int8 else 2), p
        fewer = fused_rnn.plan(T, 4, d, h, slots=(132, 66, 30, 15), **kw)
        assert fewer.cluster == 2 and fewer.grid == (64 if int8 else 128), fewer


def test_plan_refuses_a_slice_that_cannot_fit():
    with pytest.raises(ValueError, match="shared memory"):
        fused_rnn.plan(1, 4, 16384, 1024, taps=2)


# A model shard's B1 launches (distribution/fused_sharded.py): the layer's
# whole input width d against H / k lanes, k = 2, 4, 8 at width 1024, and
# the ragged H = 1000 over 8 (125 lanes, a last lane block of 13 or 29).
SHARD_SHAPES = {"Hl512": (1024, 512), "Hl256": (1024, 256), "Hl128": (1024, 128),
                "Hl125": (1000, 125)}


@pytest.mark.parametrize("shard", sorted(SHARD_SHAPES))
def test_plan_serves_the_shard_shapes(shard):
    """``plan`` gives a launch at every shard shape, bf16 and int8 slabs,
    SRU and QRNN, decode and prefill: every lane in one epilogue, the K
    split exact, shared memory within the card's 227 KB."""
    d, h = SHARD_SHAPES[shard]
    for T in (64, 1):
        for int8 in (False, True):
            for taps in (1, 2):
                kw = {"int8": int8, "ng": 3, "stack": False, "taps": taps}
                p = fused_rnn.plan(T, 4, d, h, **kw)
                assert p.smem_bytes <= fused_rnn.SMEM_MAX, (shard, T, kw, p)
                blocks, ne = p.grid // p.cluster, p.lanes // p.cluster
                assert blocks == -(-h // p.lanes) and ne * p.cluster == p.lanes
                lanes = sorted(blk * p.lanes + r * ne + q for blk in range(blocks)
                               for r in range(p.cluster) for q in range(ne)
                               if blk * p.lanes + r * ne + q < h)
                assert lanes == list(range(h)), (shard, T, kw)
                kp = taps * (-(-d // fused_rnn.BOX_K) * fused_rnn.BOX_K)
                assert p.k_per_cta * p.cluster >= kp and p.k_per_cta % fused_rnn.BOX_K == 0
