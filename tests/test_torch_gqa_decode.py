"""The port's decode attention (``repro_torch.kernels.gqa_decode``: on the CPU
its plain version) against the JAX package's ``gqa_decode`` (the Pallas
kernel in interpret mode) and ``gqa_decode_ref``, on the same numpy inputs.

The cases include the head shapes of the repo's configs (groups up to 64,
head dims 16 to 192) and a head dim that is a multiple of 8 only (24).

Tolerances as ``tests/test_kernels.py``: 2e-5 in fp32, 3e-2 in bf16 (both
sides round the fp32 result to bf16 once, after different summation orders).
The CUDA kernel itself is held to the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gqa_decode import gqa_decode as jax_gqa_decode
from repro.kernels.gqa_decode.ref import gqa_decode_ref as jax_gqa_decode_ref
from repro_torch.kernels.gqa_decode import gqa_decode as gqa_kernel
from repro_torch.kernels.gqa_decode.ops import gqa_decode
from repro_torch.kernels.gqa_decode.ref import gqa_decode_ref

FP32_TOL = 2e-5
BF16_TOL = 3e-2

# name -> (B, Hq, Hkv, Dh, S, block_s, lengths or None for random in [1, S])
CASES = {
    # the four shapes of tests/test_kernels.py::test_gqa_decode_kernel
    "kernels_2x8x2x64": (2, 8, 2, 64, 256, 64, None),
    "kernels_mqa_g32": (1, 32, 1, 64, 512, 64, None),
    "kernels_g1_dh32": (3, 16, 16, 32, 128, 64, None),
    "kernels_dh128": (2, 12, 4, 128, 64, 64, None),
    # smollm's group of 3 and head dim 64, ragged lengths including 1
    "smollm_g3": (3, 15, 5, 64, 96, 32, (96, 1, 40)),
    # the reduced configs' head dim 16, ragged lengths including 1
    "reduced_dh16_ragged": (4, 8, 2, 16, 64, 16, (1, 5, 64, 33)),
    # the full-width head shapes of the repo's configs: granite-20b's group
    # of 48, zamba2-7b's head dim 112, nemotron-4-340b's group of 12 at head
    # dim 192; a head dim that is a multiple of 8 only, and a group of 64
    "wide_granite_g48_dh128": (2, 48, 1, 128, 64, 32, (64, 1)),
    "wide_zamba2_dh112": (2, 4, 4, 112, 48, 16, (1, 37)),
    "wide_nemotron_g12_dh192": (2, 12, 1, 192, 40, 16, (40, 1)),
    "wide_dh24_g3": (2, 6, 2, 24, 30, 16, (1, 29)),
    "wide_g64_dh16": (1, 64, 1, 16, 24, 8, (13,)),
}
WIDE = sorted(c for c in CASES if c.startswith("wide_"))


def _inputs(case, dtype=np.float32):
    B, Hq, Hkv, Dh, S, _, lengths = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    q = rng.standard_normal((B, Hq, Dh)).astype(dtype)
    k = rng.standard_normal((B, S, Hkv, Dh)).astype(dtype)
    v = rng.standard_normal((B, S, Hkv, Dh)).astype(dtype)
    if lengths is None:
        lens = rng.integers(1, S + 1, (B,)).astype(np.int32)
    else:
        lens = np.asarray(lengths, np.int32)
    return q, k, v, lens


def _port(q, k, v, lens, dtype=torch.float32):
    return gqa_decode(*(torch.tensor(a).to(dtype) for a in (q, k, v)),
                      torch.tensor(lens, dtype=torch.int32))


@pytest.mark.parametrize("case", sorted(CASES))
def test_gqa_decode_matches_jax_kernel_and_ref(case):
    q, k, v, lens = _inputs(case)
    block_s = CASES[case][5]
    out = _port(q, k, v, lens).numpy()
    jargs = [jnp.asarray(a) for a in (q, k, v, lens)]
    np.testing.assert_allclose(out, np.asarray(jax_gqa_decode(*jargs, block_s=block_s)),
                               rtol=FP32_TOL, atol=FP32_TOL)
    np.testing.assert_allclose(out, np.asarray(jax_gqa_decode_ref(*jargs)),
                               rtol=FP32_TOL, atol=FP32_TOL)


def test_gqa_decode_bf16_matches_jax():
    """``tests/test_kernels.py::test_gqa_decode_bf16``'s case: bf16 operands,
    every row valid."""
    B, Hq, Hkv, Dh, S = 2, 8, 4, 64, 256
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, Hq, Dh), (B, S, Hkv, Dh), (B, S, Hkv, Dh)))
    lens = np.full((B,), S, np.int32)
    out = _port(q, k, v, lens, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)] + [jnp.asarray(lens)]
    for ref in (jax_gqa_decode(*jargs, block_s=64), jax_gqa_decode_ref(*jargs)):
        np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                                   rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("case", WIDE)
def test_gqa_decode_wide_shapes_bf16_match_jax(case):
    """The wide head shapes in bf16: the port's bf16 result against JAX's
    kernel (interpret mode) and ref on the same bf16 operands."""
    q, k, v, lens = _inputs(case)
    block_s = CASES[case][5]
    out = _port(q, k, v, lens, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)] + [jnp.asarray(lens)]
    for ref in (jax_gqa_decode(*jargs, block_s=block_s), jax_gqa_decode_ref(*jargs)):
        np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                                   rtol=BF16_TOL, atol=BF16_TOL)


def test_gqa_decode_short_lengths_match_truncated_dense():
    """Masked rows do not leak: the result equals attention over the prefix
    (``tests/test_kernels.py``'s truncated-prefix case)."""
    B, Hq, Hkv, Dh, S, L = 1, 4, 2, 32, 128, 37
    rng = np.random.default_rng(12)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, Hq, Dh), (B, S, Hkv, Dh), (B, S, Hkv, Dh)))
    out = _port(q, k, v, np.array([L], np.int32)).numpy()
    jref = jax_gqa_decode_ref(jnp.asarray(q), jnp.asarray(k[:, :L]), jnp.asarray(v[:, :L]),
                              jnp.array([L]))
    np.testing.assert_allclose(out, np.asarray(jref), rtol=FP32_TOL, atol=FP32_TOL)
    prefix = _port(q, k[:, :L].copy(), v[:, :L].copy(), np.array([L], np.int32)).numpy()
    np.testing.assert_allclose(out, prefix, rtol=FP32_TOL, atol=FP32_TOL)


def test_gqa_decode_cpu_runs_the_plain_version():
    """On the CPU the wrapper runs the plain version and launches nothing."""
    q, k, v, lens = (torch.tensor(a) for a in _inputs("smollm_g3"))
    before = gqa_kernel.LAUNCHES
    assert torch.equal(gqa_decode(q, k, v, lens), gqa_decode_ref(q, k, v, lens))
    assert gqa_kernel.LAUNCHES == before


@pytest.mark.parametrize("bad,match", [
    ("dtype_float64", "float32 or bfloat16"),
    ("mixed_dtypes", "k: torch.bfloat16 on cpu, expected torch.float32"),
    ("heads_do_not_group", "do not group"),
    ("head_dim_44", "head dim 44 unsupported; the kernel takes a multiple of 8"),
    ("head_dim_264", "head dim 264 unsupported; .* up to 256"),
    ("lengths_int64", "lengths: torch.int64 on cpu, expected torch.int32"),
    ("lengths_shape", "lengths: shape"),
    ("k_not_contiguous", "k: not contiguous"),
    ("v_shape", "v: shape"),
])
def test_gqa_decode_refuses_operands(bad, match):
    q, k, v, lens = (torch.tensor(a) for a in _inputs("kernels_2x8x2x64"))
    if bad == "dtype_float64":
        q, k, v = q.double(), k.double(), v.double()
    elif bad == "mixed_dtypes":
        k = k.bfloat16()
    elif bad == "heads_do_not_group":
        q = torch.zeros((2, 7, 64))
    elif bad == "head_dim_44":
        q, k, v = q[..., :44].contiguous(), k[..., :44].contiguous(), v[..., :44].contiguous()
    elif bad == "head_dim_264":
        q, k, v = (torch.cat([t] * 5, dim=-1)[..., :264].contiguous() for t in (q, k, v))
    elif bad == "lengths_int64":
        lens = lens.long()
    elif bad == "lengths_shape":
        lens = lens[:1]
    elif bad == "k_not_contiguous":
        k = k.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "v_shape":
        v = v[:, :-1]
    with pytest.raises(ValueError, match=match):
        gqa_decode(q, k, v, lens)


@pytest.mark.parametrize("B,Hkv,S,ctas,blocks,heads,tile,n_split,rows", [
    (4, 8, 1056, 2, 1, 4, 64, 6, 192),     # llama3-8b serve, prompt 1024: 192 CTAs, 264 slots
    (4, 8, 96, 2, 1, 4, 64, 1, 128),       # llama3-8b serve, prompt 64: two tiles, one split
    (4, 8, 8192, 2, 1, 4, 64, 8, 1024),
    (4, 5, 8192, 3, 1, 3, 64, 19, 448),    # smollm
    (4, 1, 1056, 1, 1, 48, 64, 9, 128),    # granite's 48 heads: the combine's share
    (4, 8, 1056, 1, 2, 64, 64, 2, 576),    # two head blocks per KV head
    (1, 1, 8192, 2, 1, 1, 64, 64, 128),    # at most MAX_SPLITS
    (1, 1, 300, 2, 1, 1, 64, 3, 128),      # short cache
    (8, 8, 32, 2, 1, 4, 64, 1, 64),        # one split: the kernel stores the output directly
    (64, 16, 4096, 2, 1, 4, 64, 1, 4096),  # enough triples for the card without splitting
    (2, 1, 4096, 3, 1, 32, 32, 32, 128),   # fp32, 32 heads: the combine's share
])
def test_split_plan(B, Hkv, S, ctas, blocks, heads, tile, n_split, rows):
    """At most one wave of resident CTAs on 132 SMs, whole tiles, one split
    for a cache of two tiles, a combine that reads at most twice one split's
    K and V bytes, and every row in a split."""
    elem = 2 if tile == 64 else 4
    got = gqa_kernel.split_plan(B, Hkv, S, 132, ctas, tile, blocks, heads, elem)
    assert got == (n_split, rows)
    assert rows % tile == 0 and n_split * rows >= S > (n_split - 1) * rows
    if n_split > 1:
        assert B * Hkv * blocks * n_split <= 132 * ctas and S > 2 * tile
        assert n_split ** 2 * heads <= 2 * S * elem
    assert n_split <= gqa_kernel.MAX_SPLITS
