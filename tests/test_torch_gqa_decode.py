"""The port's decode attention (``repro_torch.kernels.gqa_decode``: on the CPU
its plain version) against the JAX package's ``gqa_decode`` (the Pallas
kernel in interpret mode) and ``gqa_decode_ref``, on the same numpy inputs.

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
}


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
    ("head_dim_48", "head dim 48"),
    ("group_of_64", "at most 32"),
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
    elif bad == "head_dim_48":
        q, k, v = q[..., :48].contiguous(), k[..., :48].contiguous(), v[..., :48].contiguous()
    elif bad == "group_of_64":
        q, k, v = torch.zeros((2, 64, 64)), k[:, :, :1].contiguous(), v[:, :, :1].contiguous()
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


@pytest.mark.parametrize("B,Hkv,S,n_split,rows", [
    (4, 8, 1056, 17, 64),     # llama3-8b serve: 32 pairs, 17 splits
    (4, 8, 8192, 16, 512),
    (4, 5, 8192, 26, 320),    # smollm
    (1, 1, 100, 4, 32),       # short cache: 32-row splits
    (8, 8, 32, 1, 32),        # one split: the kernel stores the output directly
    (64, 16, 4096, 1, 4096),  # enough pairs for the card without splitting
])
def test_split_plan(B, Hkv, S, n_split, rows):
    """About four CTAs per SM on 132 SMs, whole 32-row tiles, every row in
    a split."""
    got = gqa_kernel.split_plan(B, Hkv, S, 132)
    assert got == (n_split, rows)
    assert rows % 32 == 0 and n_split * rows >= S > (n_split - 1) * rows
