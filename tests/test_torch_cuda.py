"""The port's CUDA kernels against their plain PyTorch versions, on the card,
at edge shapes the main path does not reach: one lane block, a width that is
not a multiple of 8 (the kernels' per-element load path), ragged lane and
time edges, the largest batch the kernel takes, and both dtypes.

They skip, with that reason, on a machine without a CUDA device (decided in
the ``device`` fixture, not at import) and run on the card with
``PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py``. The
main-path shapes and timings are ``chip_smoke.py``'s.
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.kernels.fused_rnn import fused_rnn, stacked

# fp32: both sides compute in fp32 and differ only by summation order and a
# few ulp of expf/tanhf/rsqrtf. bf16: the same, then one output rounding,
# i.e. one bf16 ulp (2^-7 relative) at the largest output.
FP32_TOL = 5e-5
BF16_RTOL = 2.0 ** -7


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(outs, refs, dtype):
    for o, r in zip(outs, refs):
        if r is None:
            assert o is None
            continue
        tol = FP32_TOL + (BF16_RTOL * r.float().abs().max().item() if dtype == torch.bfloat16
                          else 0.0)
        err = (o.float() - r.float()).abs().max().item()
        assert err <= tol, (err, tol)


LAYER_CASES = {
    # name: (mode, T, B, d, H, block_t)
    "one_lane_block": ("sru_identity", 5, 1, 8, 8, 2),
    "d_not_multiple_of_8_qrnn": ("qrnn", 37, 3, 20, 20, 8),
    "d_not_multiple_of_8_proj": ("sru_proj", 9, 2, 20, 13, 4),
    "max_batch": ("sru_identity", 3, 128, 64, 64, 32),
    "qrnn_ragged_lanes": ("qrnn", 11, 4, 64, 61, 4),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_layer_kernel_matches_plain(device, case, dtype):
    mode, T, B, d, H, block_t = LAYER_CASES[case]
    g = torch.Generator(device=device).manual_seed(sorted(LAYER_CASES).index(case))

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=device) * scale).to(dtype)

    taps = tuple(rnd(d, 3, H, scale=d ** -0.5) for _ in range(2 if mode == "qrnn" else 1))
    kw = {"mode": mode, "block_t": block_t}
    if mode == "qrnn":
        kw["tail"] = rnd(1, B, d)
    if mode == "sru_proj":
        kw["wskip"] = rnd(d, H, scale=d ** -0.5)
    args = (rnd(T, B, d), taps, rnd(3, H, scale=0.5), rnd(B, H, scale=0.5))
    before = fused_rnn.LAUNCHES
    out = fused_rnn.fused_rnn_layer(*args, **kw)
    assert fused_rnn.LAUNCHES == before + 1
    ref = fused_rnn.fused_rnn_layer_plain(*args, **kw)
    torch.cuda.synchronize()
    _close(out, ref, dtype)


STACK_CASES = {
    # name: (cell, L, T, B, H, block_t)
    "sru_width_20": ("sru", 3, 9, 5, 20, 4),
    "qrnn_width_20": ("qrnn", 3, 9, 5, 20, 4),
    "qrnn_decode": ("qrnn", 2, 1, 4, 64, 32),
    "sru_ragged_lanes": ("sru", 2, 6, 2, 36, 32),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(STACK_CASES))
def test_stack_kernel_matches_plain(device, case, dtype):
    cell, L, T, B, H, block_t = STACK_CASES[case]
    g = torch.Generator(device=device).manual_seed(100 + sorted(STACK_CASES).index(case))

    def rnd(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=g, device=device) * scale + shift).to(dtype)

    taps = tuple(rnd(L, H, 3, H, scale=H ** -0.5) for _ in range(2 if cell == "qrnn" else 1))
    args = (rnd(T, B, H), taps, rnd(L, 3, H, scale=0.5), rnd(L, H, scale=0.1, shift=1.0),
            rnd(L, B, H, scale=0.5), rnd(L, B, H) if cell == "qrnn" else None)
    before = stacked.LAUNCHES
    out = stacked.fused_rnn_stack(*args, block_t=block_t)
    assert stacked.LAUNCHES == before + L
    ref = stacked.fused_rnn_stack_plain(*args, block_t=block_t)
    torch.cuda.synchronize()
    _close(out, ref, dtype)
