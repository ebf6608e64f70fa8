"""The port's CUDA kernels against their plain PyTorch versions, on the card,
at edge shapes the main path does not reach: one lane block, a width that is
not a multiple of 8 (the kernels' per-element load path), ragged lane and
time edges, the largest batch the kernel takes, and both dtypes; for the
linear scan (B3) widths that are and are not a multiple of the vector
width, one time step to a long sequence, an operand at an unaligned
offset, and the reverse-time backward.

They skip, with that reason, on a machine without a CUDA device (decided in
the ``device`` fixture, not at import) and run on the card with
``PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py``. The
main-path shapes and timings are ``chip_smoke.py``'s.
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.kernels.fused_rnn import fused_rnn, stacked
from repro_torch.kernels.linear_scan import linear_scan as ls_kernel
from repro_torch.kernels.linear_scan import ops as ls_ops
from repro_torch.kernels.linear_scan.ref import linear_scan_ref

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


def _scan_operands(device, T, F, dtype, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    a = torch.sigmoid(torch.randn((T, F), generator=g, device=device)).to(dtype)
    b = torch.randn((T, F), generator=g, device=device).to(dtype)
    c0 = torch.randn((F,), generator=g, device=device).to(dtype)
    return a, b, c0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("T", [1, 13, 4096])
@pytest.mark.parametrize("F", [1, 7, 4096, 4097])
def test_linear_scan_kernel_matches_plain(device, F, T, dtype):
    """Bitwise: the kernel rounds the product and the sum separately, as the
    plain version does, and stores each step in the operands' dtype."""
    a, b, c0 = _scan_operands(device, T, F, dtype, seed=T * 10_000 + F)
    before = ls_kernel.LAUNCHES
    out = ls_kernel.linear_scan_kernel(a, b, c0)
    assert ls_kernel.LAUNCHES == before + 1
    ref = linear_scan_ref(a, b, c0)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (T, F)
    assert torch.equal(out, ref), (out.float() - ref.float()).abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_linear_scan_kernel_unaligned_operand(device, dtype):
    """An operand that starts one element past an aligned address takes the
    per-element path; F = 4096 alone would take the vector path."""
    T, F = 37, 4096
    a, b, c0 = _scan_operands(device, T, F, dtype, seed=7)
    buf = torch.empty(T * F + 1, dtype=dtype, device=device)
    b_off = buf[1:].view(T, F)
    b_off.copy_(b)
    assert b_off.data_ptr() % 8 != 0
    out = ls_kernel.linear_scan_kernel(a, b_off, c0)
    torch.cuda.synchronize()
    assert torch.equal(out, linear_scan_ref(a, b, c0))


def test_linear_scan_backward_matches_plain_autograd(device):
    """The VJP runs the kernel in reverse time on flipped operands; against
    autograd through the plain version. fp32, trailing dims (T, B, H)."""
    g = torch.Generator(device=device).manual_seed(3)
    T, B, H = 64, 4, 1000
    a0 = torch.sigmoid(torch.randn((T, B, H), generator=g, device=device))
    b0 = torch.randn((T, B, H), generator=g, device=device)
    c00 = torch.randn((B, H), generator=g, device=device)
    w = torch.randn((T, B, H), generator=g, device=device)
    grads = []
    for fn in ("kernel", "plain"):
        a, b, c0 = (t.clone().requires_grad_(True) for t in (a0, b0, c00))
        if fn == "kernel":
            before = ls_kernel.LAUNCHES
            out = ls_ops.linear_scan(a, b, c0)
        else:
            out = linear_scan_ref(a.reshape(T, -1), b.reshape(T, -1), c0.reshape(-1)).reshape(T, B, H)
        (out * w).sum().backward()
        grads.append([t.grad for t in (a, b, c0)])
    assert ls_kernel.LAUNCHES == before + 2  # forward and reverse-time backward
    torch.cuda.synchronize()
    for mine, ref in zip(*grads):
        err = (mine - ref).abs().max().item()
        assert err <= FP32_TOL * max(1.0, ref.abs().max().item()), err
