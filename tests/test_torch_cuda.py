"""The port's CUDA kernels against their plain PyTorch versions, on the card,
at edge shapes the main path does not reach: one lane block, a width that is
not a multiple of 8 (the kernels' per-element load path), ragged lane and
time edges, the largest batch the kernel takes, and both dtypes; the int8
forms of both (a width that is not a multiple of 8, two scale blocks with a
ragged second one, an int8 slab at an unaligned offset, the largest batch,
``sru_proj`` and QRNN, the stack at L = 4) and an unknown weight type; for
the linear scan (B3) widths that are and are not a multiple of the vector
width, one time step to a long sequence (one chunk to 64), bit for bit
against the chunk emulation, an operand at an unaligned offset, lane-of-B
against B = 1 bit for bit, the fused backward (one launch, bit for bit),
twenty repeated calls with the same bits, calls on two streams at once,
``pallas`` streaming against one-shot within one chunk and past it, and
the launcher's refusals;
for the decode attention (B5) the shapes of ``tests/test_kernels.py``, groups of 1 to 96 (17, and the
full-width granite-20b, zamba2-7b and nemotron-4-340b shapes), head dims
16 to 256 (24, 112, 192), ragged lengths down to 1 on a long cache (splits
with no valid row), one split and many, 100 calls back to back (the
combine's counters reset), calls of many splits on two streams at once and
a captured call replayed after the stream's counters were replaced (each
stream, and each captured call, has counters of its own), every instance's
resources, and the operands it refuses; for the chunked
SSD (B4) one step written in place (also at P = 256 and at a head dim the
16-byte form does not take), sequences of 1, 127, 128, 129 and 1000 steps
(ragged chunks), one group and a group per head, state sizes and head dims
of 16 to 128, both dtypes, an operand at an unaligned offset, one lane with
one head, decays that underflow to 0, and the launcher's refusals; for its
mma chunk kernel (bf16) state sizes 16/64/128 x head dims 8/64/256 x one,
two and a group per head, sequences of 2, 63, 64, 65 and 1024 steps with
mamba2's slow decays, head blocks that do not divide the heads of a group,
16-byte aligned strided views with the state in place, the plan at the
mamba2 shape, and every chunk instance's resources; for the fused RNN's
tensor-core body (bf16 IO, bf16 and int8 slabs) one decode step to the
largest batch at a width that leaves ragged lane blocks and padded taps,
every mode and both stacks, operands off 16-byte alignment (element
copies), back-to-back launches bit for bit, every served instance with all
its clusters resident on the card, and the plans the launcher refuses.
And the batch serving steps as CUDA graphs (``training/graphs.py``): for one
config of each block kind and each engine (int8 instances included) at full
width, a captured prefill and 8 captured decode steps, twice, against the
eager steps: the same tokens and logits, the same launches counted, the
caches kept where they are.

They skip, with that reason, on a machine without a CUDA device (decided in
the ``device`` fixture, not at import) and run on the card with
``PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py``. The
main-path shapes and timings are ``chip_smoke.py``'s.
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.kernels import build
from repro_torch.kernels.fused_rnn import fused_rnn, layout, stacked
from repro_torch.kernels.gqa_decode import gqa_decode as gqa_kernel
from repro_torch.kernels.gqa_decode.ops import gqa_decode
from repro_torch.kernels.gqa_decode.ref import gqa_decode_ref
from repro_torch.kernels.linear_scan import linear_scan as ls_kernel
from repro_torch.kernels.linear_scan import ops as ls_ops
from repro_torch.kernels.linear_scan.ref import (CHUNK, chunk_len, linear_scan_bwd_ref,
                                                 linear_scan_ref)
from repro_torch.kernels.ssd import ssd as ssd_kernel
from repro_torch.kernels.ssd.ops import ssd
from repro_torch.kernels.ssd.ref import ssd_ref
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.models.layers import _dtype
from repro_torch.training import graphs
from repro_torch.training.steps import build_decode_step, build_prefill_step

# fp32: both sides compute in fp32 and differ only by summation order and a
# few ulp of expf/tanhf/rsqrtf. bf16: the same, then one output rounding,
# i.e. one bf16 ulp (2^-7 relative) at the largest output.
FP32_TOL = 5e-5
BF16_RTOL = 2.0 ** -7
# Streaming in blocks against one-shot: the JAX package's tolerance.
STREAM_TOL = 3e-5


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


INT8_LAYER_CASES = {
    # name: (mode, T, B, d, H, block_t, slab at an odd address)
    "width_not_multiple_of_8": ("sru_identity", 9, 3, 61, 61, 4, False),
    "two_scale_blocks_qrnn": ("qrnn", 11, 4, 64, 200, 4, False),
    "offset_slab": ("sru_identity", 7, 2, 64, 64, 4, True),
    "max_batch": ("sru_identity", 3, 128, 64, 64, 32, False),
    "sru_proj": ("sru_proj", 9, 2, 20, 136, 4, False),
    "qrnn": ("qrnn", 37, 3, 64, 64, 8, False),
}


def _odd_address_copy(t):
    """``t`` copied into a buffer one byte past an aligned address: the
    kernel's per-element load path."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 8 != 0
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(INT8_LAYER_CASES))
def test_int8_layer_kernel_matches_plain(device, case, dtype):
    mode, T, B, d, H, block_t, odd = INT8_LAYER_CASES[case]
    g = torch.Generator(device=device).manual_seed(200 + sorted(INT8_LAYER_CASES).index(case))

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=device) * scale

    if mode == "qrnn":
        *taps, scale = layout.quantize_qrnn_slabs(rnd(d, 3, H), rnd(d, 3, H))
    else:
        wq, scale = layout.quantize_slabs(rnd(d, 3, H, scale=d ** -0.5))
        taps = [_odd_address_copy(wq) if odd else wq]
    kw = {"mode": mode, "block_t": block_t, "scale": scale}
    if mode == "qrnn":
        kw["tail"] = rnd(1, B, d).to(dtype)
    if mode == "sru_proj":
        kw["wskip"] = rnd(d, H, scale=d ** -0.5).to(dtype)
    args = (rnd(T, B, d).to(dtype), tuple(taps), rnd(3, H, scale=0.5).to(dtype),
            rnd(B, H, scale=0.5).to(dtype))
    before, before_fp = fused_rnn.LAUNCHES_INT8, fused_rnn.LAUNCHES
    out = fused_rnn.fused_rnn_layer(*args, **kw)
    assert (fused_rnn.LAUNCHES_INT8, fused_rnn.LAUNCHES) == (before + 1, before_fp)
    ref = fused_rnn.fused_rnn_layer_plain(*args, **kw)
    torch.cuda.synchronize()
    _close(out, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("cell,T,H", [("sru", 9, 64), ("qrnn", 1, 200)])
def test_int8_stack_kernel_matches_plain(device, cell, T, H, dtype):
    L, B = 4, 4
    g = torch.Generator(device=device).manual_seed(300 + T)

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=g, device=device) * scale + shift

    if cell == "qrnn":
        *taps, sL = layout.quantize_qrnn_slabs(rnd(L, H, 3, H), rnd(L, H, 3, H))
    else:
        wq, sL = layout.quantize_slabs(rnd(L, H, 3, H))
        taps = [wq]
    args = (rnd(T, B, H).to(dtype), tuple(taps), rnd(L, 3, H, scale=0.5).to(dtype),
            rnd(L, H, scale=0.1, shift=1.0).to(dtype), rnd(L, B, H, scale=0.5).to(dtype),
            rnd(L, B, H).to(dtype) if cell == "qrnn" else None)
    before = stacked.LAUNCHES_INT8
    out = stacked.fused_rnn_stack(*args, block_t=4, sL=sL)
    assert stacked.LAUNCHES_INT8 == before + L
    ref = stacked.fused_rnn_stack_plain(*args, block_t=4, sL=sL)
    torch.cuda.synchronize()
    _close(out, ref, dtype)


@pytest.mark.parametrize("lib_name,own_pairs", [
    ("fused_rnn_layer", ((0, 2), (1, 2))),
    ("fused_rnn_layer_int8", ((0, 0), (1, 1))),
])
def test_kernel_refuses_an_unknown_weight_type(device, lib_name, own_pairs):
    """A (dtype, wdtype) pair the library has no instance for returns -2 and
    launches nothing: the output keeps its sentinel. The fp build has no int8
    instance and the int8 build no fp one."""
    T, B, d, H = 2, 1, 8, 8
    u = torch.zeros((T, B, d), device=device)
    w = torch.zeros((d, 3, H), device=device)
    b3, c0 = torch.zeros((3, H), device=device), torch.zeros((B, H), device=device)
    scale = torch.ones((3, 1), device=device)
    h, c_last = torch.full((T, B, H), 7.0, device=device), torch.empty((B, H), device=device)
    lib = build.library(lib_name)
    for dtype, wdtype in ((0, 1), (1, 0), (2, 2), (0, 5)) + own_pairs:
        rc = lib.fused_rnn_layer_launch(
            dtype, wdtype, u.data_ptr(), w.data_ptr(), None, scale.data_ptr(), b3.data_ptr(),
            c0.data_ptr(), None, u.data_ptr(), None, h.data_ptr(), c_last.data_ptr(),
            T, B, d, H, 2, 0, 1, 1, 16,
            torch.cuda.current_stream(device).cuda_stream,
        )
        assert rc == -2, (dtype, wdtype, rc)
    torch.cuda.synchronize()
    assert torch.all(h == 7.0)


# The tensor-core body (bf16 IO): (T, B) from one decode step to the largest
# batch; width 200 leaves a last lane block of 8 lanes (16 and 32 lanes a
# CTA) and pads each tap of d = 200 by 8.
MMA_SHAPES = [(1, 1), (1, 4), (13, 3), (64, 4), (3, 128)]


def _mma_layer_operands(device, mode, T, B, d, H, int8, seed):
    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=device) * scale

    taps = [rnd(d, 3, H, scale=d ** -0.5) for _ in range(2 if mode == "qrnn" else 1)]
    kw = {"mode": mode, "block_t": 32}
    if int8:
        if mode == "qrnn":
            *taps, kw["scale"] = layout.quantize_qrnn_slabs(*taps)
        else:
            wq, kw["scale"] = layout.quantize_slabs(taps[0])
            taps = [wq]
    else:
        taps = [w.to(torch.bfloat16) for w in taps]
    if mode == "qrnn":
        kw["tail"] = rnd(1, B, d).to(torch.bfloat16)
    if mode == "sru_proj":
        kw["wskip"] = rnd(d, H, scale=d ** -0.5).to(torch.bfloat16)
    args = (rnd(T, B, d).to(torch.bfloat16), tuple(taps),
            rnd(3, H, scale=0.5).to(torch.bfloat16), rnd(B, H, scale=0.5).to(torch.bfloat16))
    return args, kw


@pytest.mark.parametrize("int8", [False, True], ids=["bf16_slab", "int8_slab"])
@pytest.mark.parametrize("T,B", MMA_SHAPES)
@pytest.mark.parametrize("mode", ["sru_identity", "qrnn", "sru_proj"])
def test_mma_layer_kernel_shapes(device, mode, T, B, int8):
    d = 136 if mode == "sru_proj" else 200
    args, kw = _mma_layer_operands(device, mode, T, B, d, 200, int8, seed=T * 1000 + B)
    out = fused_rnn.fused_rnn_layer(*args, **kw)
    ref = fused_rnn.fused_rnn_layer_plain(*args, **kw)
    torch.cuda.synchronize()
    _close(out, ref, torch.bfloat16)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16_slab", "int8_slab"])
@pytest.mark.parametrize("T,B", MMA_SHAPES)
@pytest.mark.parametrize("cell", ["sru", "qrnn"])
def test_mma_stack_kernel_shapes(device, cell, T, B, int8):
    """Two layers; QRNN's normed tail out (tails_last) is compared too."""
    L, H = 2, 200
    g = torch.Generator(device=device).manual_seed(500 + T * 1000 + B)

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=g, device=device) * scale + shift

    taps = [rnd(L, H, 3, H, scale=H ** -0.5) for _ in range(2 if cell == "qrnn" else 1)]
    kw = {"block_t": 32}
    if int8:
        if cell == "qrnn":
            *taps, kw["sL"] = layout.quantize_qrnn_slabs(*taps)
        else:
            wq, kw["sL"] = layout.quantize_slabs(taps[0])
            taps = [wq]
    else:
        taps = [w.to(torch.bfloat16) for w in taps]
    bf = torch.bfloat16
    args = (rnd(T, B, H).to(bf), tuple(taps), rnd(L, 3, H, scale=0.5).to(bf),
            rnd(L, H, scale=0.1, shift=1.0).to(bf), rnd(L, B, H, scale=0.5).to(bf),
            rnd(L, B, H).to(bf) if cell == "qrnn" else None)
    out = stacked.fused_rnn_stack(*args, **kw)
    ref = stacked.fused_rnn_stack_plain(*args, **kw)
    torch.cuda.synchronize()
    _close(out, ref, bf)


def _offset_copy(t, elements=1):
    """``t`` in a buffer ``elements`` past an aligned address: a contiguous
    operand whose runs are not 16-byte aligned (element copies)."""
    buf = torch.empty(t.numel() + elements, dtype=t.dtype, device=t.device)
    out = buf[elements:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 != 0
    return out


@pytest.mark.parametrize("int8", [False, True], ids=["bf16_slab", "int8_slab"])
@pytest.mark.parametrize("mode", ["qrnn", "sru_proj"])
def test_mma_layer_kernel_unaligned_operands(device, mode, int8):
    """Input, tail, slabs and skip projection each one element off a 16-byte
    boundary: every copy takes the element path, none falls back."""
    args, kw = _mma_layer_operands(device, mode, 13, 3, 64, 96, int8, seed=7)
    u, taps, b3, c0 = args
    moved = (_offset_copy(u), tuple(_offset_copy(w) for w in taps), b3, c0)
    kw_moved = dict(kw)
    for key in ("tail", "wskip"):
        if key in kw:
            kw_moved[key] = _offset_copy(kw[key])
    out = fused_rnn.fused_rnn_layer(*moved, **kw_moved)
    ref = fused_rnn.fused_rnn_layer_plain(*args, **kw)
    torch.cuda.synchronize()
    _close(out, ref, torch.bfloat16)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16_slab", "int8_slab"])
def test_mma_kernel_back_to_back_calls(device, int8):
    """Twenty launches on one stream, layer and stack in turns: each agrees
    with the first bit for bit (no state carries from one launch to the
    next) and with the plain version."""
    args, kw = _mma_layer_operands(device, "qrnn", 5, 4, 256, 256, int8, seed=11)
    L, H = 2, 256
    g = torch.Generator(device=device).manual_seed(12)
    taps = [torch.randn((L, H, 3, H), generator=g, device=device) * H ** -0.5]
    skw = {"block_t": 32}
    if int8:
        wq, skw["sL"] = layout.quantize_slabs(taps[0])
        taps = [wq]
    else:
        taps = [taps[0].to(torch.bfloat16)]
    bf = torch.bfloat16
    sargs = (torch.randn((5, 4, H), generator=g, device=device).to(bf), tuple(taps),
             torch.zeros((L, 3, H), device=device, dtype=bf),
             torch.ones((L, H), device=device, dtype=bf),
             torch.zeros((L, 4, H), device=device, dtype=bf), None)
    first = fused_rnn.fused_rnn_layer(*args, **kw), stacked.fused_rnn_stack(*sargs, **skw)
    outs = [(fused_rnn.fused_rnn_layer(*args, **kw), stacked.fused_rnn_stack(*sargs, **skw))
            for _ in range(10)]
    torch.cuda.synchronize()
    for layer_out, stack_out in outs:
        for o, f in zip(layer_out + stack_out, first[0] + first[1]):
            assert (o is None and f is None) or torch.equal(o, f)
    _close(first[0], fused_rnn.fused_rnn_layer_plain(*args, **kw), bf)
    _close(first[1], stacked.fused_rnn_stack_plain(*sargs, **skw), bf)


# Every served shape of the tensor-core body (B = 4, prompt 64 and one
# decode step) and the ragged width: (d, H, ng, stack, taps).
MMA_INSTANCES = {
    "sru": (1024, 1024, 3, False, 1), "qrnn": (1024, 1024, 3, False, 2),
    "sru_proj": (512, 1024, 4, False, 1), "sru_stack": (1024, 1024, 3, True, 1),
    "qrnn_stack": (1024, 1024, 3, True, 2), "qrnn_ragged": (1000, 1000, 3, False, 2),
    "sru_small": (512, 512, 3, False, 1), "qrnn_stack_small": (512, 512, 3, True, 2),
}


@pytest.mark.parametrize("int8", [False, True], ids=["bf16_slab", "int8_slab"])
@pytest.mark.parametrize("T", [1, 64])
@pytest.mark.parametrize("case", sorted(MMA_INSTANCES))
def test_mma_instances_fit_the_card(device, case, T, int8):
    """The card takes the instance the plan asks for: its shared memory is
    the plan's, one CTA per SM at least, every cluster of the grid resident
    at once at the served width, no register spill past the 255 cap."""
    d, H, ng, stack, taps = MMA_INSTANCES[case]
    kw = {"int8": int8, "ng": ng, "stack": stack, "taps": taps, "block_t": min(T, 32)}
    p = fused_rnn.plan(T, 4, d, H, n_sm=torch.cuda.get_device_properties(0).multi_processor_count,
                       slots=fused_rnn.cluster_slots(0), **kw)
    info = fused_rnn.instance_info(T, 4, d, H, **kw)
    assert info["smem_bytes"] == p.smem_bytes
    assert (info["lanes"], info["cluster"], info["grid"], info["k_tile"]) == (
        p.lanes, p.cluster, p.grid, p.k_tile)
    assert info["ctas_per_sm"] >= 1 and 0 < info["registers"] <= 255
    assert info["max_active_clusters"] * p.cluster >= p.grid, info


def test_mma_launcher_refuses_a_plan_it_cannot_take(device):
    """A cluster size the card has no such cluster for, or an input tile
    that is not a multiple of 16 columns, returns -3 and launches nothing."""
    T, B, d, H = 2, 1, 16, 16
    bf = torch.bfloat16
    u = torch.zeros((T, B, d), device=device, dtype=bf)
    w = torch.zeros((d, 3, H), device=device, dtype=bf)
    b3, c0 = torch.zeros((3, H), device=device, dtype=bf), torch.zeros((B, H), device=device, dtype=bf)
    h = torch.full((T, B, H), 7.0, device=device, dtype=bf)
    c_last = torch.empty((B, H), device=device, dtype=bf)
    lib = build.library("fused_rnn_layer")
    for cluster, k_tile in ((3, 16), (16, 16), (1, 8), (1, 24), (1, 0)):
        rc = lib.fused_rnn_layer_launch(
            1, 1, u.data_ptr(), w.data_ptr(), None, None, b3.data_ptr(), c0.data_ptr(), None,
            u.data_ptr(), None, h.data_ptr(), c_last.data_ptr(), T, B, d, H, 2, 0, 1,
            cluster, k_tile, torch.cuda.current_stream(device).cuda_stream,
        )
        assert rc == -3, (cluster, k_tile, rc)
    torch.cuda.synchronize()
    assert torch.all(h == 7.0)


def _scan_operands(device, T, F, dtype, seed, shift=0.0):
    """a = sigmoid(normal + shift), b, c0 normal. ``shift=3`` puts a near
    0.95, so the carry reaches across chunks of 64 steps and the fold's
    rounding shows."""
    g = torch.Generator(device=device).manual_seed(seed)
    a = torch.sigmoid(torch.randn((T, F), generator=g, device=device) + shift).to(dtype)
    b = torch.randn((T, F), generator=g, device=device).to(dtype)
    c0 = torch.randn((F,), generator=g, device=device).to(dtype)
    return a, b, c0


def _chunked(a, b, c0):
    return linear_scan_ref(a, b, c0, chunk=chunk_len(a.shape[0]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("T", [1, 13, 64, 1024, 4096])
@pytest.mark.parametrize("F", [1, 7, 1024, 4096, 4097])
def test_linear_scan_kernel_matches_plain(device, F, T, dtype):
    """Bitwise against the chunk emulation: the kernel rounds the product and
    the sum separately, folds the chunks' aggregates in the same order, and
    stores each step in the operands' dtype. Within FP32_TOL (fp32) or one
    bf16 ulp (bf16) of the sequential walk."""
    a, b, c0 = _scan_operands(device, T, F, dtype, seed=T * 10_000 + F, shift=3.0)
    before = ls_kernel.LAUNCHES
    out = ls_kernel.linear_scan_kernel(a, b, c0)
    assert ls_kernel.LAUNCHES == before + 1
    ref = _chunked(a, b, c0)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (T, F)
    assert torch.equal(out, ref), (out.float() - ref.float()).abs().max().item()
    _close([out], [linear_scan_ref(a, b, c0)], dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_linear_scan_kernel_unaligned_operand(device, dtype):
    """An operand that starts one element past an aligned address takes the
    per-element path (bf16); F = 4096 alone would take bf16 pairs. One chunk
    and four."""
    for T in (37, 200):
        F = 4096
        a, b, c0 = _scan_operands(device, T, F, dtype, seed=7, shift=3.0)
        buf = torch.empty(T * F + 1, dtype=dtype, device=device)
        b_off = buf[1:].view(T, F)
        b_off.copy_(b)
        assert b_off.data_ptr() % 8 != 0
        out = ls_kernel.linear_scan_kernel(a, b_off, c0)
        torch.cuda.synchronize()
        assert torch.equal(out, _chunked(a, b, c0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("T", [64, 1024])
def test_linear_scan_kernel_lane_of_b_is_bitwise(device, T, dtype):
    """B = 4 lanes of H = 1024 in one call (F = 4096) give, lane by lane, the
    bits of each lane's own call (F = 1024): the chunking is T's alone."""
    a, b, c0 = _scan_operands(device, T, 4096, dtype, seed=T + 1, shift=3.0)
    full = ls_kernel.linear_scan_kernel(a, b, c0)
    for lane in range(4):
        cols = slice(lane * 1024, (lane + 1) * 1024)
        one = ls_kernel.linear_scan_kernel(a[:, cols].contiguous(), b[:, cols].contiguous(),
                                           c0[cols].contiguous())
        torch.cuda.synchronize()
        assert torch.equal(full[:, cols], one), lane


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("T,F", [(1, 4096), (13, 7), (64, 4096), (200, 4097), (1024, 4096),
                                 (4096, 128)])
def test_linear_scan_bwd_kernel_is_one_launch_and_bitwise(device, T, F, dtype):
    """The fused backward: one launch, bit for bit ``linear_scan_bwd_ref`` at
    the kernel's chunk (cbar stored in g's dtype before the products)."""
    a, b, c0 = _scan_operands(device, T, F, dtype, seed=5 * T + F, shift=3.0)
    c = ls_kernel.linear_scan_kernel(a, b, c0)
    g = torch.randn((T, F), generator=torch.Generator(device=device).manual_seed(T),
                    device=device).to(dtype)
    before = ls_kernel.LAUNCHES
    grads = ls_kernel.linear_scan_bwd(a, c, c0, g)
    assert ls_kernel.LAUNCHES == before + 1
    want = linear_scan_bwd_ref(a, c, c0, g, chunk=chunk_len(T))
    torch.cuda.synchronize()
    for name, mine, ref in zip(("da", "db", "dc0"), grads, want):
        assert mine.dtype == dtype and mine.shape == ref.shape
        assert torch.equal(mine, ref), (name, (mine.float() - ref.float()).abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_linear_scan_kernel_long_sequence(device, dtype):
    """T = 16384 is 256 chunks of 64 steps: the last CTA folds 255
    aggregates, eight rounds of staged records. Forward and backward bit
    for bit their chunk emulation."""
    T, F = 16384, 100
    a, b, c0 = _scan_operands(device, T, F, dtype, seed=17, shift=3.0)
    g = torch.randn((T, F), generator=torch.Generator(device=device).manual_seed(18),
                    device=device).to(dtype)
    out = ls_kernel.linear_scan_kernel(a, b, c0)
    grads = ls_kernel.linear_scan_bwd(a, out, c0, g)
    want = _chunked(a, b, c0)
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    for mine, ref in zip(grads, linear_scan_bwd_ref(a, want, c0, g, chunk=chunk_len(T))):
        assert torch.equal(mine, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_linear_scan_kernel_is_deterministic(device, dtype):
    """Twenty calls at T = 4096 (64 chunks, CTAs in whatever order the card
    runs them) give the same bits, forward and backward."""
    a, b, c0 = _scan_operands(device, 4096, 1000, dtype, seed=11, shift=3.0)
    g = torch.randn((4096, 1000), generator=torch.Generator(device=device).manual_seed(12),
                    device=device).to(dtype)
    first = ls_kernel.linear_scan_kernel(a, b, c0)
    first_bwd = ls_kernel.linear_scan_bwd(a, first, c0, g)
    for _ in range(19):
        assert torch.equal(ls_kernel.linear_scan_kernel(a, b, c0), first)
        for mine, ref in zip(ls_kernel.linear_scan_bwd(a, first, c0, g), first_bwd):
            assert torch.equal(mine, ref)


def test_linear_scan_launcher_refuses_bad_arguments(device):
    """-1 for an empty scan, a chunk outside 1 .. 64, or several chunks
    without their scratch; -2 for an unknown dtype."""
    lib = build.library("linear_scan")
    a = torch.zeros((128, 64), device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    p = a.data_ptr()

    def fwd(dtype, T, F, chunk, sync=None, agg=None):
        return lib.linear_scan_launch(dtype, p, p, p, p, T, F, chunk, sync, agg, stream)

    assert fwd(0, 0, 64, 64) == -1
    assert fwd(0, 128, 0, 64) == -1
    assert fwd(2, 128, 64, 64) == -2
    assert fwd(0, 128, 64, 0) == -1
    assert fwd(0, 64, 64, 65) == -1
    assert fwd(0, 128, 64, 64) == -1  # two chunks, no ticket word or records
    assert lib.linear_scan_bwd_launch(0, p, p, p, p, p, p, p, 128, 64, 64, None, None,
                                      stream) == -1
    torch.cuda.synchronize()


def test_linear_scan_kernel_on_two_streams_at_once(device):
    """Calls of several chunks on two streams that overlap, forward and
    backward in turns: each stream has its own ticket word and flags, so
    each result is bit for bit its chunk emulation."""
    cases = [_scan_operands(device, 4096, 1000, torch.float32, seed=21, shift=3.0),
             _scan_operands(device, 2048, 3000, torch.bfloat16, seed=22, shift=3.0)]
    gs = [torch.randn(a.shape, generator=torch.Generator(device=device).manual_seed(i),
                      device=device).to(a.dtype) for i, (a, _, _) in enumerate(cases)]
    want = [_chunked(*ops) for ops in cases]
    want_bwd = [linear_scan_bwd_ref(a, w, c0, g, chunk=chunk_len(a.shape[0]))
                for (a, _, c0), w, g in zip(cases, want, gs)]
    streams = [torch.cuda.Stream(device) for _ in cases]
    torch.cuda.synchronize()
    outs = [[] for _ in cases]
    for _ in range(10):
        for s, (a, b, c0), w, g, o in zip(streams, cases, want, gs, outs):
            with torch.cuda.stream(s):
                o.append((ls_kernel.linear_scan_kernel(a, b, c0),
                          ls_kernel.linear_scan_bwd(a, w, c0, g)))
    torch.cuda.synchronize()
    for o, w, wb in zip(outs, want, want_bwd):
        for fwd, bwd in o:
            assert torch.equal(fwd, w)
            assert all(torch.equal(x, y) for x, y in zip(bwd, wb))


@pytest.mark.parametrize("n_blocks,block_len", [(3, 16), (3, 40)])
def test_pallas_streaming_against_one_shot(device, n_blocks, block_len):
    """Under ``pallas``, the recurrence and an SRU layer (B = 4, H = 1024)
    streamed in blocks with their carry, against one call over all T. The
    recurrence is bit for bit while that T is one chunk (48 steps); past it
    (120 steps: the one call folds chunk aggregates, the blocks walk) both
    are within the JAX package's streaming tolerance, as the layer is at any
    T (its gate GEMM runs at another M)."""
    from repro_torch.core import cells, mts, scan

    T, B, H = n_blocks * block_len, 4, 1024
    g = torch.Generator(device=device).manual_seed(T)
    a = torch.sigmoid(torch.randn((T, B, H), generator=g, device=device) + 3.0)
    b = torch.randn((T, B, H), generator=g, device=device)
    c0 = torch.randn((B, H), generator=g, device=device)
    one = scan.linear_scan(a, b, c0, engine="pallas")
    c, outs = c0, []
    for i in range(n_blocks):
        blk = slice(i * block_len, (i + 1) * block_len)
        outs.append(scan.linear_scan(a[blk], b[blk], c, engine="pallas"))
        c = outs[-1][-1]
    params = cells.sru_init(torch.Generator().manual_seed(T), H, H, device=device)
    x = torch.randn((B, T, H), generator=g, device=device)
    h_one, c_one = mts.mts_sru(params, x, c0, engine="pallas")
    st, hs = mts.StreamState(c=c0, x_tail=None), []
    for i in range(n_blocks):
        h, st = mts.mts_stream_step("sru", params, st, x[:, i * block_len:(i + 1) * block_len],
                                    engine="pallas")
        hs.append(h)
    torch.cuda.synchronize()
    streamed = torch.cat(outs)
    if T <= CHUNK:
        assert torch.equal(streamed, one)
    for got, want in ((streamed, one), (torch.cat(hs, dim=1), h_one), (st.c, c_one)):
        torch.testing.assert_close(got, want, rtol=STREAM_TOL, atol=STREAM_TOL)


def test_linear_scan_backward_matches_plain_autograd(device):
    """The VJP is one launch of the fused backward; against autograd through
    the plain walk. fp32, trailing dims (T, B, H)."""
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
    assert ls_kernel.LAUNCHES == before + 2  # forward and fused backward
    torch.cuda.synchronize()
    for mine, ref in zip(*grads):
        err = (mine - ref).abs().max().item()
        assert err <= FP32_TOL * max(1.0, ref.abs().max().item()), err


# Decode attention (B5): name -> (B, Hq, Hkv, Dh, S, lengths or None for random).
GQA_CASES = {
    "kernels_2x8x2x64": (2, 8, 2, 64, 256, None),
    "kernels_mqa_g32": (1, 32, 1, 64, 512, None),
    "kernels_g1_dh32": (3, 16, 16, 32, 128, None),
    "kernels_dh128": (2, 12, 4, 128, 64, None),
    "smollm_g3_ragged": (4, 15, 5, 64, 300, (300, 1, 33, 257)),
    "reduced_dh16": (3, 4, 2, 16, 40, (40, 17, 1)),
    "llama3_len1_long_cache": (4, 32, 8, 128, 8192, (1, 1, 8192, 2)),
    "g32_dh128_full": (1, 32, 1, 128, 1000, (1000,)),
    # the full-width head shapes of granite-20b, zamba2-7b, nemotron-4-340b
    "granite_g48_dh128": (4, 48, 1, 128, 1056, (1025, 1056, 1, 500)),
    "zamba2_dh112": (4, 32, 32, 112, 1056, (1025, 1, 700, 1056)),
    "nemotron_g12_dh192": (4, 96, 8, 192, 1056, (1025, 64, 1, 1056)),
    "g17_dh64": (2, 34, 2, 64, 300, (300, 1)),
    "dh24_g3": (3, 6, 2, 24, 200, (200, 1, 77)),
}


def _gqa_operands(device, case, dtype):
    B, Hq, Hkv, Dh, S, lengths = GQA_CASES[case]
    g = torch.Generator(device=device).manual_seed(sorted(GQA_CASES).index(case))
    q = torch.randn((B, Hq, Dh), generator=g, device=device).to(dtype)
    k = torch.randn((B, S, Hkv, Dh), generator=g, device=device).to(dtype)
    v = torch.randn((B, S, Hkv, Dh), generator=g, device=device).to(dtype)
    if lengths is None:
        lens = torch.randint(1, S + 1, (B,), generator=g, device=device, dtype=torch.int32)
    else:
        lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    return q, k, v, lens


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(GQA_CASES))
def test_gqa_decode_kernel_matches_plain(device, case, dtype):
    q, k, v, lens = _gqa_operands(device, case, dtype)
    before = gqa_kernel.LAUNCHES
    out = gqa_decode(q, k, v, lens)
    assert gqa_kernel.LAUNCHES == before + 1
    ref = gqa_decode_ref(q, k, v, lens)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == q.shape
    assert torch.isfinite(out.float()).all()
    _close((out,), (ref,), dtype)


def test_gqa_decode_kernel_truncated_prefix(device):
    """Rows past the length do not leak: the result equals attention over
    the prefix alone (``tests/test_kernels.py``'s check), fp32."""
    q, k, v, _ = _gqa_operands(device, "kernels_2x8x2x64", torch.float32)
    L = 37
    lens = torch.full((2,), L, dtype=torch.int32, device=device)
    out = gqa_decode(q, k, v, lens)
    ref = gqa_decode_ref(q, k[:, :L].contiguous(), v[:, :L].contiguous(), lens)
    torch.cuda.synchronize()
    _close((out,), (ref,), torch.float32)


@pytest.mark.parametrize("S", [32, 96, 4096])
def test_gqa_decode_kernel_one_split_and_many(device, S):
    """A cache of one split (the direct store) and of many (the combine)."""
    n_split, _, _ = gqa_kernel.plan(torch.float32, 8, 8, S, 128, 4)
    assert (n_split == 1) == (S == 32)
    g = torch.Generator(device=device).manual_seed(S)
    q = torch.randn((8, 32, 128), generator=g, device=device)
    k, v = (torch.randn((8, S, 8, 128), generator=g, device=device) for _ in range(2))
    lens = torch.randint(1, S + 1, (8,), generator=g, device=device, dtype=torch.int32)
    out = gqa_decode(q, k, v, lens)
    ref = gqa_decode_ref(q, k, v, lens)
    torch.cuda.synchronize()
    _close((out,), (ref,), torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("S", [32, 4096])
def test_gqa_decode_kernel_one_split_and_many_dh192(device, S, dtype):
    """Head dim 192 (nemotron-4-340b's) with one split and with many."""
    B, Hkv, G = 8, 8, 12
    n_split, _, _ = gqa_kernel.plan(dtype, B, Hkv, S, 192, G)
    assert (n_split == 1) == (S == 32)
    g = torch.Generator(device=device).manual_seed(S + 192)
    q = torch.randn((B, Hkv * G, 192), generator=g, device=device).to(dtype)
    k, v = (torch.randn((B, S, Hkv, 192), generator=g, device=device).to(dtype)
            for _ in range(2))
    lens = torch.randint(1, S + 1, (B,), generator=g, device=device, dtype=torch.int32)
    out = gqa_decode(q, k, v, lens)
    ref = gqa_decode_ref(q, k, v, lens)
    torch.cuda.synchronize()
    _close((out,), (ref,), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_gqa_decode_kernel_back_to_back_calls(device, dtype):
    """100 calls in a row on one stream, each with other lengths, each held
    to the plain version: the combine's arrival counters go back to zero
    after every call, or a later call combines too early or never."""
    q, k, v, _ = _gqa_operands(device, "llama3_len1_long_cache", dtype)
    g = torch.Generator(device=device).manual_seed(100)
    S = k.shape[1]
    assert gqa_kernel.plan(dtype, 4, 8, S, 128, 4)[0] > 1
    outs, lens_all = [], []
    for _ in range(100):
        lens = torch.randint(1, S + 1, (4,), generator=g, device=device, dtype=torch.int32)
        outs.append(gqa_decode(q, k, v, lens))
        lens_all.append(lens)
    for out, lens in zip(outs, lens_all):
        _close((out,), (gqa_decode_ref(q, k, v, lens),), dtype)
    stream = torch.cuda.current_stream(device).cuda_stream
    assert not gqa_kernel._COUNTERS[(q.device.index, stream)].any()



def test_gqa_decode_kernel_on_two_streams_at_once(device):
    """Calls of many splits on two streams that overlap, repeated: each
    stream has its own arrival counters, so each result is bit for bit the
    same call's alone (with shared counters one call's last-CTA test could
    fire before its own splits landed and combine unwritten partials)."""
    cases = []
    for case, dtype, lengths in (
            ("llama3_len1_long_cache", torch.bfloat16, (8192, 6000, 8192, 7000)),
            ("g32_dh128_full", torch.float32, (1000,))):
        q, k, v, _ = _gqa_operands(device, case, dtype)
        B, Hq, Dh = q.shape
        assert gqa_kernel.plan(dtype, B, k.shape[2], k.shape[1], Dh, Hq // k.shape[2])[0] > 1
        cases.append((q, k, v, torch.tensor(lengths, dtype=torch.int32, device=device)))
    alone = [gqa_decode(*ops) for ops in cases]
    streams = [torch.cuda.Stream(device) for _ in cases]
    torch.cuda.synchronize()
    outs = [[] for _ in cases]
    for _ in range(20):
        for s, ops, o in zip(streams, cases, outs):
            with torch.cuda.stream(s):
                o.append(gqa_decode(*ops))
    torch.cuda.synchronize()
    for o, want in zip(outs, alone):
        assert all(torch.equal(x, want) for x in o)


def test_gqa_decode_kernel_captured_keeps_its_own_counters(device):
    """A call captured into a CUDA graph has counters of its own, zeroed by a
    fill captured with it: after the capture the stream's eager buffer is
    replaced (as a call that needs more counters replaces it; no served
    shape needs more than the 1024 a buffer starts with, so the test drops
    it), the old buffer's memory is written over, an eager call runs on a
    new buffer, and each replay still gives the eager result bit for bit."""
    q, k, v, _ = _gqa_operands(device, "llama3_len1_long_cache", torch.bfloat16)
    lens = torch.tensor((8192, 4000, 1, 777), dtype=torch.int32, device=device)
    assert gqa_kernel.plan(torch.bfloat16, 4, 8, 8192, 128, 4)[0] > 1
    gqa_decode(q, k, v, lens)  # warm-up: library, plan, eager counters
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = gqa_decode(q, k, v, lens)
    key = (q.device.index, torch.cuda.current_stream(device).cuda_stream)
    n = gqa_kernel._COUNTERS.pop(key).numel()
    junk = torch.full((n,), 7, dtype=torch.int32, device=device)  # where the old buffer was
    eager = gqa_decode(q, k, v, lens)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, eager)
    del junk


def test_gqa_decode_refuses_what_the_kernel_does_not_take(device):
    q, k, v, lens = _gqa_operands(device, "kernels_2x8x2x64", torch.float32)
    with pytest.raises(ValueError, match="lengths: .* on cpu, expected torch.int32 on cuda"):
        gqa_decode(q, k, v, lens.cpu())
    with pytest.raises(ValueError, match="expected torch.int32"):
        gqa_decode(q, k, v, lens.long())
    with pytest.raises(ValueError, match="16-byte aligned"):
        buf = torch.empty(k.numel() + 1, device=device)
        k_odd = buf[1:].view(k.shape)
        gqa_decode(q, k_odd, v, lens)
    with pytest.raises(ValueError, match="head dim 44 unsupported; .* a multiple of 8"):
        gqa_decode(q[..., :44].contiguous(), k[..., :44].contiguous(),
                   v[..., :44].contiguous(), lens)
    with pytest.raises(ValueError, match="head dim 264 unsupported; .* up to 256"):
        q5, k5, v5 = (torch.cat([t] * 5, dim=-1)[..., :264].contiguous() for t in (q, k, v))
        gqa_decode(q5, k5, v5, lens)
    with pytest.raises(ValueError, match="CUDA tensors"):
        gqa_kernel.gqa_decode_cuda(q.cpu(), k.cpu(), v.cpu(), lens.cpu())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("head_dim", [16, 24, 32, 64, 112, 128, 192, 256])
@pytest.mark.parametrize("group", [1, 5, 17, 32, 48, 96])
def test_gqa_decode_instances_fit_the_card(device, dtype, head_dim, group):
    """Every instance (per dtype, head-dim bucket and group bucket) takes
    its shared memory and keeps at least one CTA resident per SM."""
    info = gqa_kernel.instance_info(dtype, head_dim, group)
    assert 0 < info["smem_bytes"] <= 227 * 1024 and info["ctas_per_sm"] >= 1
    assert info["stages"] >= 1 and info["tile_rows"] in (32, 64) and info["registers"] > 0
    assert info["heads_per_cta"] >= min(group, 4)


def test_gqa_decode_launcher_refuses_bad_arguments(device):
    """The C entry point refuses what it does not take, without a launch:
    an unknown dtype (-2), a head dim that is not a multiple of 8 or above
    256 (-3), an empty group, splits that do not cover the cache, or several
    splits without scratch (-1)."""
    lib = build.library("gqa_decode")
    q, k, v, lens = _gqa_operands(device, "kernels_dh128", torch.float32)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream

    def rc(dtype=0, n_g=3, n_dh=128, n_split=1, rows=64):
        return lib.gqa_decode_launch(dtype, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                     lens.data_ptr(), out.data_ptr(), None, None, None, 2, 64,
                                     4, n_g, n_dh, n_split, rows, stream)

    assert rc() == 0
    assert rc(dtype=2) == -2
    assert rc(n_dh=44) == -3
    assert rc(n_dh=264) == -3
    assert rc(n_g=0) == -1
    assert rc(rows=32) == -1
    assert rc(n_split=2, rows=32) == -1
    torch.cuda.synchronize()


# B4: both sides compute in fp32 and differ by the order of the sums over N,
# over a chunk and along the chunk chain (the kernel's 64-step chunks, the
# plain version's own): SSD_RTOL of the largest output magnitude. A bf16 y
# may then round one bf16 ulp apart (BF16_RTOL); the state is always fp32.
SSD_RTOL = 2e-5

# name -> (B, S, H, P, N, G, dtype of x, B and C)
SSD_CASES = {
    "step": (4, 1, 8, 64, 128, 1, torch.bfloat16),
    "S127": (2, 127, 4, 64, 128, 1, torch.float32),
    "S128": (2, 128, 4, 64, 128, 1, torch.bfloat16),
    "S129": (2, 129, 4, 64, 128, 1, torch.float32),
    "S1000": (1, 1000, 4, 64, 128, 1, torch.bfloat16),
    "group_per_head": (2, 100, 6, 32, 32, 6, torch.float32),
    "P16_N16": (2, 70, 4, 16, 16, 2, torch.float32),
    "P32_N64": (3, 65, 4, 32, 64, 4, torch.bfloat16),
    "P128_N128": (1, 90, 2, 128, 128, 1, torch.float32),
    "one_lane_one_head": (1, 33, 1, 64, 128, 1, torch.float32),
    "step_P6": (3, 1, 4, 6, 16, 2, torch.float32),
    "step_P256": (2, 1, 4, 256, 128, 1, torch.bfloat16),
}


def _ssd_operands(device, B, S, H, P, N, G, dtype, seed, decay_scale=1.0, model_like=False):
    """``model_like``: mamba2's slow decays (A = -1..-16 over the heads, dt
    about 0.01), so the state carries over the whole sequence, as
    ``chip_smoke._ssd_case`` draws them."""
    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=device) * scale

    x = rnd(B, S, H, P).to(dtype)
    if model_like:
        dt = torch.nn.functional.softplus(rnd(B, S, H) * 0.5 - 4.6)
        A = -torch.linspace(1.0, 16.0, H, device=device)
    else:
        dt = torch.nn.functional.softplus(rnd(B, S, H))
        A = -torch.exp(rnd(H)) * decay_scale
    Bm, Cm = rnd(B, S, G, N, scale=0.3).to(dtype), rnd(B, S, G, N, scale=0.3).to(dtype)
    D = rnd(H, scale=0.1)
    s0 = rnd(B, H, N, P, scale=0.1)
    return x, dt, A, Bm, Cm, D, s0


def _ssd_close(y, state, ry, rstate):
    assert torch.isfinite(y.float()).all() and torch.isfinite(state).all()
    ymax = ry.float().abs().max().item()
    tol = SSD_RTOL * ymax + (BF16_RTOL * ymax if y.dtype == torch.bfloat16 else 0.0)
    err = (y.float() - ry.float()).abs().max().item()
    assert err <= tol, ("y", err, tol)
    smax = rstate.abs().max().item()
    err = (state - rstate).abs().max().item()
    assert err <= SSD_RTOL * smax, ("state", err, SSD_RTOL * smax)


@pytest.mark.parametrize("with_s0", [True, False], ids=["s0", "zero_state"])
@pytest.mark.parametrize("case", sorted(SSD_CASES))
def test_ssd_kernel_matches_plain(device, case, with_s0):
    B, S, H, P, N, G, dtype = SSD_CASES[case]
    x, dt, A, Bm, Cm, D, s0 = _ssd_operands(device, B, S, H, P, N, G, dtype,
                                            sorted(SSD_CASES).index(case))
    s0 = s0 if with_s0 else None
    before = ssd_kernel.LAUNCHES
    y, state = ssd(x, dt, A, Bm, Cm, D, initial_state=s0)
    assert ssd_kernel.LAUNCHES == before + 1
    ry, rstate = ssd_ref(x, dt, A, Bm, Cm, D, initial_state=s0)
    torch.cuda.synchronize()
    assert y.dtype == dtype and y.shape == x.shape and state.dtype == torch.float32
    _ssd_close(y, state, ry, rstate)


@pytest.mark.parametrize("S", [1, 100])
def test_ssd_kernel_writes_the_state_in_place(device, S):
    """The new state overwrites the one it started from (decode's cache)."""
    x, dt, A, Bm, Cm, D, s0 = _ssd_operands(device, 4, S, 8, 64, 128, 1, torch.bfloat16, 7)
    ry, rstate = ssd_ref(x, dt, A, Bm, Cm, D, initial_state=s0)
    ptr = s0.data_ptr()
    y, state = ssd(x, dt, A, Bm, Cm, D, initial_state=s0, state_out=s0)
    torch.cuda.synchronize()
    assert state is s0 and s0.data_ptr() == ptr
    _ssd_close(y, state, ry, rstate)


def test_ssd_kernel_strided_and_unaligned_operands(device):
    """x, B and C as views of wider rows (the model-side strides) and at an
    odd element offset; dt as a transposed view."""
    B, S, H, P, N, G = 2, 77, 4, 32, 64, 2
    x, dt, A, Bm, Cm, D, s0 = _ssd_operands(device, B, S, H, P, N, G, torch.bfloat16, 8)
    xw = torch.zeros((B, S, H, P + 3), dtype=x.dtype, device=device)
    xw[..., 1:P + 1] = x
    bcw = torch.zeros((B, S, G, 2 * N + 1), dtype=Bm.dtype, device=device)
    bcw[..., 1:N + 1], bcw[..., N + 1:] = Bm, Cm
    dtt = dt.transpose(0, 1).contiguous().transpose(0, 1)
    xo, bo, co = xw[..., 1:P + 1], bcw[..., 1:N + 1], bcw[..., N + 1:]
    assert xo.data_ptr() % 4 and not xo.is_contiguous() and not dtt.is_contiguous()
    y, state = ssd(xo, dtt, A, bo, co, D, initial_state=s0)
    ry, rstate = ssd_ref(x, dt, A, Bm, Cm, D, initial_state=s0)
    torch.cuda.synchronize()
    _ssd_close(y, state, ry, rstate)


@pytest.mark.parametrize("S", [1, 200])
def test_ssd_kernel_underflowing_decay_is_finite(device, S):
    """Decays so strong (A dt <= -500 at every step) that exp(lambda)
    underflows to 0: the masked exponentials stay finite, the state forgets
    a huge s0, and y is each step's own C . B x dt + D x."""
    H = 4
    x, _, _, Bm, Cm, D, s0 = _ssd_operands(device, 2, S, H, 64, 128, 1, torch.float32, 9)
    g = torch.Generator(device=device).manual_seed(13)
    dt = torch.nn.functional.softplus(torch.randn((2, S, H), generator=g, device=device)) + 0.5
    A = -1000.0 * (1.0 + torch.rand((H,), generator=g, device=device))
    s0 = s0 * 1e6
    assert (torch.exp(A * dt) == 0).all()
    y, state = ssd(x, dt, A, Bm, Cm, D, initial_state=s0)
    ry, rstate = ssd_ref(x, dt, A, Bm, Cm, D, initial_state=s0)
    torch.cuda.synchronize()
    _ssd_close(y, state, ry, rstate)
    assert state.abs().max().item() < 1e3


def test_ssd_kernel_mixed_dtypes(device):
    """A bf16 x with fp32 B and C (``test_kernels.py``'s bf16 case) and
    the reverse."""
    x, dt, A, Bm, Cm, D, s0 = _ssd_operands(device, 2, 90, 4, 64, 64, 1, torch.float32, 10)
    for xd, bd in ((torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)):
        args = (x.to(xd), dt, A, Bm.to(bd), Cm.to(bd), D)
        y, state = ssd(*args, initial_state=s0)
        ry, rstate = ssd_ref(*args, initial_state=s0)
        torch.cuda.synchronize()
        _ssd_close(y, state, ry, rstate)


@pytest.mark.parametrize("x_dtype,bc_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)],
    ids=["bf16", "fp32", "bf16_x", "bf16_bc"])
@pytest.mark.parametrize("N", [16, 64, 128])
def test_ssd_chunk_kernel_fits_the_card(device, N, x_dtype, bc_dtype):
    """Every chunk kernel instance the launcher can pick: the mma kernel
    (bf16 x, B, C) and the fp32 one (the other three)."""
    info = ssd_kernel.instance_info(x_dtype, bc_dtype, N)
    assert 0 < info["smem_bytes"] <= 227 * 1024 and info["ctas_per_sm"] >= 1
    assert 0 < info["registers"] <= 255
    mma = x_dtype == bc_dtype == torch.bfloat16
    assert (info["max_heads_per_cta"], info["p_slice"]) == ((5, 32) if mma else (1, 64))


def test_ssd_plan_fills_one_round_at_the_mamba2_shape(device):
    """On this card the plan of the mamba2 serve shape runs every CTA in
    one round of resident CTAs."""
    hb, grid = ssd_kernel.plan(4, 80, 1, 64, 128)
    info = ssd_kernel.instance_info(torch.bfloat16, torch.bfloat16, 128)
    ctas = grid[0] * grid[1] * grid[2]
    assert hb >= 2 and ctas <= ssd_kernel._sm_count(0) * info["ctas_per_sm"]


@pytest.mark.parametrize("G", [1, 2, 6])
@pytest.mark.parametrize("P", [8, 64, 256])
@pytest.mark.parametrize("N", [16, 64, 128])
def test_ssd_mma_kernel_shapes(device, N, P, G):
    """The mma chunk kernel (bf16 x, B, C) at state sizes and head dims
    below, at and above its 128 rows and 32-column slices, one group, two
    and a group per head, from s0."""
    x, dt, A, Bm, Cm, D, s0 = _ssd_operands(device, 2, 70, 6, P, N, G, torch.bfloat16,
                                            1000 + 100 * G + N + P)
    y, state = ssd(x, dt, A, Bm, Cm, D, initial_state=s0)
    ry, rstate = ssd_ref(x, dt, A, Bm, Cm, D, initial_state=s0)
    torch.cuda.synchronize()
    _ssd_close(y, state, ry, rstate)


@pytest.mark.parametrize("S", [2, 63, 64, 65, 1024])
def test_ssd_mma_kernel_lengths(device, S):
    """Sequences of one chunk and the edges of the second, and a long one
    with mamba2's slow decays (the state carries over all 1024 steps)."""
    x, dt, A, Bm, Cm, D, s0 = _ssd_operands(device, 2, S, 8, 64, 128, 1, torch.bfloat16,
                                            2000 + S, model_like=True)
    for init in (None, s0):
        y, state = ssd(x, dt, A, Bm, Cm, D, initial_state=init)
        ry, rstate = ssd_ref(x, dt, A, Bm, Cm, D, initial_state=init)
        torch.cuda.synchronize()
        _ssd_close(y, state, ry, rstate)


@pytest.mark.parametrize("H,G", [(13, 1), (14, 2), (7, 7)])
def test_ssd_mma_kernel_ragged_head_blocks(device, H, G):
    """Heads per group that the CTA's head block does not divide: the last
    block of each group holds fewer heads."""
    hb, _ = ssd_kernel.plan(2, H, G, 64, 128)
    assert (H // G) % hb or H == G
    x, dt, A, Bm, Cm, D, s0 = _ssd_operands(device, 2, 130, H, 64, 128, G, torch.bfloat16,
                                            3000 + H, model_like=True)
    y, state = ssd(x, dt, A, Bm, Cm, D, initial_state=s0)
    ry, rstate = ssd_ref(x, dt, A, Bm, Cm, D, initial_state=s0)
    torch.cuda.synchronize()
    _ssd_close(y, state, ry, rstate)


def test_ssd_mma_kernel_aligned_strided_views(device):
    """x, B and C as 16-byte aligned views of wider rows, as the model's
    in-projection hands them over: the kernel copies them with cp.async
    through their strides; the state written in place at S = 1024."""
    B, S, H, P, N = 2, 1024, 8, 64, 128
    x, dt, A, Bm, Cm, D, s0 = _ssd_operands(device, B, S, H, P, N, 1, torch.bfloat16, 4000,
                                            model_like=True)
    xw = torch.zeros((B, S, H, P + 8), dtype=x.dtype, device=device)
    xw[..., :P] = x
    bcw = torch.zeros((B, S, 1, 2 * N + 8), dtype=Bm.dtype, device=device)
    bcw[..., 8:N + 8], bcw[..., N + 8:] = Bm, Cm
    xo, bo, co = xw[..., :P], bcw[..., 8:N + 8], bcw[..., N + 8:]
    assert not xo.is_contiguous() and bo.data_ptr() % 16 == 0 and co.data_ptr() % 16 == 0
    ry, rstate = ssd_ref(x, dt, A, Bm, Cm, D, initial_state=s0)
    y, state = ssd(xo, dt, A, bo, co, D, initial_state=s0, state_out=s0)
    torch.cuda.synchronize()
    assert state is s0
    _ssd_close(y, state, ry, rstate)


def test_ssd_refuses_what_the_kernel_does_not_take_on_the_card(device):
    x, dt, A, Bm, Cm, D, s0 = _ssd_operands(device, 1, 8, 4, 16, 16, 2, torch.float32, 11)
    with pytest.raises(ValueError, match="on cpu, expected cuda"):
        ssd(x, dt.cpu(), A, Bm, Cm, D)
    with pytest.raises(ValueError, match="unit last stride"):
        ssd(x.transpose(2, 3).contiguous().transpose(2, 3), dt, A, Bm, Cm, D)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_kernel.ssd_cuda(*(t.cpu() for t in (x, dt, A, Bm, Cm, D, s0)), x.cpu(), s0.cpu())


def test_ssd_launcher_refuses_bad_arguments(device):
    """The C entry point refuses what it does not take, without a launch:
    an unknown dtype (-2), N above 128 or P above 256 (-3), heads that do
    not group or, for the mma chunk kernel, a head block outside 1..5 (-1),
    a missing operand (-4)."""
    import ctypes

    lib = build.library("ssd")
    x, dt, A, Bm, Cm, D, s0 = _ssd_operands(device, 1, 8, 4, 16, 16, 2, torch.float32, 12)
    y, state = torch.empty_like(x), torch.empty_like(s0)
    strides = (ctypes.c_longlong * 12)(*x.stride()[:3], *dt.stride(), *Bm.stride()[:3],
                                        *Cm.stride()[:3])
    stream = torch.cuda.current_stream().cuda_stream

    xb, Bb, Cb = (t.to(torch.bfloat16) for t in (x, Bm, Cm))
    yb = torch.empty_like(xb)

    def rc(x_dtype=0, n_h=4, n_p=16, n_n=16, y_ptr=y.data_ptr(), heads_per_cta=1):
        return lib.ssd_launch(x_dtype, 0, x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                              Bm.data_ptr(), Cm.data_ptr(), D.data_ptr(), s0.data_ptr(), y_ptr,
                              state.data_ptr(), 1, 8, n_h, 2, n_p, n_n, heads_per_cta, strides,
                              stream)

    def rc_bf16(heads_per_cta):
        return lib.ssd_launch(1, 1, xb.data_ptr(), dt.data_ptr(), A.data_ptr(), Bb.data_ptr(),
                              Cb.data_ptr(), D.data_ptr(), s0.data_ptr(), yb.data_ptr(),
                              state.data_ptr(), 1, 8, 4, 2, 16, 16, heads_per_cta, strides,
                              stream)

    assert rc() == 0
    assert rc_bf16(2) == 0
    assert rc_bf16(0) == -1 and rc_bf16(6) == -1
    assert rc(x_dtype=2) == -2
    assert rc(n_n=129) == -3
    assert rc(n_p=257) == -3
    assert rc(n_h=3) == -1
    assert rc(y_ptr=None) == -4
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# The batch serving steps as CUDA graphs (``training/graphs.py``)
# ---------------------------------------------------------------------------

# (arch, --engine override, config overrides, prompt length): one config of
# each block kind and each engine at full width, the int8 instances of the
# layer and the stack among them, cut to 2 layers where deeper; the second
# pallas case has a prompt of two B3 chunks.
GRAPH_CASES = {
    "stacked_fused_stack": ("sru-paper-large-stacked", None, {"n_layers": 2}, 64),
    "fused": ("qrnn-paper-large-fused", None, {}, 64),
    "pallas": ("sru-paper-large", "pallas", {}, 64),
    "pallas_two_chunks": ("qrnn-paper-large", "pallas", {}, 100),
    "chunked": ("sru-paper-large", None, {}, 64),
    "sequential": ("qrnn-paper-large", "sequential", {}, 64),
    "associative": ("sru-paper-large", "associative", {}, 64),
    "lstm": ("lstm-paper-large", None, {}, 64),
    "stacked_int8": ("qrnn-paper-large-stacked-int8", None, {"n_layers": 2}, 64),
    "fused_int8": ("sru-paper-large-int8", None, {}, 64),
    "llama3": ("llama3-8b", None, {"n_layers": 2}, 64),
    "smollm": ("smollm-360m", None, {"n_layers": 2}, 64),
    "mamba2": ("mamba2-2.7b", None, {"n_layers": 2}, 64),
}
GRAPH_LOGIT_TOL = 3e-5  # fp32 logits that are not bitwise equal; bf16 must be


def _serve_steps(cfg, prefill, decode, params, inputs, steps):
    """A prefill and ``steps`` greedy decode steps: (tokens, logits of each
    step, the caches' storage kept, the launches counted)."""
    with graphs.uncounted() as launches:
        logits, caches = prefill(params, inputs)
        storage = [t.data_ptr() for t in graphs.leaves(caches)]
        outs, toks = [logits.clone()], []
        for _ in range(steps):
            toks.append(serve._greedy(cfg, logits))
            logits, caches = decode(params, caches, toks[-1])
            outs.append(logits.clone())
        in_place = [t.data_ptr() for t in graphs.leaves(caches)] == storage
    torch.cuda.synchronize()
    return torch.cat(toks, dim=1), outs, in_place, launches


@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_captured_steps_match_the_eager_steps(device, case):
    """Captured prefill plus 8 captured decode steps, twice over, against the
    eager steps on the same params and prompt: the same greedy tokens, logits
    bitwise equal (or, in fp32, within GRAPH_LOGIT_TOL; the difference is in
    the message), the same launches of each kernel counted, and the caches
    the graphs replay over kept where they are."""
    arch, engine, overrides, prompt_len = GRAPH_CASES[case]
    cfg = get_config(arch).with_(**overrides)
    if engine:
        cfg = cfg.with_(scan_engine=engine)
    params = lm.lm_init(torch.Generator(device=device).manual_seed(0), cfg, device=device,
                        dtype=_dtype(cfg.compute_dtype))
    g = torch.Generator().manual_seed(1)
    inputs = {"inputs": torch.randint(0, cfg.vocab, (4, prompt_len), generator=g).to(device)}
    steps = 8
    prefill = build_prefill_step(cfg, batch=4, max_len=prompt_len + steps + 1, device=device)
    decode = build_decode_step(cfg)
    eager = _serve_steps(cfg, prefill, decode, params, inputs, steps)
    assert eager[2]
    cap_prefill, cap_decode = serve.capture_batch_steps(cfg, prefill, decode, params, inputs)
    graph_caches = [t.data_ptr() for t in graphs.leaves(cap_prefill.outputs[1])]
    for _ in range(2):
        toks, outs, in_place, launches = _serve_steps(cfg, cap_prefill, cap_decode, params,
                                                      inputs, steps)
        assert torch.equal(toks, eager[0])
        for i, (got, want) in enumerate(zip(outs, eager[1])):
            err = (got.float() - want.float()).abs().max().item()
            assert torch.equal(got, want) or (got.dtype == torch.float32
                                              and err <= GRAPH_LOGIT_TOL), (i, err)
        assert in_place and launches == eager[3]
        assert [t.data_ptr() for t in graphs.leaves(cap_prefill.outputs[1])] == graph_caches
