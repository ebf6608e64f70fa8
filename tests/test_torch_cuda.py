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
caches kept where they are. And the continuous-batching Scheduler
(``serving/engine.py``) with its five steps captured, at full width (two
layers) for B2, B1, B3 and B2 int8: against the eager Scheduler at async
depth 1 and 2 on a shared-prefix trace with the prefix cache on, the same
tokens and logits bit for bit, the launches its steps account for, the pool
kept where it is; two lanes snapshotted, then two injected, in one tick,
every state kept; and a capture that fails raising, with no eager fallback.
And speculative decode (the draft pool's graphs, the k-step draft block as
one graph, the target's verify graph): the captured speculative Scheduler
against the eager one at depth 1 and 2, fp32 and bf16, for the same four
configs with the floor draft, tokens, logits rows and counters bit for bit,
rollbacks, launches, both pools in place; the draft block graph against k
replays of the draft's one-step graph, bit for bit; two rollbacks in one
tick after the snapshot graph replayed again, both lanes restored bit for
bit; and a verify step that cannot be captured raising. And telemetry on
the card: the captured Scheduler (plain and speculative, the four configs)
with every sink and the profiler's step annotations on gives the tokens,
logits rows and launches of the run without, still captured, with a trace
``tools/trace_check.py`` accepts; ``serve --torch-profile``'s trace names
the tick phases and holds the graph replays' kernels under them.

And training: the fused kernels' autograd Functions (``ops.fused_layer``,
``stacked.fused_stack``; fp and int8 slabs, both IO dtypes) on the card
against autograd through their plain versions, their forwards launching
the kernel and their backwards only the linear scan; and the gradients of ``lm_loss`` on
the card (B2, B1, B3 and an attention LM, fp32, reduced) against the CPU's.
And the archs served last, reduced, in fp32: granite-20b, the frontend stubs
internvl2-2b and musicgen-large, and the hybrid zamba2-7b (also with a tail),
their captured batch steps on the card against the eager steps on the CPU.

They skip, with that reason, on a machine without a CUDA device (decided in
the ``device`` fixture, not at import) and run on the card with
``PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py``. The
main-path shapes and timings are ``chip_smoke.py``'s.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.kernels import build
from repro_torch.kernels.fused_rnn import fused_rnn, layout, ops, stacked
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
from repro_torch.serving import (Request, Scheduler, clone_trace, poisson_trace,
                                 shared_prefix_trace)
from repro_torch.training import graphs
from repro_torch.training.steps import build_decode_step, build_prefill_step
from repro_torch.tree import tree_leaves, unflatten_like

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
    ("fused_rnn_layer_int8", ((0, 0), (1, 1), (0, 1))),
])
def test_kernel_refuses_an_unknown_weight_type(device, lib_name, own_pairs):
    """A (dtype, wdtype) pair the library has no instance for returns -2 and
    launches nothing: the output keeps its sentinel. The fp build has no int8
    instance and the int8 build no fp one; bf16 IO takes no fp32 slabs."""
    T, B, d, H = 2, 1, 8, 8
    u = torch.zeros((T, B, d), device=device)
    w = torch.zeros((d, 3, H), device=device)
    b3, c0 = torch.zeros((3, H), device=device), torch.zeros((B, H), device=device)
    scale = torch.ones((3, 1), device=device)
    h, c_last = torch.full((T, B, H), 7.0, device=device), torch.empty((B, H), device=device)
    lib = build.library(lib_name)
    for dtype, wdtype in ((1, 0), (2, 2), (0, 5)) + own_pairs:
        rc = lib.fused_rnn_layer_launch(
            dtype, wdtype, u.data_ptr(), w.data_ptr(), None, scale.data_ptr(), b3.data_ptr(),
            c0.data_ptr(), None, u.data_ptr(), None, h.data_ptr(), c_last.data_ptr(),
            T, B, d, H, 2, 0, 1, 1, 16, 0,
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
            cluster, k_tile, 0, torch.cuda.current_stream(device).cuda_stream,
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("S", [32, 4096])
def test_gqa_decode_kernel_lse_form_matches_plain(device, S, dtype):
    """The log-sum-exp form with one split and with many, lanes of length
    0 among them: the output as the plain version's (0 on an empty lane),
    the lse within 2e-5 where the length is above 0 and -inf exactly where
    it is 0; counted apart from B5's other launches."""
    B, Hkv, G, Dh = 6, 1, 48, 128
    g = torch.Generator(device=device).manual_seed(S + 7)
    q = torch.randn((B, Hkv * G, Dh), generator=g, device=device).to(dtype)
    k, v = (torch.randn((B, S, Hkv, Dh), generator=g, device=device).to(dtype)
            for _ in range(2))
    lens = torch.tensor([0, S, 1, 0, S // 2 + 3, 17], dtype=torch.int32, device=device)
    before, before_lse = gqa_kernel.LAUNCHES, gqa_kernel.LAUNCHES_LSE
    out, lse = gqa_decode(q, k, v, lens, return_lse=True)
    assert (gqa_kernel.LAUNCHES, gqa_kernel.LAUNCHES_LSE) == (before, before_lse + 1)
    ref, ref_lse = gqa_decode_ref(q, k, v, lens, return_lse=True)
    torch.cuda.synchronize()
    empty = (lens == 0)[:, None].expand_as(lse)
    assert torch.equal(torch.isneginf(lse), empty) and torch.equal(torch.isneginf(ref_lse), empty)
    assert bool((out[lens == 0] == 0).all())
    _close((out,), (ref,), dtype)
    assert (lse[~empty] - ref_lse[~empty]).abs().max().item() <= 2e-5


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
                                     lens.data_ptr(), out.data_ptr(), None, None, None, None, 2,
                                     64, 4, n_g, n_dh, n_split, rows, stream)

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
# layer and the stack among them, cut to 2 layers where deeper (the MoE
# configs and nemotron-4-340b to 1); the second pallas case has a prompt of
# two B3 chunks.
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
    "mixtral": ("mixtral-8x22b", None, {"n_layers": 1}, 64),
    "qwen3": ("qwen3-moe-235b-a22b", None, {"n_layers": 1}, 64),
    "nemotron": ("nemotron-4-340b", None, {"n_layers": 1}, 64),
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


# ---------------------------------------------------------------------------
# Continuous batching: the Scheduler's five steps as CUDA graphs
# ---------------------------------------------------------------------------

# (arch, --engine override, config overrides): a config for each kernel on
# the path, at full width, cut to 2 layers where deeper.
ENGINE_GRAPH_CASES = {
    "stacked": ("sru-paper-large-stacked", None, {"n_layers": 2}),
    "fused": ("qrnn-paper-large-fused", None, {}),
    "pallas": ("sru-paper-large", "pallas", {}),
    "stacked_int8": ("qrnn-paper-large-stacked-int8", None, {"n_layers": 2}),
}


class _TickClock:
    """An engine clock that moves 1 ms at every read: both engines see the
    same arrivals whatever the host's speed."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1e-3
        return self.t


def _engine_case(device, case):
    arch, engine, overrides = ENGINE_GRAPH_CASES[case]
    cfg = get_config(arch).with_(**overrides)
    if engine:
        cfg = cfg.with_(scan_engine=engine)
    params = lm.lm_init(torch.Generator(device=device).manual_seed(0), cfg, device=device,
                        dtype=_dtype(cfg.compute_dtype))
    return cfg, params


def _serve_engine(cfg, params, device, trace, **kw):
    eng = Scheduler(cfg, params, batch=4, prefix_cache_mb=8.0, trace_logits=True,
                    clock=_TickClock(), device=device, **kw)
    eng.warmup()
    with graphs.uncounted() as launches:
        eng.run(clone_trace(trace), max_ticks=2000)
    torch.cuda.synchronize()
    return eng, launches


@pytest.mark.parametrize("case", sorted(ENGINE_GRAPH_CASES))
@pytest.mark.parametrize("depth", [1, 2])
def test_captured_scheduler_matches_the_eager_scheduler(device, case, depth):
    """A shared-prefix trace (prompts of 70: two 32-token chunks and a tail,
    the first chunk shared by half) through the eager Scheduler at depth 1
    and the captured one at ``depth``: every stream's tokens and traced
    logits rows bit for bit, prefix hits, each run's launches equal to its
    prefill chunks plus decode steps times the step's launches, the pool's
    leaves where they were allocated."""
    cfg, params = _engine_case(device, case)
    trace = shared_prefix_trace(12, rate=0.0, prefix_len=32, prompt_len=70, share=0.5,
                                vocab=cfg.vocab, seed=3, gen_mix=((4, 0.5), (12, 0.5)))
    eager, eager_launches = _serve_engine(cfg, params, device, trace, graphs=False)
    captured, launches = _serve_engine(cfg, params, device, trace, async_depth=depth)
    assert not eager.captured and captured.captured and captured.capture_ms > 0
    for eng, counted in ((eager, eager_launches), (captured, launches)):
        m = eng.metrics
        assert m.completed == len(trace) and m.prefix_hits > 0 and eng.cache_in_place
        assert sum(counted) == cfg.n_layers * (m.prefill_chunks + m.decode_steps)
    for rid in range(len(trace)):
        assert eager.logit_trace[rid] and len(eager.logit_trace[rid]) == \
            len(captured.logit_trace[rid])
        for a, b in zip(eager.logit_trace[rid], captured.logit_trace[rid]):
            assert np.array_equal(a, b), rid


def test_captured_snapshot_and_inject_of_two_lanes_in_one_tick(device):
    """Two snapshots replayed back to back share the graph's one static
    output; each is copied out before the next replay, so both states are
    kept. Two injects replayed back to back write both lanes."""
    cfg, params = _engine_case(device, "stacked")
    eng = Scheduler(cfg, params, batch=4, prefix_cache_mb=8.0, device=device)
    eng.warmup()
    with torch.inference_mode():
        for leaf in graphs.leaves(eng.pool.caches):
            leaf.copy_(torch.randn(leaf.shape, device=device).to(leaf.dtype))
    before = [t.clone() for t in graphs.leaves(eng.pool.caches)]
    s1 = eng._snapshot(eng.pool.caches, eng._lanes[1])
    h1 = {k: eng._to_host(v) for k, v in s1["layers"].items()}
    s3 = eng._snapshot(eng.pool.caches, eng._lanes[3])
    h3 = {k: eng._to_host(v) for k, v in s3["layers"].items()}
    assert s1 is s3  # the one static output of the snapshot graph
    torch.cuda.synchronize()
    for (k, v1), b in zip(h1.items(), before):
        assert torch.equal(v1, b[:, 1].cpu()) and torch.equal(h3[k], b[:, 3].cpu())
    for lane, host in ((0, h3), (2, h1)):
        eng._inject(eng.pool.caches, eng._lanes[lane],
                    {"layers": {k: v.to(device, non_blocking=True) for k, v in host.items()}})
    torch.cuda.synchronize()
    for a, b in zip(graphs.leaves(eng.pool.caches), before):
        assert torch.equal(a[:, 0], b[:, 3]) and torch.equal(a[:, 2], b[:, 1])
        assert torch.equal(a[:, 1], b[:, 1]) and torch.equal(a[:, 3], b[:, 3])
    assert eng.cache_in_place


def test_scheduler_capture_failure_raises(device):
    """A step that cannot be captured (it waits for the host) fails the
    warm-up and every tick after it: the engine never falls back to the
    eager steps on the card."""
    cfg, params = _engine_case(device, "fused")
    eng = Scheduler(cfg, params, batch=4, device=device)
    decode = eng._decode

    def waits_for_the_host(params, caches, token, mask):
        out = decode(params, caches, token, mask)
        out[0].sum().item()
        return out

    eng._decode = waits_for_the_host
    with pytest.raises(RuntimeError, match="capturing"):
        eng.warmup()
    assert not eng.captured and eng._decode is waits_for_the_host
    eng.submit(Request(rid=0, prompt=np.arange(8), max_new_tokens=2))
    with pytest.raises(RuntimeError, match="capturing"):
        eng.tick()
    assert eng.metrics.ticks == 0


# ---------------------------------------------------------------------------
# Speculative decode: the draft pool's graphs, the draft block, the verify
# ---------------------------------------------------------------------------

def _spec_case(device, case, dtype):
    """The target of ``case`` and the floor draft (``sru-paper-draft``, seed
    1), both computing in ``dtype``."""
    arch, engine, overrides = ENGINE_GRAPH_CASES[case]
    cfg = get_config(arch).with_(compute_dtype=dtype, **overrides)
    if engine:
        cfg = cfg.with_(scan_engine=engine)
    dcfg = get_config("sru-paper-draft").with_(compute_dtype=dtype)
    made = [lm.lm_init(torch.Generator(device=device).manual_seed(seed), c, device=device,
                       dtype=_dtype(dtype)) for seed, c in ((0, cfg), (1, dcfg))]
    return cfg, made[0], dcfg, made[1]


def _spec_engine(device, cfg, params, dcfg, dparams, trace, **kw):
    eng = Scheduler(cfg, params, batch=4, trace_logits=True, clock=_TickClock(), device=device,
                    draft_cfg=dcfg, draft_params=dparams, spec_k=4, **kw)
    eng.warmup()
    with graphs.uncounted() as launches:
        eng.run(clone_trace(trace), max_ticks=4000)
    torch.cuda.synchronize()
    return eng, launches


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(ENGINE_GRAPH_CASES))
@pytest.mark.parametrize("depth", [1, 2])
def test_captured_speculative_scheduler_matches_the_eager_one(device, case, depth, dtype):
    """A Poisson trace (prompts of 5, 40 and 70: tails, chunks and chunks
    with a tail) through the eager and the captured speculative Scheduler,
    both at ``depth`` (a lane speculates every other tick at depth 2, so the
    counters depend on it), floor draft, k = 4: every stream's tokens and
    traced logits rows bit for bit, the same speculative counters, rollbacks,
    each run's launches equal to the target's prefill chunks, decode steps
    and verify steps times its layers (the draft runs no kernel of ours),
    both pools kept where they were allocated."""
    cfg, params, dcfg, dparams = _spec_case(device, case, dtype)
    trace = poisson_trace(10, rate=0.0, prompt_lens=[5, 40, 70], vocab=cfg.vocab, seed=4,
                          gen_mix=((4, 0.5), (12, 0.5)))
    eager, eager_launches = _spec_engine(device, cfg, params, dcfg, dparams, trace,
                                         graphs=False, async_depth=depth)
    captured, launches = _spec_engine(device, cfg, params, dcfg, dparams, trace,
                                      async_depth=depth)
    assert not eager.captured and captured.captured and captured.capture_ms > 0
    counters = ("verify_steps", "draft_steps", "spec_cycles", "spec_accepted", "spec_rollbacks",
                "decode_steps", "prefill_chunks")
    reps = [eng.metrics.report() for eng in (eager, captured)]
    assert {c: reps[0][c] for c in counters} == {c: reps[1][c] for c in counters}
    assert reps[1]["spec_rollbacks"] > 0 and reps[1]["completed"] == len(trace)
    for eng, counted, rep in ((eager, eager_launches, reps[0]), (captured, launches, reps[1])):
        assert eng.cache_in_place and eng.idle
        assert sum(counted) == cfg.n_layers * (rep["prefill_chunks"] + rep["decode_steps"]
                                               + rep["verify_steps"])
    for rid in range(len(trace)):
        assert eager.logit_trace[rid] and len(eager.logit_trace[rid]) == \
            len(captured.logit_trace[rid])
        for a, b in zip(eager.logit_trace[rid], captured.logit_trace[rid]):
            assert np.array_equal(a, b), rid


def _random_pool(device, caches, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    with torch.inference_mode():
        for leaf in graphs.leaves(caches):
            leaf.copy_(torch.randn(leaf.shape, generator=g, device=device).to(leaf.dtype))
    return [t.clone() for t in graphs.leaves(caches)]


def test_draft_block_graph_equals_k_single_step_calls(device):
    """The draft block (k = 4 steps and their input choice, one graph)
    against four replays of the draft's captured one-step graph with each
    column chosen the same way: the same block and the same draft caches,
    bit for bit, from the same random pool; lane 2, outside the mask, keeps
    its bits."""
    cfg, params, dcfg, dparams = _spec_case(device, "fused", "bfloat16")
    eng = Scheduler(cfg, params, batch=4, device=device, draft_cfg=dcfg, draft_params=dparams,
                    spec_k=4)
    eng.warmup()
    start = _random_pool(device, eng.draft_caches, 5)
    toks = torch.randint(0, cfg.vocab, (4, 4), device=device)
    src = torch.arange(4, device=device)[None, :] < torch.tensor([[1], [4], [2], [3]],
                                                                  device=device)
    mask = torch.tensor([True, True, False, True], device=device)
    with graphs.uncounted():
        block = eng._d_block(dparams, eng.draft_caches, toks, src, mask).clone()
        after_block = [t.clone() for t in graphs.leaves(eng.draft_caches)]
        with torch.inference_mode():
            for leaf, s in zip(graphs.leaves(eng.draft_caches), start):
                leaf.copy_(s)
        prev, cols = torch.zeros(4, dtype=torch.int64, device=device), []
        for p in range(4):
            col = torch.where(src[:, p], toks[:, p], prev)
            cols.append(col)
            prev = eng._d_decode(dparams, eng.draft_caches, col[:, None], mask)[0].clone()
    torch.cuda.synchronize()
    assert torch.equal(block, torch.stack(cols, 1))
    for a, b, s in zip(graphs.leaves(eng.draft_caches), after_block, start):
        assert torch.equal(a, b) and torch.equal(a[:, 2], s[:, 2])
    assert eng.cache_in_place


def test_two_rollbacks_in_one_tick_restore_both_lanes(device):
    """Lanes 1 and 3 snapshotted into their rollback buffers (both pools),
    the snapshot graphs replayed once more for lane 0, both pools then
    overwritten: injecting the two buffers restores lanes 1 and 3 bit for
    bit and leaves lanes 0 and 2 as they were overwritten; both pools stay
    where they were allocated."""
    cfg, params, dcfg, dparams = _spec_case(device, "stacked_int8", "bfloat16")
    eng = Scheduler(cfg, params, batch=4, device=device, draft_cfg=dcfg, draft_params=dparams,
                    spec_k=4)
    eng.warmup()
    pools = ((eng._snapshot, eng._inject, eng.pool.caches, eng._rollback),
             (eng._d_snapshot, eng._d_inject, eng.draft_caches, eng._d_rollback))
    before = [_random_pool(device, caches, 7 + i) for i, (_, _, caches, _) in enumerate(pools)]
    with graphs.uncounted():
        for snapshot, _, caches, buffers in pools:
            for lane in (1, 3):
                eng._snapshot_into(snapshot, caches, lane, buffers[lane])
            snapshot(caches, eng._lanes[0])
        after = [_random_pool(device, caches, 20 + i) for i, (_, _, caches, _) in enumerate(pools)]
        for _, inject, caches, buffers in pools:
            for lane in (1, 3):
                inject(caches, eng._lanes[lane], buffers[lane])
    torch.cuda.synchronize()
    for (_, _, caches, _), b, a in zip(pools, before, after):
        for leaf, x, y in zip(graphs.leaves(caches), b, a):
            assert torch.equal(leaf[:, 1], x[:, 1]) and torch.equal(leaf[:, 3], x[:, 3])
            assert torch.equal(leaf[:, 0], y[:, 0]) and torch.equal(leaf[:, 2], y[:, 2])
    assert eng.cache_in_place


def test_verify_capture_failure_raises(device):
    """A verify step that waits for the host fails the warm-up, and no step
    of either pool is replaced: no eager fallback on the card."""
    cfg, params, dcfg, dparams = _spec_case(device, "fused", "bfloat16")
    eng = Scheduler(cfg, params, batch=4, device=device, draft_cfg=dcfg, draft_params=dparams,
                    spec_k=4)
    verify, d_decode = eng._verify, eng._d_decode

    def waits_for_the_host(params, caches, tokens, mask):
        out = verify(params, caches, tokens, mask)
        out[0].sum().item()
        return out

    eng._verify = waits_for_the_host
    with pytest.raises(RuntimeError, match="capturing"):
        eng.warmup()
    assert not eng.captured and eng._verify is waits_for_the_host
    assert eng._d_decode is d_decode and not isinstance(eng._decode, graphs.CapturedStep)


# ---------------------------------------------------------------------------
# Telemetry on the card: every sink and the profiler's annotations on
# ---------------------------------------------------------------------------

def _repo_module(name, relpath):
    """A script of the repository (``tools/trace_check.py``,
    ``chip_smoke.py``) imported as a module."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / relpath
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _telemetry_run(device, cfg, params, trace, spec, tel=None):
    kw = dict(draft_cfg=spec[0], draft_params=spec[1], spec_k=4) if spec else {}
    eng = Scheduler(cfg, params, batch=4, async_depth=2, trace_logits=True, clock=_TickClock(),
                    device=device, telemetry=tel, **kw)
    eng.warmup()
    with graphs.uncounted() as launches:
        done = eng.run(clone_trace(trace), max_ticks=4000)
    torch.cuda.synchronize()
    return eng, sum(launches), {r.rid: list(r.tokens) for r in done}


@pytest.mark.parametrize("case", sorted(ENGINE_GRAPH_CASES))
@pytest.mark.parametrize("spec", [False, True], ids=["plain", "speculative"])
def test_captured_tokens_equal_with_telemetry_on(device, case, spec, tmp_path):
    """A Poisson trace through the captured Scheduler at depth 2 with every
    sink on (trace, metrics rows, straggler monitor) inside a torch.profiler
    capture with the step annotations on, against the same run with
    telemetry off: the steps still captured (the annotations stay outside
    the captures), every stream's tokens and logits rows bit for bit, the
    same launches; the trace passes ``trace_check``."""
    from repro_torch.observability import Telemetry, torch_profile
    from repro_torch.runtime.monitor import StepMonitor

    cfg, params, dcfg, dparams = _spec_case(device, case, "bfloat16")
    draft = (dcfg, dparams) if spec else None
    trace = poisson_trace(10, rate=0.0, prompt_lens=[5, 40, 70], vocab=cfg.vocab, seed=4,
                          gen_mix=((4, 0.5), (12, 0.5)))
    off, off_launches, off_tokens = _telemetry_run(device, cfg, params, trace, draft)
    with torch_profile(str(tmp_path / "prof"), device) as profiling:
        assert profiling
        tel = Telemetry.from_flags(trace_out="yes", metrics_jsonl=str(tmp_path / "m.jsonl"),
                                   metrics_every=4, monitor=StepMonitor(), profiling=profiling)
        on, on_launches, on_tokens = _telemetry_run(device, cfg, params, trace, draft, tel)
    tel.close()
    assert on.captured and off.captured and on.cache_in_place and on.idle
    assert on_launches == off_launches > 0
    assert on_tokens == off_tokens and len(on_tokens) == len(trace)
    for rid in range(len(trace)):
        assert off.logit_trace[rid] and len(off.logit_trace[rid]) == len(on.logit_trace[rid])
        for a, b in zip(off.logit_trace[rid], on.logit_trace[rid]):
            assert np.array_equal(a, b), rid
    want = ["decode", "fetch", "retire"] + (["draft", "verify"] if spec else [])
    errors = _repo_module("trace_check", "tools/trace_check.py").check_trace(tel.trace.to_chrome(), expect_overlap=True,
                                        expect_phases=want, epsilon_frac=0.35,
                                        epsilon_us=3000.0)
    assert errors == [], errors


def test_annotation_names_appear_in_a_cuda_profile(device, tmp_path):
    """``serve --torch-profile`` on the card: the profiler runs around the
    captures and the run, its trace names the tick phases, and the graph
    replays' kernels are found under the phase annotation of their
    ``cudaGraphLaunch`` through the correlation ids (``chip_smoke``'s
    split), none of the run's launches without its device events."""
    import json

    chip_smoke = _repo_module("chip_smoke", "chip_smoke.py")
    cfg, params = _engine_case(device, "fused")
    args = serve.parse_args(["--arch", cfg.name, "--mode", "continuous", "--requests", "8",
                             "--prompt-len", "40", "--gen-len", "8", "--async-depth", "2",
                             "--torch-profile", str(tmp_path)])
    stats = serve.run_continuous(cfg, params, args, device)
    assert stats["torch_profile"] is True and stats["graphs"] and stats["completed"] == 8
    doc = json.loads(next(tmp_path.glob("*.pt.trace.json")).read_text())
    named = {e["name"] for e in doc["traceEvents"] if e.get("cat") == "user_annotation"}
    assert {"decode", "prefill", "reset"} <= named
    split = chip_smoke.profile_split(doc, stats["ticks"])
    assert split["device_ms_per_tick_by_phase"]["decode"] > 0
    assert split["device_ms_per_tick_by_phase"]["prefill"] > 0
    assert split["lost_launching_calls"] == 0 and split["unattributed_share"] < 0.5


# ---------------------------------------------------------------------------
# Training: the fused kernels' autograd Functions and the LM's gradients
# ---------------------------------------------------------------------------

# Gradients: the Functions' backward recomputes the plain version with its
# recurrence through the linear scan (B3's chunked fold order against the
# plain walk's steps); within 5e-4 (the JAX package's gradient tolerance) of
# the largest gradient, plus a bf16 ulp of it for bf16.
GRAD_TOL = 5e-4


def _fn_operands(device, kind, cell, dtype, quant, T=13, B=3, H=200, L=2):
    g = torch.Generator(device=device).manual_seed(hash((kind, cell, quant)) % 1000)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=device) * scale).to(dtype)

    n = 2 if cell == "qrnn" else 1
    lead = (L,) if kind == "stack" else ()
    taps = tuple(rnd(*lead, H, 3, H, scale=H ** -0.5) for _ in range(n))
    kw = {"block_t": 4}
    if quant:
        if n == 2:
            w0q, w1q, scale = layout.quantize_qrnn_slabs(*taps)
            taps = (w0q, w1q)
        else:
            wq, scale = layout.quantize_slabs(taps[0])
            taps = (wq,)
        kw["sL" if kind == "stack" else "scale"] = scale
    x = rnd(T, B, H)
    if kind == "stack":
        args = (x, taps, rnd(L, 3, H, scale=0.5), (1.0 + rnd(L, H, scale=0.2).float()).to(dtype),
                rnd(L, B, H, scale=0.5), rnd(L, B, H) if cell == "qrnn" else None)
        return stacked.fused_stack, stacked.fused_rnn_stack_plain, args, kw
    kw["mode"] = "qrnn" if cell == "qrnn" else "sru_identity"
    if cell == "qrnn":
        kw["tail"] = rnd(1, B, H)
    args = (x, taps, rnd(3, H, scale=0.5), rnd(B, H, scale=0.5))
    return ops.fused_layer, fused_rnn.fused_rnn_layer_plain, args, kw


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("kind", ["layer", "stack"])
@pytest.mark.parametrize("cell", ["sru", "qrnn"])
def test_fused_function_grads_match_plain(device, cell, kind, quant, dtype):
    """The gradient of every floating operand through the Function equals
    autograd through the plain version on the card; the forward launches
    the kernel (once per layer), the backward launches none."""
    fn, plain, args, kw = _fn_operands(device, kind, cell, dtype, quant)

    def fresh():
        one = lambda t: t if not torch.is_tensor(t) else (
            t.detach().clone().requires_grad_(t.is_floating_point()))
        a = [tuple(one(t) for t in x) if isinstance(x, tuple) else one(x) for x in args]
        return a, {k: one(v) for k, v in kw.items()}

    def floating(a, k):
        flat = [t for x in a for t in (x if isinstance(x, tuple) else (x,))] + list(k.values())
        return [t for t in flat if torch.is_tensor(t) and t.requires_grad]

    a, k = fresh()
    counter = stacked if kind == "stack" else fused_rnn
    attr = "LAUNCHES_INT8" if quant else "LAUNCHES"
    before, scans = getattr(counter, attr), ls_kernel.LAUNCHES
    outs = [o for o in fn(*a, **k) if o is not None]
    forward_launches = getattr(counter, attr) - before
    cots = [torch.randn_like(o.float()).to(o.dtype) for o in outs]
    got = torch.autograd.grad(outs, floating(a, k), cots)
    layers = 2 if kind == "stack" else 1
    assert getattr(counter, attr) - before == forward_launches == layers
    assert ls_kernel.LAUNCHES - scans == 2 * layers  # the recompute's recurrence
    a2, k2 = fresh()
    want = torch.autograd.grad([o for o in plain(*a2, **k2) if o is not None],
                               floating(a2, k2), cots)
    assert len(got) == len(want) > 0
    for gx, wx in zip(got, want):
        peak = wx.float().abs().max().item()
        tol = GRAD_TOL * (1.0 + peak) + (BF16_RTOL * peak if dtype == torch.bfloat16 else 0.0)
        assert (gx.float() - wx.float()).abs().max().item() <= tol


@pytest.mark.parametrize("arch,engine", [("sru-paper-large-stacked", None),
                                         ("qrnn-paper-large-fused", None),
                                         ("sru-paper-large", "pallas"),
                                         ("llama3-8b", None)])
def test_lm_loss_grads_on_the_card_match_the_cpu(device, arch, engine):
    """fp32, reduced width and depth: ``lm_loss`` and the gradient of every
    param leaf on the card against the CPU's from the same params and batch
    (a kernel output without a gradient path would leave the layer's
    params without gradients)."""
    from repro_torch.data import make_pipeline
    from repro_torch.training.steps import init_train_state

    cfg = get_config(arch).reduced()
    cfg = cfg.with_(scan_engine=engine) if engine else cfg
    state = init_train_state(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = make_pipeline(cfg, 4, 32, seed=1).batch_at(0)
    out = {}
    for dev in ("cpu", device):
        leaves = [p.detach().to(dev).requires_grad_() for p in tree_leaves(state.params)]
        params = unflatten_like(state.params, leaves)
        loss, _ = lm.lm_loss(params, cfg, {k: torch.from_numpy(v).to(dev)
                                            for k, v in batch.items()})
        out[dev if dev == "cpu" else "cuda"] = (loss, torch.autograd.grad(loss, leaves))
    (l_cpu, g_cpu), (l_gpu, g_gpu) = out["cpu"], out["cuda"]
    assert abs(l_cpu.item() - l_gpu.item()) <= STREAM_TOL
    for a, b in zip(g_cpu, g_gpu):
        assert b.abs().max().item() > 0 or a.abs().max().item() == 0
        np.testing.assert_allclose(b.cpu().numpy(), a.numpy(), rtol=GRAD_TOL, atol=GRAD_TOL)


# ---------------------------------------------------------------------------
# The frontend stubs, MQA and the hybrid, served on the card
# ---------------------------------------------------------------------------

# (arch, config overrides on its reduced config): granite-20b (MQA, gelu),
# the two frontend stubs, the hybrid, and the hybrid with a tail of blocks
# that no shared block follows.
ARCH_CASES = {
    "granite": ("granite-20b", {}),
    "internvl2": ("internvl2-2b", {}),
    "musicgen": ("musicgen-large", {}),
    "zamba2": ("zamba2-7b", {}),
    "zamba2_tail": ("zamba2-7b", {"n_layers": 5, "attn_every": 2}),
}


@pytest.mark.parametrize("case", sorted(ARCH_CASES))
def test_reduced_archs_served_on_the_card_match_the_cpu(device, case):
    """fp32, reduced: the captured batch steps on the card (a frontend's
    decode graph fed the chosen token's embedding row through its static
    buffer; the hybrid's shared block writing its own cache slice) against
    the eager steps on the CPU from the same params and prompt: the same
    greedy tokens over 8 steps, logits and every cache leaf within
    STREAM_TOL, the card's caches kept in place."""
    arch, overrides = ARCH_CASES[case]
    cfg = get_config(arch).reduced().with_(**overrides)
    params_cpu = lm.lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    inputs_cpu = serve.prompt_inputs(cfg, 4, 12, 1, "cpu")
    steps = 8
    out = {}
    for dev in ("cpu", device):
        params = unflatten_like(params_cpu, [t.to(dev) for t in tree_leaves(params_cpu)])
        inputs = {k: v.to(dev) for k, v in inputs_cpu.items()}
        prefill = build_prefill_step(cfg, batch=4, max_len=12 + steps + 1, device=dev)
        decode = build_decode_step(cfg)
        if dev != "cpu":
            prefill, decode = serve.capture_batch_steps(cfg, prefill, decode, params, inputs)
        logits, caches = prefill(params, inputs)
        storage = [t.data_ptr() for t in graphs.leaves(caches)]
        outs, toks = [logits.cpu()], []
        for _ in range(steps):
            toks.append(serve._greedy(cfg, logits).cpu())
            logits, caches = decode(params, caches, serve.step_input(cfg, params,
                                                                     toks[-1].to(dev)))
            outs.append(logits.cpu())
        assert [t.data_ptr() for t in graphs.leaves(caches)] == storage
        out["cpu" if dev == "cpu" else "cuda"] = (
            torch.cat(toks, dim=1), outs, [t.cpu() for t in graphs.leaves(caches)])
    (t_cpu, l_cpu, c_cpu), (t_gpu, l_gpu, c_gpu) = out["cpu"], out["cuda"]
    assert torch.equal(t_cpu, t_gpu)
    for a, b in zip(l_cpu + c_cpu, l_gpu + c_gpu, strict=True):
        assert (a.float() - b.float()).abs().max().item() <= STREAM_TOL


# A model shard's B1 call: (mode, H, k, shard, int8).
SHARD_OPERAND_CASES = {
    "skip_H64_shard2_of4": ("sru_identity", 64, 4, 2, False),
    "int8_H200_shard3_of8": ("sru_identity", 200, 8, 3, True),
    "int8_H200_shard7_of8": ("sru_identity", 200, 8, 7, True),
    "int8_qrnn_H200_shard5_of8": ("qrnn", 200, 8, 5, True),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, "fp32_io_bf16_slabs"],
                         ids=["fp32", "bf16", "fp32_io_bf16_slabs"])
@pytest.mark.parametrize("case", sorted(SHARD_OPERAND_CASES))
def test_fused_layer_shard_operands(device, case, dtype):
    """B1 on a model shard's operands (``distribution/fused_sharded.py``):
    the explicit skip, the shard's lane slice of an input of the whole
    width, and an int8 shard whose lanes start inside a scale block
    (``scale_lane0``), against the plain version on the card. The sharded
    stack's barrier runs B1 in fp32 IO on bf16 slabs under bf16 compute."""
    from repro_torch.distribution.fused_sharded import _scale_shard

    slabs = torch.bfloat16 if dtype == "fp32_io_bf16_slabs" else dtype
    dtype = torch.float32 if dtype == "fp32_io_bf16_slabs" else dtype
    mode, H, k, i, quant = SHARD_OPERAND_CASES[case]
    Hl, T, B = H // k, 13, 3
    g = torch.Generator(device=device).manual_seed(31)
    own = slice(i * Hl, (i + 1) * Hl)
    u = torch.randn((T, B, H), generator=g, device=device).to(dtype)
    taps = [torch.randn((H, 3, H), generator=g, device=device) * H ** -0.5
            for _ in range(2 if mode == "qrnn" else 1)]
    kw = {"mode": mode, "block_t": 4}
    if quant:
        if mode == "qrnn":
            *taps, scale = layout.quantize_qrnn_slabs(*taps)
        else:
            wq, scale = layout.quantize_slabs(taps[0])
            taps = [wq]
        kw["scale"], kw["scale_lane0"] = _scale_shard(scale, i * Hl, Hl)
        assert kw["scale_lane0"] == (i * Hl) % 128
    else:
        taps = [t.to(slabs) for t in taps]
    taps = tuple(t[..., own].contiguous() for t in taps)
    b3 = (torch.randn((3, Hl), generator=g, device=device) * 0.3).to(dtype)
    c0 = torch.randn((B, Hl), generator=g, device=device).to(dtype)
    if mode == "qrnn":
        kw["tail"] = torch.randn((1, B, H), generator=g, device=device).to(dtype)
    else:
        kw["skip"] = u[..., own].contiguous()
    ref = fused_rnn.fused_rnn_layer_plain(u, taps, b3, c0, **kw)
    out = fused_rnn.fused_rnn_layer(u, taps, b3, c0, **kw)
    torch.cuda.synchronize()
    _close(out, ref, dtype)


# ---------------------------------------------------------------------------
# The kernels' meta branches against the CUDA wrappers (the dry run's
# stand-ins for B4 and B5, launch/dryrun.py), at the local shapes of
# chip_smoke's dryrun cells: llama3-8b decode_32k, rank (0, 0) of the
# (16, 16) pod (8 lanes, 32 query heads on 8 KV heads of 128, its 2048 slots
# of the sequence-sharded cache: B5's lse form; and B5 on the same operands),
# and mamba2-2.7b long_500k (one lane, 5 of the 80 heads, P = 64, N = 128: a
# decode step in place, and a 64-step chunk). The meta branch must make what
# the wrapper makes: the outputs' shapes and dtypes, and, with each storage
# rounded to the caching allocator's 512-byte blocks, the call's peak and
# what stays allocated after it.
# ---------------------------------------------------------------------------

DRYRUN_B5 = {"llama3 rank": (8, 32, 8, 128, 2048)}
DRYRUN_B4 = {"mamba2 rank step": (1, 1, 5, 64, 128), "mamba2 rank chunk": (1, 64, 5, 64, 128)}


def _alloc_of(call, args, device):
    """(outputs, the call's peak allocated bytes beyond what was allocated
    before it, the bytes still allocated after it) on the card."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    out = call(*args)
    torch.cuda.synchronize()
    return (out, torch.cuda.max_memory_allocated(device) - before,
            torch.cuda.memory_allocated(device) - before)


def _meta_alloc_of(call, args):
    """The same on meta, from the dry run's storage tracker at 512 bytes a
    block (the meta branch's launch words are made for the call, where the
    card keeps one block a stream: the caller clears it first)."""
    from repro_torch.launch.dryrun import _LiveBytes

    live = _LiveBytes(args, block=512)
    with live:
        out = call(*args)
        held = live.live
    return out, live.peak, held


def _same_outputs(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device.type == "meta" and g.shape == w.shape and g.dtype == w.dtype


@pytest.mark.parametrize("lse", [False, True], ids=["out", "lse"])
@pytest.mark.parametrize("case", sorted(DRYRUN_B5))
def test_gqa_decode_meta_branch_allocates_as_the_wrapper(device, case, lse):
    B, Hq, Hkv, Dh, S = DRYRUN_B5[case]
    g = torch.Generator(device=device).manual_seed(41)
    q = torch.randn((B, Hq, Dh), generator=g, device=device).to(torch.bfloat16)
    k, v = (torch.randn((B, S, Hkv, Dh), generator=g, device=device).to(torch.bfloat16)
            for _ in range(2))
    lens = torch.full((B,), S, dtype=torch.int32, device=device)
    call = lambda *a: gqa_decode(*a, return_lse=lse)
    plan = gqa_kernel.plan(torch.bfloat16, B, Hkv, S, Dh, Hq // Hkv, device.index or 0)
    assert plan == gqa_kernel.plan(torch.bfloat16, B, Hkv, S, Dh, Hq // Hkv, meta=True)
    gqa_kernel._COUNTERS.clear()  # the first call on the stream makes its launch words
    out, peak, held = _alloc_of(call, (q, k, v, lens), device)
    words = -(-max(B * Hkv * plan[2], 1024) * 4 // 512) * 512 if plan[0] > 1 else 0
    m_out, m_peak, m_held = _meta_alloc_of(call, tuple(t.to("meta") for t in (q, k, v, lens)))
    _same_outputs(m_out, out)
    assert peak == m_peak
    assert held == m_held + words  # the card keeps the words for the stream's next call


@pytest.mark.parametrize("case", sorted(DRYRUN_B4))
def test_ssd_meta_branch_allocates_as_the_wrapper(device, case):
    Bsz, S, H, P, N = DRYRUN_B4[case]
    g = torch.Generator(device=device).manual_seed(42)
    bf = torch.bfloat16
    x = torch.randn((Bsz, S, H, P), generator=g, device=device).to(bf)
    dt = torch.nn.functional.softplus(torch.randn((Bsz, S, H), generator=g, device=device)
                                      - 4.6).to(bf)
    A = -torch.linspace(1.0, 16.0, H, device=device)
    Bm, Cm = ((torch.randn((Bsz, S, 1, N), generator=g, device=device) * 0.3).to(bf)
              for _ in range(2))
    D = torch.ones(H, device=device).to(bf)
    state = torch.randn((Bsz, H, N, P), generator=g, device=device) * 0.1

    def call(x, dt, A, Bm, Cm, D, state):
        return ssd(x, dt, A, Bm, Cm, D, initial_state=state, state_out=state, chunk=S)

    args = (x, dt, A, Bm, Cm, D, state)
    out, peak, held = _alloc_of(call, args, device)
    m_out, m_peak, m_held = _meta_alloc_of(call, tuple(t.to("meta") for t in args))
    _same_outputs(m_out, out)
    assert peak == m_peak and held == m_held


def test_meta_instance_model_is_the_cards(device):
    """B5's H100 model (``gqa_decode.meta_instance_info``) gives what the
    card reports for every instance family the port serves: the resources
    and so the split plans the meta branch makes partials for."""
    for dtype, dh, grp in [(torch.bfloat16, d, g) for d in (64, 112, 128, 192, 256)
                           for g in (1, 4, 16, 17, 32, 48)] + \
            [(torch.float32, d, g) for d in (32, 64, 128, 256) for g in (1, 4, 8, 32)]:
        want = dict(gqa_kernel.instance_info(dtype, dh, grp))
        got = gqa_kernel.meta_instance_info(dtype, dh, grp)
        assert got == want, (dtype, dh, grp)
