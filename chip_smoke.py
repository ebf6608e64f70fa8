#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py                  # every phase, as the check runs it
    python3 chip_smoke.py --phases build,kernels

Phases, each printing one JSON line per step:

  build    compile every CUDA source with nvcc (all at once; the fused-RNN
           source twice, fp and int8 instances apart), report the time,
           the nvcc version and ptxas's register/shared-memory report;
  kernels  each kernel against its plain PyTorch version on the card, on the
           same inputs, at the main path's shapes (T in {64, 1}, B = 4, width
           1024, bf16; for the linear scan F = B * H = 4096, and the single
           stream's F = 1024 at T = 64 and a 1024-step prompt at F = 4096)
           plus fp32, ragged-edge and long-sequence cases, each linear-scan
           case bit for bit against its chunk emulation, within tolerance of
           the sequential walk, with its chunk plan (chunk length, chunks,
           CTAs), and the fused backward of the linear scan (one launch);
           the int8 forms of the layer and the stack (int8 gate slabs,
           fp32 scales) at the same shapes, and bf16 ragged cases of both
           (a QRNN layer and an int8 QRNN stack at H = 1000, T = 13, B = 3),
           every fused-RNN case also timed cold, with each bf16 case's
           tensor-core instance (shared memory, registers, CTAs per SM,
           lanes per CTA, cluster size, grid, resident clusters, rows per
           chunk, input-tile columns); the decode attention (B5) at the
           llama3-8b and smollm-360m serve shapes (caches of 96, 1056 and
           8192 rows, ragged lengths down to 1, bf16), the full-width head
           shapes of granite-20b (a group of 48), zamba2-7b (head dim 112)
           and nemotron-4-340b (head dim 192) in bf16, and one fp32 case
           with 32 query heads per KV head, beside PyTorch's
           ``scaled_dot_product_attention`` on the same data, with each
           instance's shared memory, registers, CTAs per SM, tiles in
           flight and split plan; the chunked
           SSD (B4) at the mamba2-2.7b serve shapes (B = 4, 80 heads, P = 64,
           N = 128, bf16: prompts 1024 and 64 from a zero state, one decode
           step written in place over a random state, a ragged S = 100) and
           at two grouped fp32 shapes of ``tests/test_kernels.py`` (G = 2,
           4), with the mma chunk kernel's resources and plan; max |error|
           against a stated tolerance, and kernel / plain times from CUDA
           events (decode cases and every SSD and linear-scan case also
           cold: the L2 flushed before each call);
  serve    ``repro_torch.launch.serve.main`` in batch mode at full width
           (``--batch 4 --prompt-len 64 --gen-len 32``) for the stacked and
           fused configs, the base SRU/QRNN configs under ``--engine pallas``,
           ``sru-paper-large`` on its own chunked engine,
           ``lstm-paper-large``, the four ``*-int8`` configs, ``llama3-8b``
           (prompt 64 and 1024), ``smollm-360m`` and ``mamba2-2.7b`` (prompt
           64 and 1024), each twice: with the eager steps and with the
           steps as CUDA graphs (the default: prefill and every decode step
           a replay, ``capture_ms`` for the warm-ups and captures); each
           run's launches of each kernel instance, fp and int8 apart (counts
           set to 0 just before the run, read just after), its init time and
           peak memory; both modes must give the expected launches, keep the
           caches where they lie and give the same tokens;
  profile  per config (the fp fused, stacked and pallas runs, the two
           stacked int8 runs, llama3-8b, smollm-360m and mamba2-2.7b), eager
           and captured, a decode step's host time and torch.profiler's
           device time by kernel, hence the device's idle share, against the
           step's bytes bound (mamba2: its SSM state read and written too);
           the card's count of our kernels per step must equal the expected
           launches per step in both modes; the caches must keep their
           storage (written in place);
  parity   the stacked SRU and QRNN LMs, the base SRU and QRNN LMs under
           pallas, the LSTM LM, two int8 LMs (stacked SRU, fused QRNN),
           smollm-360m (full depth), llama3-8b and mamba2-2.7b (each cut to 2
           layers so the CPU side fits in time and host memory) at full width
           in fp32 compute, same params, on the card versus the plain path on
           the CPU: teacher-forced prefill logits, 8 decode steps and their
           argmax; the attention and Mamba caches keep their storage.

Then one ``{"phase_seconds": {...}}`` line (each phase's wall time, the
serve phase's warm-ups included), one ``{"kernels": [...]}`` line (launches
from the serve phase, eager and captured runs summed), the
card's name and power limit from nvidia-smi, and as the last line
``{"ok": true, "device": {...}}``. Any failure exits non-zero before the last
line. Without a CUDA device, or without the repository beside this file, it
exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PHASES = ("build", "kernels", "serve", "profile", "parity")
# (arch, --engine override, --prompt-len): the runs of the serve phase.
SERVE_RUNS = (
    ("sru-paper-large-stacked", None, 64), ("qrnn-paper-large-stacked", None, 64),
    ("sru-paper-large-fused", None, 64), ("qrnn-paper-large-fused", None, 64),
    ("sru-paper-large", "pallas", 64), ("qrnn-paper-large", "pallas", 64),
    ("sru-paper-large", None, 64), ("lstm-paper-large", None, 64),
    ("sru-paper-large-stacked-int8", None, 64), ("qrnn-paper-large-stacked-int8", None, 64),
    ("sru-paper-large-int8", None, 64), ("qrnn-paper-large-int8", None, 64),
    ("llama3-8b", None, 64), ("llama3-8b", None, 1024), ("smollm-360m", None, 64),
    ("mamba2-2.7b", None, 64), ("mamba2-2.7b", None, 1024),
)
# (arch, --engine override): the fused int8 runs are not profiled (their
# kernels take the bf16 twins' time), nor the long prompts.
PROFILE_RUNS = tuple(r[:2] for r in SERVE_RUNS[:6] + SERVE_RUNS[8:10] + SERVE_RUNS[12:13]
                     + SERVE_RUNS[14:16])
# (arch, --engine override, config overrides).
PARITY_RUNS = (
    ("sru-paper-large-stacked", None, {}), ("qrnn-paper-large-stacked", None, {}),
    ("sru-paper-large", "pallas", {}), ("qrnn-paper-large", "pallas", {}),
    ("lstm-paper-large", None, {}),
    ("sru-paper-large-stacked-int8", None, {}), ("qrnn-paper-large-int8", None, {}),
    ("smollm-360m", None, {}), ("llama3-8b", None, {"n_layers": 2}),
    ("mamba2-2.7b", None, {"n_layers": 2}),
)
# Each kernel instance family with its launch counter (module attribute).
KERNELS = ("fused_rnn_layer", "fused_rnn_stack", "linear_scan",
           "fused_rnn_layer_int8", "fused_rnn_stack_int8", "gqa_decode", "ssd")
OUR_KERNEL_SYMBOLS = ("fused_rnn_layer_kernel", "fused_rnn_mma_kernel",  # device symbol names
                      "linear_scan_kernel", "linear_scan_bwd_kernel",
                      "gqa_decode_mma_kernel", "gqa_decode_split_kernel",
                      "ssd_chunk_kernel", "ssd_chunk_mma_kernel", "ssd_step_kernel",
                      "ssd_step_vec_kernel")
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
L2_FLUSH_BYTES = 128 << 20         # written between cold calls; the H100's L2 is 50 MB
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor / fp32 SIMT
# Tolerances, kernel vs plain version on the same card and inputs. Both sides
# compute in fp32; they differ by the GEMM's summation order over K <= 2048
# products and by a few ulp of expf/tanhf/rsqrtf, carried through up to four
# layers: ATOL. A bf16 output can then round one bf16 ulp apart: RTOL_BF16
# times the largest output magnitude.
ATOL = 5e-4
RTOL_BF16 = 2.0 ** -7
# Decode attention (B5): both sides compute in fp32 and differ by the order of
# the softmax sums (online, split, combined) and a few ulp of expf: fp32
# within B5_ATOL; a bf16 output within one bf16 ulp of the largest output
# more (RTOL_BF16).
B5_ATOL = 2e-5
# Chunked SSD (B4): both sides compute in fp32 and differ by the order of the
# sums over N, over a chunk (the kernel's 64 steps, the plain version's own
# chunk) and along the chunk chain of up to 1024 steps, whose slow decays let
# the state grow: B4_RTOL of the largest output magnitude, y and state each;
# a bf16 y within one bf16 ulp of its largest value more (RTOL_BF16).
B4_RTOL = 2e-5
# Decode attention (B5) cases, (name, (B, Hq, Hkv, Dh, S, lengths), dtype):
# the llama3-8b serve shape (prompt 1024 + 32, first step), a long cache
# with ragged lengths down to 1, smollm's shape, an fp32 case with 32 query
# heads per KV head; then the llama3-8b serve shape at prompt 64 and the
# full-width head shapes of granite-20b, zamba2-7b and nemotron-4-340b at a
# 1056-row cache. ``bench_b5.py`` times the same cases.
GQA_CASES = (
    ("llama3 B=4 Hq=32 Hkv=8 Dh=128 S=1056 len=1025",
     (4, 32, 8, 128, 1056, (1025,) * 4), "bfloat16"),
    ("llama3 S=8192 len=(8192,5000,1,777)",
     (4, 32, 8, 128, 8192, (8192, 5000, 1, 777)), "bfloat16"),
    ("smollm B=4 Hq=15 Hkv=5 Dh=64 S=8192 len=8192",
     (4, 15, 5, 64, 8192, (8192,) * 4), "bfloat16"),
    ("G=32 B=2 Hq=32 Hkv=1 Dh=128 S=4096 len=(4096,2049) fp32",
     (2, 32, 1, 128, 4096, (4096, 2049)), "float32"),
    ("llama3 prompt 64 S=96 len=65", (4, 32, 8, 128, 96, (65,) * 4), "bfloat16"),
    ("granite B=4 Hq=48 Hkv=1 Dh=128 S=1056 len=1025",
     (4, 48, 1, 128, 1056, (1025,) * 4), "bfloat16"),
    ("zamba2 B=4 Hq=32 Hkv=32 Dh=112 S=1056 len=1025",
     (4, 32, 32, 112, 1056, (1025,) * 4), "bfloat16"),
    ("nemotron B=4 Hq=96 Hkv=8 Dh=192 S=1056 len=1025",
     (4, 96, 8, 192, 1056, (1025,) * 4), "bfloat16"),
)
# Chunked SSD (B4) cases, (name, (B, S, H, P, N, G, dtype, seed), options of
# ``_ssd_case``): the mamba2-2.7b serve shapes (prefill 1024 first: the
# summary's main row), then the grouped fp32 shapes of test_kernels.py.
# ``bench_b4.py`` times the same cases.
SSD_CASES = (
    ("mamba2 prefill B=4 S=1024 bf16", (4, 1024, 80, 64, 128, 1, "bfloat16", 500), {}),
    ("mamba2 prefill B=4 S=64 bf16", (4, 64, 80, 64, 128, 1, "bfloat16", 501), {}),
    ("mamba2 decode B=4 S=1 bf16 in place", (4, 1, 80, 64, 128, 1, "bfloat16", 502),
     {"s0": True, "in_place": True}),
    ("mamba2 ragged B=4 S=100 bf16 s0", (4, 100, 80, 64, 128, 1, "bfloat16", 503),
     {"s0": True}),
    ("G=2 B=2 S=64 H=4 P=8 N=16 fp32 s0", (2, 64, 4, 8, 16, 2, "float32", 504),
     {"s0": True, "model_like": False}),
    ("G=4 B=2 S=32 H=8 P=4 N=4 fp32 s0", (2, 32, 8, 4, 4, 4, "float32", 505),
     {"s0": True, "model_like": False}),
)
# Linear-scan (B3) cases, (name, T, F, dtype, seed): the pallas configs'
# prefill (first: the summary's main row) and decode step at B = 4 x H =
# 1024, the single stream at prompt 64, a 1024-step prompt at B = 4, then
# fp32, a ragged edge, one column and a long sequence. ``bench_b3.py`` times
# the same cases, and the backward at SCAN_BWD_CASES.
SCAN_CASES = (
    ("T=64 F=4096", 64, 4096, "bfloat16", 6),
    ("T=1 F=4096", 1, 4096, "bfloat16", 12),
    ("T=64 F=1024 (single stream)", 64, 1024, "bfloat16", 13),
    ("T=1024 F=4096 (prompt 1024)", 1024, 4096, "bfloat16", 14),
    ("T=64 F=4096 fp32", 64, 4096, "float32", 201),
    ("ragged T=13 F=3000 fp32", 13, 3000, "float32", 202),
    ("T=64 F=1 fp32", 64, 1, "float32", 203),
    ("long T=4096 F=128 fp32", 4096, 128, "float32", 204),
)
SCAN_BWD_CASES = (("backward T=64 F=4096 fp32", 64, 4096, "float32", 301),
                  ("backward T=1024 F=4096 fp32", 1024, 4096, "float32", 303))
# Linear-scan gradients against autograd through the plain walk: past one
# chunk the kernel folds chunk aggregates, which round otherwise than the
# walk's steps, by a few fp32 ulps of the largest gradient.
B3_GRAD_RTOL = 2e-5
# torch.profiler has come back without any device event for one window of
# graph replays on the H100 (torch 2.11, CUDA 12.8), where another run's
# windows all had theirs; the profile phase profiles such a window again.
PROFILE_WINDOWS = 3
# Parity (phase 4): fp32 LM on the card vs the CPU, through up to 32 layers
# and a head of up to 128256 columns; logits are O(1). The same sources of
# difference as ATOL.
PARITY_TOL = 1e-3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class SmokeFailure(RuntimeError):
    pass


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def time_ms(fn, iters: int, warmup: int = 2, flush=None) -> float:
    """Device time per call, from CUDA events around ``iters`` calls.

    The stream is first held by a sleep kernel longer than the host needs to
    enqueue all the calls, so the calls then run back to back and the events
    time the device, not the Python wrapper's issue rate. Back to back, a
    call finds in the L2 whatever of its operands the last call left there.
    With ``flush`` (a write larger than the L2) before each call, every call
    is timed alone between its own pair of events and finds nothing there.
    """
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if flush is not None:
        flush()
    fn()
    torch.cuda.synchronize()
    per_call_s = time.perf_counter() - t0  # host + device: an upper bound on enqueue
    n_pairs = 1 if flush is None else iters
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(n_pairs)]
    torch.cuda._sleep(int(min(2.0 * iters * per_call_s, 5.0) * 2e9))  # cycles at <= 2 GHz
    if flush is None:
        events[0][0].record()
        for _ in range(iters):
            fn()
        events[0][1].record()
    else:
        for start, end in events:
            flush()
            start.record()
            fn()
            end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in events) / iters


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(read_write_bytes: int, ops: float, dtype: str):
    t_bytes = read_write_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def errors(outs, refs, atol: float = ATOL, rtol: float = 0.0):
    """Per output: (max |err|, its tolerance, finite?). Each output's
    tolerance is ``atol`` plus ``rtol`` of its largest reference magnitude,
    plus RTOL_BF16 of it for a bf16 output."""
    import torch

    each = []
    for o, r in zip(outs, refs):
        if o is None:
            continue
        err = (o.float() - r.float()).abs().max().item()
        r_max = r.float().abs().max().item()
        tol = atol + rtol * r_max + (RTOL_BF16 * r_max if o.dtype == torch.bfloat16 else 0.0)
        each.append((err, tol, bool(torch.isfinite(o.float()).all().item())))
    return each


def compare(outs, refs, atol: float = ATOL, rtol: float = 0.0):
    """Worst output: (max |err|, its tolerance, all outputs finite?)."""
    each = errors(outs, refs, atol, rtol)
    err, tol, _ = max(each, key=lambda e: e[0] / e[1] if e[1] > 0 else
                      (float("inf") if e[0] > 0 else 0.0))
    return err, tol, all(e[2] for e in each)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    reports = build.build_all()
    dt = time.perf_counter() - t0
    ptxas = {
        name: [line.strip() for line in log.splitlines()
               if "registers" in line or "spill" in line or "Compiling entry" in line]
        for name, log in reports.items()
    }
    emit({"phase": "build", "seconds": dt, "nvcc": build.nvcc_version(), "ptxas": ptxas})


def _quantized(taps):
    """fp gate slabs -> (int8 taps, compact fp32 scales), QRNN's taps sharing
    one scale set, as ``layout.quantize_cell`` makes them."""
    from repro_torch.kernels.fused_rnn import layout

    if len(taps) == 2:
        w0q, w1q, scale = layout.quantize_qrnn_slabs(*taps)
        return (w0q, w1q), scale
    wq, scale = layout.quantize_slabs(taps[0])
    return (wq,), scale


def _layer_case(name, mode, T, B, d, H, dtype_name, seed, block_t=32, quant=False):
    """Inputs for one whole-layer kernel case, made on the card from a seed;
    ``quant``: int8 gate slabs with their fp32 scales."""
    import torch

    dev = torch.device("cuda")
    dt = getattr(torch, dtype_name)
    g = torch.Generator(device=dev).manual_seed(seed)

    def uni(*shape, scale=1.0):
        return ((torch.rand(shape, generator=g, device=dev) * 2 - 1) * scale).to(dt)

    u = torch.randn((T, B, d), generator=g, device=dev).to(dt)
    n_taps = 2 if mode == "qrnn" else 1
    taps = tuple(uni(d, 3, H, scale=d ** -0.5) for _ in range(n_taps))
    b3 = uni(3, H, scale=0.5)
    c0 = uni(B, H, scale=0.5)
    kw = {"mode": mode, "block_t": min(T, block_t)}
    if quant:
        taps, kw["scale"] = _quantized(taps)
    if mode == "qrnn":
        kw["tail"] = torch.randn((1, B, d), generator=g, device=dev).to(dt)
    if mode == "sru_proj":
        kw["wskip"] = uni(d, H, scale=d ** -0.5)
    args = (u, taps, b3, c0)
    K = d * n_taps
    ops = 2.0 * T * B * K * 3 * H + (2.0 * T * B * d * H if mode == "sru_proj" else 0.0)
    out_bytes = (T * B * H + B * H) * u.element_size()  # h, c_last
    rw = nbytes(u, *taps, b3, c0, kw.get("tail"), kw.get("wskip"), kw.get("scale")) + out_bytes
    return name, args, kw, rw, ops


def _stack_case(name, cell, T, B, H, L, dtype_name, seed, block_t=32, quant=False):
    import torch

    dev = torch.device("cuda")
    dt = getattr(torch, dtype_name)
    g = torch.Generator(device=dev).manual_seed(seed)

    def uni(*shape, scale=1.0):
        return ((torch.rand(shape, generator=g, device=dev) * 2 - 1) * scale).to(dt)

    x = torch.randn((T, B, H), generator=g, device=dev).to(dt)
    n_taps = 2 if cell == "qrnn" else 1
    taps = tuple(uni(L, H, 3, H, scale=H ** -0.5) for _ in range(n_taps))
    b3L = uni(L, 3, H, scale=0.5)
    lnL = (1.0 + uni(L, H, scale=0.2).float()).to(dt)
    c0L = uni(L, B, H, scale=0.5)
    tailsL = uni(L, B, H) if cell == "qrnn" else None
    kw = {"block_t": min(T, block_t)}
    if quant:
        taps, kw["sL"] = _quantized(taps)
    args = (x, taps, b3L, lnL, c0L, tailsL)
    ops = 2.0 * L * T * B * n_taps * H * 3 * H
    out_bytes = nbytes(x) + nbytes(c0L) + nbytes(tailsL)
    rw = nbytes(x, *taps, b3L, lnL, c0L, tailsL, kw.get("sL")) + out_bytes
    return name, args, kw, rw, ops


def _scan_case(name, T, F, dtype_name, seed):
    """Inputs for one linear-scan case: a = sigmoid(normal + 3), near 0.95 so
    the carry reaches across the kernel's chunks; b, c0 normal."""
    import torch

    dev = torch.device("cuda")
    dt = getattr(torch, dtype_name)
    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.sigmoid(torch.randn((T, F), generator=g, device=dev) + 3.0).to(dt)
    b = torch.randn((T, F), generator=g, device=dev).to(dt)
    c0 = torch.randn((F,), generator=g, device=dev).to(dt)
    rw = nbytes(a, b, c0) + nbytes(b)  # out (T, F) in b's dtype
    return name, (a, b, c0), {}, rw, 2.0 * T * F


def _gqa_case(name, B, Hq, Hkv, Dh, S, lengths, dtype_name, seed):
    """Inputs for one decode-attention case, made on the card from a seed,
    and its bound: the valid K/V rows, q and out, each moved once."""
    import torch

    dev = torch.device("cuda")
    dt = getattr(torch, dtype_name)
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, Hq, Dh), generator=g, device=dev).to(dt)
    k, v = (torch.randn((B, S, Hkv, Dh), generator=g, device=dev).to(dt) for _ in range(2))
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    rows = sum(min(n, S) for n in lengths)
    rw = 2 * rows * Hkv * Dh * k.element_size() + 2 * nbytes(q) + nbytes(lens)
    ops = 2.0 * 2.0 * rows * (Hq // Hkv) * Hkv * Dh  # q.k and p.v
    return name, (q, k, v, lens), {}, rw, ops


def _sdpa(q, k, v, lens):
    """The library yardstick of B5: one ``scaled_dot_product_attention``
    call on the same data, never on the port's path. It takes the cache as
    (B, Hkv, S, Dh): the transposed views are free (no copy is timed), and
    the length mask is built outside the timed call."""
    import torch

    S = k.shape[1]
    mask = (torch.arange(S, device=q.device)[None, :] < lens[:, None])[:, None, None, :]
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    q4 = q[:, :, None, :]

    def call():
        return torch.nn.functional.scaled_dot_product_attention(
            q4, kt, vt, attn_mask=mask, enable_gqa=True)[:, :, 0, :]

    return call


def _ssd_case(name, B, S, H, P, N, G, dtype_name, seed, *, s0=False, in_place=False,
              model_like=True):
    """Inputs for one chunked-SSD case, made on the card from a seed, and its
    bound. ``model_like``: mamba2's decays (A = -1..-16 over the heads, as
    ``mamba_init`` makes them, dt about 0.01 as its ``dt_bias`` gives), so
    the state carries over the whole prompt; else ``tests/test_kernels.py``'s
    draws. Bytes: every operand read once and y and the state written once.
    Operations: the chunked algorithm at the kernel's 64-step chunks, the
    lower triangles of C B^T and of the scores times xdt, C S and B^T xdt
    (multiply-adds count 2); one step is 4 N P."""
    import torch

    from repro_torch.kernels.ssd.ssd import CHUNK

    dev = torch.device("cuda")
    dt_ = getattr(torch, dtype_name)
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)

    x = rnd(B, S, H, P).to(dt_)
    if model_like:
        dt = torch.nn.functional.softplus(rnd(B, S, H) * 0.5 - 4.6)
        A = -torch.linspace(1.0, 16.0, H, device=dev)
    else:
        dt = torch.nn.functional.softplus(rnd(B, S, H))
        A = -torch.exp(rnd(H))
    Bm, Cm = (rnd(B, S, G, N) * 0.3).to(dt_), (rnd(B, S, G, N) * 0.3).to(dt_)
    D = torch.ones(H, device=dev)
    state0 = rnd(B, H, N, P) * 0.1 if s0 else None
    ops = 0.0
    for t0 in range(0, S, CHUNK):
        L = min(CHUNK, S - t0)
        tri = L * (L + 1) / 2
        ops += 2.0 * (tri * N + tri * P + 2 * L * N * P) if S > 1 else 4.0 * N * P
    ops *= B * H
    rw = nbytes(x, dt, A, Bm, Cm, D, state0) + nbytes(x) + B * H * N * P * 4
    kw = {"chunk": 128, "in_place": in_place}
    return name, (x, dt, A, Bm, Cm, D, state0), kw, rw, ops


def _ssd_kernel_call(x, dt, A, B_, C_, D, s0, *, chunk, in_place):
    from repro_torch.kernels.ssd.ops import ssd

    return ssd(x, dt, A, B_, C_, D, initial_state=s0, chunk=chunk,
               state_out=s0 if in_place else None)


def _ssd_plain_call(x, dt, A, B_, C_, D, s0, *, chunk, in_place):
    from repro_torch.kernels.ssd.ref import ssd_ref

    return ssd_ref(x, dt, A, B_, C_, D, initial_state=s0, chunk=chunk)


def _summary(kname, source, replaces, rows):
    main = rows[0]  # the main path's prefill shape (T = 64, bf16), or B5's serve shape
    decode = next(r for r in rows if r["T"] == 1)
    return {
        "name": kname, "route": "cuda", "source": source,
        "replaces": replaces, "launches": 0,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main.get("library_ms"),
        "case": main["case"], "decode_case": decode["case"],
        "decode_ms": decode["ms"], "decode_cold_ms": decode["cold_ms"],
        "decode_plain_ms": decode["plain_ms"],
        "decode_bound_ms": decode["bound_ms"], "cases_passed": len(rows),
    }


def _run_cases(kname, wrapper, plain, cases, atol=ATOL, rtol=0.0, library=None, cold=False):
    """Each case against its plain version (computed first: a wrapper may
    write a state operand in place); decode cases (T = 1), and every case
    with ``cold``, are also timed cold, with the L2 flushed before each call
    (``cold_ms``).
    ``library(*args)`` gives the one PyTorch call that computes the same
    function, timed as ``library_ms`` (with its max |error| against the
    plain version, not checked)."""
    import torch

    l2 = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    rows = []
    for dtype, T, name, args, kw, rw, ops in cases:
        ref = plain(*args, **kw)
        out = wrapper(*args, **kw)
        torch.cuda.synchronize()
        out, ref = (x if isinstance(x, tuple) else (x,) for x in (out, ref))
        err, tol, finite = compare(out, ref, atol, rtol)
        each = errors(out, ref, atol, rtol)  # before the timed calls, which may write out
        ms = time_ms(lambda: wrapper(*args, **kw), iters=50)
        cold_ms = None
        if T == 1 or cold:
            cold_ms = time_ms(lambda: wrapper(*args, **kw), iters=50, flush=l2.zero_)
        plain_ms = time_ms(lambda: plain(*args, **kw), iters=3, warmup=1)
        b_ms, b_by = bound(rw, ops, dtype)
        row = {
            "phase": "kernels", "kernel": kname, "case": name, "dtype": dtype, "T": T,
            "max_abs_err": err, "tol": tol, "finite": finite,
            "max_abs_err_each": [e[0] for e in each], "tol_each": [e[1] for e in each],
            "ms": ms, "cold_ms": cold_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "bound_fp32_simt_ms": bound(rw, ops, "float32")[0],
        }
        if library is not None:
            call = library(*args)
            row["library_ms"] = time_ms(call, iters=50)
            row["library_max_abs_err"] = (call().float() - ref[0].float()).abs().max().item()
        emit(row)
        require(finite and err <= tol, f"{kname} [{name}]: err {err} > tol {tol}")
        rows.append(row)
    return rows


def _scan_chunked(a, b, c0):
    """The linear-scan kernel's plain version: the chunk emulation."""
    from repro_torch.kernels.linear_scan.ref import chunk_len, linear_scan_ref

    return linear_scan_ref(a, b, c0, chunk=chunk_len(a.shape[0]))


def _scan_checks(cases):
    """Per linear-scan case: the kernel bit for bit equal to its chunk
    emulation on three calls (repeated calls give the same bits), within
    tolerance of the sequential walk; one line with the launch plan."""
    import torch

    from repro_torch.kernels.linear_scan import linear_scan as ls
    from repro_torch.kernels.linear_scan.ref import linear_scan_ref

    for dtype, T, name, (a, b, c0), *_ in cases:
        outs = [ls.linear_scan_kernel(a, b, c0) for _ in range(3)]
        emu, walk = _scan_chunked(a, b, c0), linear_scan_ref(a, b, c0)
        torch.cuda.synchronize()
        bitwise = all(torch.equal(o, emu) for o in outs)
        err, tol, finite = compare([outs[0]], [walk])
        p = ls.plan(T, a.shape[1], a.dtype)
        emit({"phase": "kernels", "kernel": "linear_scan", "case": name, "chunk": p.chunk,
              "n_chunks": p.n_chunks, "n_tiles": p.n_tiles, "ctas": p.ctas,
              "vec_bytes": p.vec_bytes,
              "bitwise_vs_chunk_emulation": bitwise, "walk_max_abs_err": err, "walk_tol": tol})
        require(bitwise, f"linear_scan [{name}]: not bitwise equal to its chunk emulation")
        require(finite and err <= tol, f"linear_scan [{name}]: walk err {err} > tol {tol}")


def _scan_backward_row(name, T, F, dtype_name, seed):
    """The fused backward of ``ops.linear_scan`` at one of SCAN_BWD_CASES
    (F = B * H, B = 4): one launch of ``linear_scan_bwd``, bit for bit against
    ``linear_scan_bwd_ref`` at the kernel's chunk, and autograd through
    ``ops.linear_scan`` within ATOL (and, past one chunk, B3_GRAD_RTOL) of
    autograd through the plain walk.
    ``ms``/``cold_ms``, ``plain_ms`` and the bound are the backward launch's
    and its plain version's: it reads a, c, g and c0 once and writes da, db
    and dc0 once, 3 operations per element. ``op_ms`` is the whole autograd
    forward + backward (two launches, the product, the sum and dispatch) and
    has no bound."""
    import torch

    from repro_torch.kernels.linear_scan import linear_scan as ls
    from repro_torch.kernels.linear_scan import ops
    from repro_torch.kernels.linear_scan.ref import chunk_len, linear_scan_bwd_ref, linear_scan_ref

    _, (a0, b0, c00), _, _, _ = _scan_case(name, T, F, dtype_name, seed)
    w = torch.randn((T, F), generator=torch.Generator(device="cuda").manual_seed(seed + 1),
                    device="cuda").to(a0.dtype)

    def fwd_bwd(fn):
        a, b, c0 = (t.clone().requires_grad_(True) for t in (a0, b0, c00))
        (fn(a, b, c0) * w).sum().backward()
        return a.grad, b.grad, c0.grad

    grads, refs = fwd_bwd(ops.linear_scan), fwd_bwd(linear_scan_ref)
    c = ls.linear_scan_kernel(a0, b0, c00)
    before = ls.LAUNCHES
    fused = ls.linear_scan_bwd(a0, c, c00, w)
    launches = ls.LAUNCHES - before
    chunk = chunk_len(T)
    emu = linear_scan_bwd_ref(a0, c, c00, w, chunk=chunk)
    torch.cuda.synchronize()
    err, tol, finite = compare(grads, refs, ATOL, B3_GRAD_RTOL if T > chunk else 0.0)
    bitwise = all(torch.equal(x, y) for x, y in zip(fused, emu))
    l2 = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    rw = nbytes(a0, c, w, c00) + nbytes(*fused)
    b_ms, b_by = bound(rw, 3.0 * T * F, dtype_name)
    row = {
        "phase": "kernels", "kernel": "linear_scan", "case": name,
        "dtype": dtype_name, "T": T, "max_abs_err": err, "tol": tol, "finite": finite,
        "bitwise_vs_chunk_emulation": bitwise, "launches_per_backward": launches,
        "ms": time_ms(lambda: ls.linear_scan_bwd(a0, c, c00, w), iters=50),
        "cold_ms": time_ms(lambda: ls.linear_scan_bwd(a0, c, c00, w), iters=50, flush=l2.zero_),
        "plain_ms": time_ms(lambda: linear_scan_bwd_ref(a0, c, c00, w, chunk=chunk),
                            iters=3, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by,
        "op_ms": time_ms(lambda: fwd_bwd(ops.linear_scan), iters=20),
    }
    emit(row)
    require(finite and err <= tol, f"linear_scan [{name}]: err {err} > tol {tol}")
    require(bitwise, f"linear_scan [{name}]: not bitwise equal to its chunk emulation")
    require(launches == 1, f"linear_scan [{name}]: {launches} launches, expected 1")
    return row


def fused_rnn_cases():
    """The cases of the fused SRU/QRNN kernel (B1 layer, B2 stack, fp and
    int8 slabs), keyed by kernel family: ``(dtype, T, name, args, kw, rw,
    ops)`` each. First the main path's shapes (B = 4, width 1024, bf16; T =
    64 first, the summary's main row, then T = 1), then ragged and fp32
    cases. ``bench_b12.py`` times the same cases."""
    cases = {k: [] for k in ("fused_rnn_layer", "fused_rnn_stack", "fused_rnn_layer_int8",
                             "fused_rnn_stack_int8")}
    seed = 0
    for T in (64, 1):
        for mode, d in (("sru_identity", 1024), ("qrnn", 1024), ("sru_proj", 512)):
            seed += 1
            cases["fused_rnn_layer"].append(("bfloat16", T) + _layer_case(
                f"{mode} T={T} d={d}", mode, T, 4, d, 1024, "bfloat16", seed))
            cases["fused_rnn_layer_int8"].append(("bfloat16", T) + _layer_case(
                f"int8 {mode} T={T} d={d}", mode, T, 4, d, 1024, "bfloat16", seed, quant=True))
        for cell in ("sru", "qrnn"):
            seed += 1
            cases["fused_rnn_stack"].append(("bfloat16", T) + _stack_case(
                f"{cell} L=4 T={T}", cell, T, 4, 1024, 4, "bfloat16", seed))
            cases["fused_rnn_stack_int8"].append(("bfloat16", T) + _stack_case(
                f"int8 {cell} L=4 T={T}", cell, T, 4, 1024, 4, "bfloat16", seed, quant=True))
        seed += 1
    # Ragged: H = 1000 leaves a last lane block of 8 lanes (bf16 and int8)
    # and d = 1000 pads each tap by 8; with fp32 IO, the last CTA of the
    # CUDA-core body has 4 lanes (per-element int8 loads) and the last scale
    # block 100 lanes.
    cases["fused_rnn_layer"].append(("bfloat16", 13) + _layer_case(
        "qrnn ragged T=13 B=3 d=H=1000", "qrnn", 13, 3, 1000, 1000, "bfloat16", 106, 4))
    cases["fused_rnn_stack_int8"].append(("bfloat16", 13) + _stack_case(
        "int8 qrnn ragged L=2 T=13 B=3 H=1000", "qrnn", 13, 3, 1000, 2, "bfloat16", 107, 4,
        quant=True))
    cases["fused_rnn_layer_int8"].append(("float32", 13) + _layer_case(
        "int8 qrnn ragged T=13 d=H=996 fp32", "qrnn", 13, 3, 996, 996, "float32", 105, 4,
        quant=True))
    cases["fused_rnn_layer"].append(("float32", 64) + _layer_case(
        "sru_identity T=64 d=1024 fp32", "sru_identity", 64, 4, 1024, 1024, "float32", 101))
    cases["fused_rnn_layer"].append(("float32", 13) + _layer_case(
        "qrnn ragged T=13 d=H=1000 fp32", "qrnn", 13, 3, 1000, 1000, "float32", 102, 4))
    cases["fused_rnn_stack"].append(("float32", 64) + _stack_case(
        "sru L=4 T=64 fp32", "sru", 64, 4, 1024, 4, "float32", 103))
    cases["fused_rnn_stack"].append(("float32", 13) + _stack_case(
        "qrnn ragged L=2 T=13 H=1000 fp32", "qrnn", 13, 3, 1000, 2, "float32", 104, 4))
    return cases


def fused_instance_info(args, kw):
    """The tensor-core instance a bf16 fused-RNN case runs (one layer of a
    stack): ``fused_rnn.instance_info`` for its shape."""
    from repro_torch.kernels.fused_rnn import fused_rnn

    x, taps = args[0], args[1]
    T, B, d = x.shape
    stack = "mode" not in kw
    int8 = kw.get("scale", kw.get("sL")) is not None
    return dict(fused_rnn.instance_info(
        T, B, d, taps[0].shape[-1], int8=int8, ng=4 if kw.get("mode") == "sru_proj" else 3,
        stack=stack, taps=len(taps), block_t=kw["block_t"]))


def phase_kernels():
    """Every kernel against its plain version. Returns per-kernel summaries."""
    import torch

    from repro_torch.kernels.fused_rnn import fused_rnn, stacked
    from repro_torch.kernels.gqa_decode import gqa_decode as gqa_kernel
    from repro_torch.kernels.gqa_decode.ops import gqa_decode
    from repro_torch.kernels.gqa_decode.ref import gqa_decode_ref
    from repro_torch.kernels.linear_scan import linear_scan
    from repro_torch.kernels.ssd import ssd as ssd_kernel

    fused = fused_rnn_cases()
    scan_cases = [(dtype, T) + _scan_case(name, T, F, dtype, seed)
                  for name, T, F, dtype, seed in SCAN_CASES]
    gqa_cases = [(dtype, 1) + _gqa_case(name, *shape, dtype, 400 + i)
                 for i, (name, shape, dtype) in enumerate(GQA_CASES)]

    fused_src = "src/repro_torch/kernels/fused_rnn/csrc/fused_rnn_layer.cu"
    summaries = {}
    for kname, wrapper, plain, cases, source, replaces in (
        ("fused_rnn_layer", fused_rnn.fused_rnn_layer, fused_rnn.fused_rnn_layer_plain,
         fused["fused_rnn_layer"], fused_src, "src/repro/kernels/fused_rnn/fused_rnn.py:113"),
        ("fused_rnn_stack", stacked.fused_rnn_stack, stacked.fused_rnn_stack_plain,
         fused["fused_rnn_stack"], fused_src, "src/repro/kernels/fused_rnn/stacked.py:144"),
        ("linear_scan", linear_scan.linear_scan_kernel, _scan_chunked, scan_cases,
         "src/repro_torch/kernels/linear_scan/csrc/linear_scan.cu",
         "src/repro/kernels/linear_scan/linear_scan.py:76"),
        ("fused_rnn_layer_int8", fused_rnn.fused_rnn_layer, fused_rnn.fused_rnn_layer_plain,
         fused["fused_rnn_layer_int8"], fused_src,
         "src/repro/kernels/fused_rnn/fused_rnn.py:113"),
        ("fused_rnn_stack_int8", stacked.fused_rnn_stack, stacked.fused_rnn_stack_plain,
         fused["fused_rnn_stack_int8"], fused_src, "src/repro/kernels/fused_rnn/stacked.py:144"),
    ):
        fused_kernel = kname.startswith("fused_rnn")
        rows = _run_cases(kname, wrapper, plain, cases, cold=fused_kernel or kname == "linear_scan")
        if kname == "linear_scan":
            _scan_checks(cases)
            rows += [_scan_backward_row(*case) for case in SCAN_BWD_CASES]
        if fused_kernel:
            for dtype, _, name, args, kw, _, _ in cases:
                if dtype == "bfloat16":
                    emit({"phase": "kernels", "kernel": kname, "case": name,
                          **fused_instance_info(args, kw)})
        summaries[kname] = _summary(kname, source, replaces, rows)
        if fused_kernel or kname == "linear_scan":
            summaries[kname]["cold_ms"] = rows[0]["cold_ms"]
    rows = _run_cases("gqa_decode", gqa_decode, gqa_decode_ref, gqa_cases, atol=B5_ATOL,
                      library=_sdpa)
    for _, _, name, (q, k, _, _), *_ in gqa_cases:  # the instance each case runs
        (B, Hq, Dh), (S, Hkv) = q.shape, k.shape[1:3]
        n_split, per_split, head_blocks = gqa_kernel.plan(q.dtype, B, Hkv, S, Dh, Hq // Hkv)
        emit({"phase": "kernels", "kernel": "gqa_decode", "case": name,
              **gqa_kernel.instance_info(q.dtype, Dh, Hq // Hkv),
              "n_split": n_split, "rows_per_split": per_split, "head_blocks": head_blocks})
    summaries["gqa_decode"] = _summary(
        "gqa_decode", "src/repro_torch/kernels/gqa_decode/csrc/gqa_decode.cu",
        "src/repro/kernels/gqa_decode/gqa_decode.py:66", rows)

    # Chunked SSD: SSD_CASES, each also timed cold.
    ssd_cases = []
    for name, shape, kw in SSD_CASES:
        case = _ssd_case(name, *shape, **kw)
        x = case[1][0]
        ssd_cases.append((str(x.dtype).split(".")[-1], x.shape[1]) + case)
    rows = _run_cases("ssd", _ssd_kernel_call, _ssd_plain_call, ssd_cases, atol=0.0,
                      rtol=B4_RTOL, cold=True)
    heads_per_cta, grid = ssd_kernel.plan(4, 80, 1, 64, 128)
    emit({"phase": "kernels", "kernel": "ssd", "instance": "mma chunk kernel, bf16, N = 128",
          **ssd_kernel.instance_info(torch.bfloat16, torch.bfloat16, 128),
          "heads_per_cta": heads_per_cta, "grid": grid, "ctas": grid[0] * grid[1] * grid[2],
          "sm_count": torch.cuda.get_device_properties(0).multi_processor_count})
    summaries["ssd"] = _summary(
        "ssd", "src/repro_torch/kernels/ssd/csrc/ssd.cu", "src/repro/kernels/ssd/ssd.py:73",
        rows)
    summaries["ssd"]["bound_fp32_simt_ms"] = rows[0]["bound_fp32_simt_ms"]
    summaries["ssd"]["cold_ms"] = rows[0]["cold_ms"]
    return summaries


def _launch_counters():
    """Kernel -> (module, name of its launch counter); the wrappers count fp
    and int8 instance launches apart."""
    from repro_torch.kernels.fused_rnn import fused_rnn, stacked
    from repro_torch.kernels.gqa_decode import gqa_decode
    from repro_torch.kernels.linear_scan import linear_scan
    from repro_torch.kernels.ssd import ssd

    return {"fused_rnn_layer": (fused_rnn, "LAUNCHES"),
            "fused_rnn_stack": (stacked, "LAUNCHES"),
            "linear_scan": (linear_scan, "LAUNCHES"),
            "fused_rnn_layer_int8": (fused_rnn, "LAUNCHES_INT8"),
            "fused_rnn_stack_int8": (stacked, "LAUNCHES_INT8"),
            "gqa_decode": (gqa_decode, "LAUNCHES"),
            "ssd": (ssd, "LAUNCHES")}


def _run_cfg(arch, engine):
    from repro_torch.configs.registry import get_config

    cfg = get_config(arch)
    return cfg.with_(scan_engine=engine) if engine else cfg


def _expected_launches(cfg, decode_steps: int) -> dict:
    """Launches of each kernel over one prefill and ``decode_steps`` decode
    steps: for an RNN, one per layer per call on the kernel the config's
    engine routes to (its int8 instance under ``weight_quant == "int8"``),
    none for LSTM and the plain engines; for attention, one decode attention
    per layer per decode step (prefill attention is plain PyTorch); for
    Mamba-2, one SSD per layer per call (the prompt's, then each step's)."""
    want = dict.fromkeys(KERNELS, 0)
    if cfg.ssm:
        want["ssd"] = cfg.n_layers * (1 + decode_steps)
        return want
    if cfg.cell is None:
        want["gqa_decode"] = cfg.n_layers * decode_steps
        return want
    n = cfg.n_layers * (1 + decode_steps)
    q = "_int8" if cfg.weight_quant == "int8" else ""
    if cfg.cell == "lstm":
        return want
    if cfg.scan_engine == "fused_stack" and cfg.fuse_depth:
        want["fused_rnn_stack" + q] = n
    elif cfg.scan_engine in ("fused", "fused_stack"):
        want["fused_rnn_layer" + q] = n
    elif cfg.scan_engine == "pallas":
        want["linear_scan"] = n
    return want


def phase_serve():
    """The main path: each run through serve.main twice, with the eager steps
    and with the steps as CUDA graphs (the default), every kernel's count
    set to 0 just before each run and read just after. Both must give the
    expected launches, keep the caches where they lie and give the same
    tokens. Returns the launches summed over both runs of every config."""
    from repro_torch.launch import serve

    gen_len, batch = 32, 4
    counters = _launch_counters()
    # Warm-up of every run at the measured shapes: CUDA context, allocator,
    # cuBLAS's first call at each GEMM shape, and the first launch of each
    # kernel on the run's path (runs that share their cuBLAS shapes still
    # differ in the elementwise kernels they launch first). A captured run
    # warms its own steps up before it captures them (``capture_ms``).
    for arch, engine, prompt_len in SERVE_RUNS:
        extra = ["--engine", engine] if engine else []
        with contextlib.redirect_stdout(io.StringIO()):
            require(serve.main(["--arch", arch, "--gen-len", "2", "--prompt-len", str(prompt_len)]
                               + extra, graphs=False) == 0, f"serve warm-up {arch} {engine}")
    totals = dict.fromkeys(KERNELS, 0)
    for arch, engine, prompt_len in SERVE_RUNS:
        extra = ["--engine", engine] if engine else []
        cfg = _run_cfg(arch, engine)
        want = _expected_launches(cfg, gen_len - 1)
        calls = 1 + (gen_len - 1)  # one prefill, gen_len - 1 decode steps
        engine_used = cfg.scan_engine if cfg.cell in ("sru", "qrnn") else None
        tokens = {}
        for graphs in (False, True):
            what = f"serve {arch} {engine} ({'captured' if graphs else 'eager'})"
            buf = io.StringIO()
            for mod, attr in counters.values():
                setattr(mod, attr, 0)
            with contextlib.redirect_stdout(buf):
                rc = serve.main([
                    "--arch", arch, "--batch", str(batch), "--prompt-len", str(prompt_len),
                    "--gen-len", str(gen_len),
                ] + extra, graphs=graphs)
            launches = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
            require(rc == 0, f"{what} returned {rc}")
            line = next(x for x in buf.getvalue().splitlines() if x.startswith("serve-stats "))
            stats = json.loads(line[len("serve-stats "):])
            tokens[graphs] = stats.pop("tokens")
            ok_tokens = all(0 <= t < cfg.vocab for row in tokens[graphs] for t in row)
            emit({"phase": "serve", **stats, "prompt_len": prompt_len, "engine": engine_used,
                  "launches": launches, "launches_per_step": sum(launches.values()) / calls,
                  "sample_tokens": tokens[graphs][0][:8]})
            require(stats["graphs"] == graphs, f"{what}: graphs {stats['graphs']}")
            require(launches == want, f"{what}: launches {launches} != {want}")
            require(stats["cache_in_place"], f"{what}: the caches moved")
            require(ok_tokens and len(tokens[graphs]) == batch
                    and len(tokens[graphs][0]) == gen_len, f"{what}: bad tokens")
            for k, n in launches.items():
                totals[k] += n
        require(tokens[True] == tokens[False],
                f"serve {arch} {engine}: the captured steps' tokens differ from the eager ones")
    return totals


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    return 0 if tree is None else tree.numel() * tree.element_size()


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return None if tree is None else tree.to(device)


def _profile_steps(cfg, params, prefill, decode, inputs, steps):
    """One prefill, then ``steps`` decode steps untimed, ``steps`` timed on
    the host clock and ``steps`` under torch.profiler (again, up to
    PROFILE_WINDOWS windows, while the profiler shows no device event).
    Returns (host ms per step, [(device us per step, events per step, name)]
    of the device-side events, whether the caches kept their storage, the
    caches, the windows profiled)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.training.graphs import leaves

    logits, caches = prefill(params, inputs)
    ptrs = [t.data_ptr() for t in leaves(caches)]

    def run():
        nonlocal logits, caches
        for _ in range(steps):
            tok = torch.argmax(logits[:, -1, : cfg.vocab], dim=-1)[:, None]
            logits, caches = decode(params, caches, tok)
        torch.cuda.synchronize()

    run()  # warm-up
    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    for window in range(1, PROFILE_WINDOWS + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
        kernels = []  # device-side events only (kernels, copies): no double count
        for e in prof.key_averages():
            dev_us = getattr(e, "self_device_time_total", 0.0) or 0.0
            if e.device_type == DeviceType.CUDA and dev_us > 0:
                kernels.append((dev_us / steps, e.count / steps, e.key))
        if kernels:
            break
    in_place = [t.data_ptr() for t in leaves(caches)] == ptrs
    kernels.sort(reverse=True)
    return wall_ms, kernels, in_place, caches, window


def phase_profile():
    """Where a decode step's time goes (B = 4, after a 64-token prefill), with
    the eager steps and with the steps as CUDA graphs: host clock per step
    without the profiler, then torch.profiler's device time per step by
    kernel. Idle share = 1 - device time / step time. The device counts the
    launches of our kernels per step (``OUR_KERNEL_SYMBOLS``), which must be
    the wrappers' expected launches per step in both modes: the card's own
    confirmation that each replay runs our kernels. The step's bound is the
    bytes it must move once over the HBM rate: every layer weight, the final
    norm, the logits matrix and the valid KV rows read, or for Mamba-2 its
    SSM state and conv tails read and written."""
    import torch

    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.models.layers import _dtype
    from repro_torch.training.steps import build_decode_step, build_prefill_step

    steps, prompt_len = 8, 64
    for arch, engine in PROFILE_RUNS:
        cfg = _run_cfg(arch, engine)
        params = lm.lm_init(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda",
                            dtype=_dtype(cfg.compute_dtype))
        max_len = prompt_len + (2 + PROFILE_WINDOWS) * steps
        prefill = build_prefill_step(cfg, batch=4, max_len=max_len, device="cuda")
        decode = build_decode_step(cfg)
        inputs = {"inputs": torch.zeros((4, prompt_len), dtype=torch.long, device="cuda")}
        per_step = (sum(_expected_launches(cfg, 1).values())
                    - sum(_expected_launches(cfg, 0).values()))
        head = params["embed"].get("unembed", params["embed"]["embed"])
        weight_bytes = (_tree_bytes(params["layers"]) + _tree_bytes(params["final_norm"])
                        + _tree_bytes(head))
        captured = serve.capture_batch_steps(cfg, prefill, decode, params, inputs)
        for graphs, (pre, dec) in ((False, (prefill, decode)), (True, captured)):
            wall_ms, kernels, in_place, caches, windows = _profile_steps(
                cfg, params, pre, dec, inputs, steps)
            device_ms = sum(k[0] for k in kernels) / 1e3 if kernels else None
            ours = [k for k in kernels if any(n in k[2] for n in OUR_KERNEL_SYMBOLS)]
            ours_per_step = sum(k[1] for k in ours)
            kv_bytes = 0
            if cfg.ssm:  # every cache leaf read and written once per step
                kv_bytes = 2 * _tree_bytes(caches["layers"])
            elif cfg.cell is None:  # mean valid rows over the profiled steps
                rows = prompt_len + (1 + windows) * steps + (steps + 1) / 2
                kv_bytes = (2 * cfg.n_layers * 4 * rows * cfg.n_kv_heads * cfg.d_head
                            * caches["layers"]["k"].element_size())
            step_bytes = weight_bytes + kv_bytes
            emit({"phase": "profile", "arch": arch,
                  "engine": cfg.scan_engine if cfg.cell in ("sru", "qrnn") else None,
                  "graphs": graphs, "step_ms": wall_ms, "device_ms": device_ms,
                  "profile_windows": windows,
                  "device_ops_per_step": sum(k[1] for k in kernels),
                  "idle_share": None if device_ms is None else 1.0 - device_ms / wall_ms,
                  "step_bound_ms": step_bytes / HBM_BYTES_PER_S * 1e3, "step_bytes": step_bytes,
                  "cache_bytes_per_step": kv_bytes, "cache_in_place": in_place,
                  "our_kernels_us_per_step": sum(k[0] for k in ours),
                  "our_launches_per_step": ours_per_step, "expected_launches_per_step": per_step,
                  "top_kernels_us_per_step": [[round(k[0], 2), k[1], k[2][:70]]
                                              for k in kernels[:8]]})
            mode = "captured" if graphs else "eager"
            require(in_place, f"profile {arch} ({mode}): the decode step moved the cache")
            require(device_ms is not None, f"profile {arch} ({mode}): no device time traced")
            require(ours_per_step == per_step,
                    f"profile {arch} ({mode}): the card ran {ours_per_step} of our kernels a "
                    f"step, expected {per_step}")
            del caches
        del params, captured


def phase_parity():
    """fp32 compute, the same params (drawn on the card, copied to the host),
    card against CPU: teacher-forced prefill logits, 8 decode steps, their
    greedy tokens and the caches; on the card the attention and Mamba cache
    leaves keep their storage from prefill through decode."""
    import torch

    from repro_torch.models import lm

    for arch, engine, overrides in PARITY_RUNS:
        cfg = _run_cfg(arch, engine).with_(compute_dtype="float32", **overrides)
        params_gpu = lm.lm_init(torch.Generator(device="cuda").manual_seed(7), cfg, device="cuda")
        params_cpu = _tree_to(params_gpu, "cpu")
        g = torch.Generator().manual_seed(8)
        prompt = torch.randint(0, cfg.vocab, (4, 64), generator=g)
        forced = torch.randint(0, cfg.vocab, (4, 8), generator=g)
        logits, caches = {}, {}
        with torch.inference_mode():
            for dev, params in (("cpu", params_cpu), ("cuda", params_gpu)):
                c = lm.lm_init_caches(cfg, 4, 72, device=dev)
                out, c = lm.lm_prefill(params, cfg, {"inputs": prompt.to(dev)}, c)
                ptrs = {k: v.data_ptr() for k, v in c["layers"].items()}
                steps = [out]
                for i in range(forced.shape[1]):
                    out, c = lm.lm_decode_step(params, cfg, c, forced[:, i:i + 1].to(dev))
                    steps.append(out)
                in_place = {k: v.data_ptr() for k, v in c["layers"].items()} == ptrs
                on = {t.device.type for t in steps + list(c["layers"].values())}
                require(on == {dev}, f"parity {arch}: the {dev} run's outputs lie on {on}")
                logits[dev] = torch.cat(steps, dim=1).cpu()
                caches[dev] = {k: v.cpu() for k, v in c["layers"].items()}
        err = (logits["cuda"] - logits["cpu"]).abs().max().item()
        cache_err = max((caches["cuda"][k] - caches["cpu"][k]).abs().max().item()
                        for k in caches["cpu"])
        same_tokens = torch.equal(logits["cuda"][..., : cfg.vocab].argmax(-1),
                                  logits["cpu"][..., : cfg.vocab].argmax(-1))
        finite = bool(torch.isfinite(logits["cuda"]).all().item())
        emit({"phase": "parity", "arch": arch,
              "engine": cfg.scan_engine if cfg.cell in ("sru", "qrnn") else None,
              "compute": "float32",
              "n_layers": cfg.n_layers, "depth_cut_from": _run_cfg(arch, engine).n_layers
              if overrides else None,
              "logits_shape": list(logits["cuda"].shape), "max_abs_err": err,
              "cache_max_abs_err": cache_err, "same_greedy_tokens": same_tokens,
              "tol": PARITY_TOL, "finite": finite,
              "cache_in_place": in_place if cfg.cell is None else None})
        require(finite and err <= PARITY_TOL and cache_err <= PARITY_TOL and same_tokens,
                f"parity {arch} {engine}: logits err {err}, cache err {cache_err} > "
                f"{PARITY_TOL} or greedy tokens differ ({same_tokens})")
        require(cfg.cell is not None or in_place,
                f"parity {arch}: decode moved the cache's storage")
        del params_gpu, params_cpu


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES}")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    if any(p not in PHASES for p in phases):
        ap.error(f"unknown phase in {phases}; have {PHASES}")

    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError:
        print(f"chip_smoke: the repository's src/repro_torch is not beside {__file__}",
              file=sys.stderr)
        return 2
    # fp32 products in full fp32 on both sides of every comparison.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    try:
        results, seconds = {}, {}
        for name in PHASES:
            if name in phases:
                t0 = time.perf_counter()
                results[name] = globals()[f"phase_{name}"]()
                seconds[name] = time.perf_counter() - t0
        emit({"phase_seconds": seconds})
        summaries, launches = results.get("kernels"), results.get("serve")
        if summaries and launches is not None:
            for name, s in summaries.items():
                s["launches"] = launches[name]
                require(s["launches"] > 0, f"{name}: no launch on the main path")
            emit({"kernels": list(summaries.values())})
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        )
        print(smi.stdout.strip().splitlines()[0], flush=True)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
