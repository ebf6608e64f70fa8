#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py                  # every phase, as the check runs it
    python3 chip_smoke.py --phases build,kernels

Phases, each printing one JSON line per step:

  build    compile every CUDA source with nvcc (all at once), report the time,
           the nvcc version and ptxas's register/shared-memory report;
  kernels  each kernel against its plain PyTorch version on the card, on the
           same inputs, at the main path's shapes (T in {64, 1}, B = 4, width
           1024, bf16; for the linear scan F = B * H = 4096) plus fp32,
           ragged-edge and long-sequence cases and one backward of the linear
           scan; max |error| against a stated tolerance, and kernel / plain
           times from CUDA events;
  serve    ``repro_torch.launch.serve.main`` in batch mode at full width
           (``--batch 4 --prompt-len 64 --gen-len 32``) for the stacked and
           fused configs, the base SRU/QRNN configs under ``--engine pallas``,
           ``sru-paper-large`` on its own chunked engine and
           ``lstm-paper-large``; each run's launches of each kernel
           (counts set to 0 just before the run, read just after);
  profile  per config, a decode step's host time and torch.profiler's device
           time by kernel, hence the device's idle share;
  parity   the stacked SRU and QRNN LMs, the base SRU and QRNN LMs under
           pallas, and the LSTM LM at full width in fp32 compute, same
           params, on the card versus the plain path on the CPU:
           teacher-forced prefill logits and 8 decode steps.

Then one ``{"phase_seconds": {...}}`` line (each phase's wall time, the
serve phase's warm-ups included), one ``{"kernels": [...]}`` line (launches
from the serve phase), the
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
# (arch, --engine override): the runs of the serve phase.
SERVE_RUNS = (
    ("sru-paper-large-stacked", None), ("qrnn-paper-large-stacked", None),
    ("sru-paper-large-fused", None), ("qrnn-paper-large-fused", None),
    ("sru-paper-large", "pallas"), ("qrnn-paper-large", "pallas"),
    ("sru-paper-large", None), ("lstm-paper-large", None),
)
PROFILE_RUNS = SERVE_RUNS[:6]
PARITY_RUNS = (
    ("sru-paper-large-stacked", None), ("qrnn-paper-large-stacked", None),
    ("sru-paper-large", "pallas"), ("qrnn-paper-large", "pallas"),
    ("lstm-paper-large", None),
)
KERNELS = ("fused_rnn_layer", "fused_rnn_stack", "linear_scan")
OUR_KERNEL_SYMBOLS = ("fused_rnn_layer_kernel", "linear_scan_kernel")  # device symbol names
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor / fp32 SIMT
# Tolerances, kernel vs plain version on the same card and inputs. Both sides
# compute in fp32; they differ by the GEMM's summation order over K <= 2048
# products and by a few ulp of expf/tanhf/rsqrtf, carried through up to four
# layers: ATOL. A bf16 output can then round one bf16 ulp apart: RTOL_BF16
# times the largest output magnitude.
ATOL = 5e-4
RTOL_BF16 = 2.0 ** -7
# Parity (phase 4): fp32 LM on the card vs the CPU, through 4 layers and the
# 8192-wide head; logits are O(1). The same sources of difference as ATOL.
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

def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Device time per call, from CUDA events around ``iters`` calls.

    The stream is first held by a sleep kernel longer than the host needs to
    enqueue all the calls, so the calls then run back to back and the events
    time the device, not the Python wrapper's issue rate.
    """
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    per_call_s = time.perf_counter() - t0  # host + device: an upper bound on enqueue
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2.0 * iters * per_call_s, 5.0) * 2e9))  # cycles at <= 2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(read_write_bytes: int, ops: float, dtype: str):
    t_bytes = read_write_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(outs, refs, dtype: str):
    """Worst output: (max |err|, its tolerance, finite?)."""
    import torch

    worst = (0.0, ATOL, True)
    for o, r in zip(outs, refs):
        if o is None:
            continue
        err = (o.float() - r.float()).abs().max().item()
        tol = ATOL + (RTOL_BF16 * r.float().abs().max().item() if dtype == "bfloat16" else 0.0)
        finite = bool(torch.isfinite(o.float()).all().item())
        if not finite or err / tol > worst[0] / worst[1]:
            worst = (err, tol, finite and worst[2])
    return worst


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


def _layer_case(name, mode, T, B, d, H, dtype_name, seed, block_t=32):
    """Inputs for one whole-layer kernel case, made on the card from a seed."""
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
    if mode == "qrnn":
        kw["tail"] = torch.randn((1, B, d), generator=g, device=dev).to(dt)
    if mode == "sru_proj":
        kw["wskip"] = uni(d, H, scale=d ** -0.5)
    args = (u, taps, b3, c0)
    K = d * n_taps
    ops = 2.0 * T * B * K * 3 * H + (2.0 * T * B * d * H if mode == "sru_proj" else 0.0)
    out_bytes = (T * B * H + B * H) * u.element_size()  # h, c_last
    rw = nbytes(u, *taps, b3, c0, kw.get("tail"), kw.get("wskip")) + out_bytes
    return name, args, kw, rw, ops


def _stack_case(name, cell, T, B, H, L, dtype_name, seed, block_t=32):
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
    args = (x, taps, b3L, lnL, c0L, tailsL)
    ops = 2.0 * L * T * B * n_taps * H * 3 * H
    out_bytes = nbytes(x) + nbytes(c0L) + nbytes(tailsL)
    rw = nbytes(x, *taps, b3L, lnL, c0L, tailsL) + out_bytes
    return name, args, {"block_t": min(T, block_t)}, rw, ops


def _scan_case(name, T, F, dtype_name, seed):
    """Inputs for one linear-scan case: a = sigmoid(normal), b, c0 normal."""
    import torch

    dev = torch.device("cuda")
    dt = getattr(torch, dtype_name)
    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.sigmoid(torch.randn((T, F), generator=g, device=dev)).to(dt)
    b = torch.randn((T, F), generator=g, device=dev).to(dt)
    c0 = torch.randn((F,), generator=g, device=dev).to(dt)
    rw = nbytes(a, b, c0) + nbytes(b)  # out (T, F) in b's dtype
    return name, (a, b, c0), {}, rw, 2.0 * T * F


def _summary(kname, source, replaces, rows):
    main = rows[0]  # the main path's prefill shape: T = 64, bf16
    decode = next(r for r in rows if r["T"] == 1)
    return {
        "name": kname, "route": "cuda", "source": source,
        "replaces": replaces, "launches": 0,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": None,
        "case": main["case"], "decode_case": decode["case"],
        "decode_ms": decode["ms"], "decode_plain_ms": decode["plain_ms"],
        "decode_bound_ms": decode["bound_ms"], "cases_passed": len(rows),
    }


def _run_cases(kname, wrapper, plain, cases):
    import torch

    rows = []
    for dtype, T, name, args, kw, rw, ops in cases:
        out = wrapper(*args, **kw)
        ref = plain(*args, **kw)
        torch.cuda.synchronize()
        out, ref = (x if isinstance(x, tuple) else (x,) for x in (out, ref))
        err, tol, finite = compare(out, ref, dtype)
        ms = time_ms(lambda: wrapper(*args, **kw), iters=50)
        plain_ms = time_ms(lambda: plain(*args, **kw), iters=3, warmup=1)
        b_ms, b_by = bound(rw, ops, dtype)
        row = {
            "phase": "kernels", "kernel": kname, "case": name, "dtype": dtype, "T": T,
            "max_abs_err": err, "tol": tol, "finite": finite, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        }
        emit(row)
        require(finite and err <= tol, f"{kname} [{name}]: err {err} > tol {tol}")
        rows.append(row)
    return rows


def _scan_backward_row():
    """One backward through ``ops.linear_scan`` (forward + reverse-time
    kernel) against autograd through the plain version, fp32, (T, B, H) =
    (64, 4, 1024). ``ms``, ``plain_ms`` and the bound are those of the
    backward's two kernel calls (the forward, then the reverse-time call on
    its prepared time-flipped operands) and of their plain versions;
    ``op_ms`` is the whole autograd forward + backward, flips, products and
    dispatch included, and has no bound."""
    import torch

    from repro_torch.kernels.linear_scan import ops
    from repro_torch.kernels.linear_scan.linear_scan import linear_scan_kernel
    from repro_torch.kernels.linear_scan.ref import linear_scan_ref

    T, B, H = 64, 4, 1024
    _, (a0, b0, c00), _, _, _ = _scan_case("bwd", T, B * H, "float32", 301)
    w = torch.randn((T, B * H), generator=torch.Generator(device="cuda").manual_seed(302),
                    device="cuda")

    def fwd_bwd(fn):
        a, b, c0 = (t.clone().requires_grad_(True) for t in (a0, b0, c00))
        (fn(a, b, c0) * w).sum().backward()
        return a.grad, b.grad, c0.grad

    grads, refs = fwd_bwd(ops.linear_scan), fwd_bwd(linear_scan_ref)
    torch.cuda.synchronize()
    err, tol, finite = compare(grads, refs, "float32")
    # The reverse-time call's operands, as _LinearScan.backward prepares them.
    a_rev = torch.cat([a0[1:], torch.zeros_like(a0[:1])], dim=0).flip(0).contiguous()
    g_rev, z0 = w.flip(0).contiguous(), torch.zeros_like(c00)

    def two_calls(fn):
        fn(a0, b0, c00)
        fn(a_rev, g_rev, z0)

    # Each call reads a, b, c0 once and writes c once; 2 operations per element.
    rw = 2 * (nbytes(a0, b0, c00) + nbytes(b0))
    b_ms, b_by = bound(rw, 2 * 2.0 * T * B * H, "float32")
    row = {
        "phase": "kernels", "kernel": "linear_scan", "case": "backward T=64 F=4096 fp32",
        "dtype": "float32", "T": T, "max_abs_err": err, "tol": tol, "finite": finite,
        "ms": time_ms(lambda: two_calls(linear_scan_kernel), iters=50),
        "plain_ms": time_ms(lambda: two_calls(linear_scan_ref), iters=3, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by,
        "op_ms": time_ms(lambda: fwd_bwd(ops.linear_scan), iters=20),
    }
    emit(row)
    require(finite and err <= tol, f"linear_scan [backward]: err {err} > tol {tol}")
    return row


def phase_kernels():
    """Every kernel against its plain version. Returns per-kernel summaries."""
    from repro_torch.kernels.fused_rnn import fused_rnn, stacked
    from repro_torch.kernels.linear_scan import linear_scan
    from repro_torch.kernels.linear_scan.ref import linear_scan_ref

    layer_cases, stack_cases, scan_cases = [], [], []
    seed = 0
    for T in (64, 1):
        for mode, d in (("sru_identity", 1024), ("qrnn", 1024), ("sru_proj", 512)):
            seed += 1
            layer_cases.append(("bfloat16", T) + _layer_case(
                f"{mode} T={T} d={d}", mode, T, 4, d, 1024, "bfloat16", seed))
        for cell in ("sru", "qrnn"):
            seed += 1
            stack_cases.append(("bfloat16", T) + _stack_case(
                f"{cell} L=4 T={T}", cell, T, 4, 1024, 4, "bfloat16", seed))
        seed += 1
        scan_cases.append(("bfloat16", T) + _scan_case(
            f"T={T} F=4096", T, 4096, "bfloat16", seed))
    layer_cases.append(("float32", 64) + _layer_case(
        "sru_identity T=64 d=1024 fp32", "sru_identity", 64, 4, 1024, 1024, "float32", 101))
    layer_cases.append(("float32", 13) + _layer_case(
        "qrnn ragged T=13 d=H=1000 fp32", "qrnn", 13, 3, 1000, 1000, "float32", 102, 4))
    stack_cases.append(("float32", 64) + _stack_case(
        "sru L=4 T=64 fp32", "sru", 64, 4, 1024, 4, "float32", 103))
    stack_cases.append(("float32", 13) + _stack_case(
        "qrnn ragged L=2 T=13 H=1000 fp32", "qrnn", 13, 3, 1000, 2, "float32", 104, 4))
    for name, T, F, seed in (("T=64 F=4096 fp32", 64, 4096, 201),
                             ("ragged T=13 F=3000 fp32", 13, 3000, 202),
                             ("T=64 F=1 fp32", 64, 1, 203),
                             ("long T=4096 F=128 fp32", 4096, 128, 204)):
        scan_cases.append(("float32", T) + _scan_case(name, T, F, "float32", seed))

    fused_src = "src/repro_torch/kernels/fused_rnn/csrc/fused_rnn_layer.cu"
    summaries = {}
    for kname, wrapper, plain, cases, source, replaces in (
        ("fused_rnn_layer", fused_rnn.fused_rnn_layer, fused_rnn.fused_rnn_layer_plain,
         layer_cases, fused_src, "src/repro/kernels/fused_rnn/fused_rnn.py:113"),
        ("fused_rnn_stack", stacked.fused_rnn_stack, stacked.fused_rnn_stack_plain,
         stack_cases, fused_src, "src/repro/kernels/fused_rnn/stacked.py:144"),
        ("linear_scan", linear_scan.linear_scan_kernel, linear_scan_ref, scan_cases,
         "src/repro_torch/kernels/linear_scan/csrc/linear_scan.cu",
         "src/repro/kernels/linear_scan/linear_scan.py:76"),
    ):
        rows = _run_cases(kname, wrapper, plain, cases)
        if kname == "linear_scan":
            rows.append(_scan_backward_row())
        summaries[kname] = _summary(kname, source, replaces, rows)
    return summaries


def _launch_counters():
    from repro_torch.kernels.fused_rnn import fused_rnn, stacked
    from repro_torch.kernels.linear_scan import linear_scan

    return {"fused_rnn_layer": fused_rnn, "fused_rnn_stack": stacked, "linear_scan": linear_scan}


def _run_cfg(arch, engine):
    from repro_torch.configs.registry import get_config

    cfg = get_config(arch)
    return cfg.with_(scan_engine=engine) if engine else cfg


def _expected_launches(cfg, calls: int) -> dict:
    """Launches of each kernel over ``calls`` prefill/decode calls: one per
    layer per call on the kernel the config's engine routes to; none for
    LSTM and the plain engines."""
    want = dict.fromkeys(KERNELS, 0)
    n = cfg.n_layers * calls
    if cfg.cell == "lstm":
        return want
    if cfg.scan_engine == "fused_stack" and cfg.fuse_depth:
        want["fused_rnn_stack"] = n
    elif cfg.scan_engine in ("fused", "fused_stack"):
        want["fused_rnn_layer"] = n
    elif cfg.scan_engine == "pallas":
        want["linear_scan"] = n
    return want


def phase_serve():
    """The main path: each run through serve.main, with every kernel's count
    set to 0 just before the run and read just after. Returns the launches
    summed over the runs."""
    from repro_torch.launch import serve

    gen_len, prompt_len, batch = 32, 64, 4
    counters = _launch_counters()
    # Warm-up of every run at the measured shapes: CUDA context, allocator,
    # cuBLAS's first call at each GEMM shape, and the first launch of each
    # kernel on the run's path (runs that share their cuBLAS shapes still
    # differ in the elementwise kernels they launch first).
    for arch, engine in SERVE_RUNS:
        extra = ["--engine", engine] if engine else []
        with contextlib.redirect_stdout(io.StringIO()):
            require(serve.main(["--arch", arch, "--gen-len", "2", "--prompt-len", str(prompt_len)]
                               + extra) == 0, f"serve warm-up {arch} {engine}")
    totals = dict.fromkeys(KERNELS, 0)
    for arch, engine in SERVE_RUNS:
        extra = ["--engine", engine] if engine else []
        buf = io.StringIO()
        for mod in counters.values():
            mod.LAUNCHES = 0
        with contextlib.redirect_stdout(buf):
            rc = serve.main([
                "--arch", arch, "--batch", str(batch), "--prompt-len", str(prompt_len),
                "--gen-len", str(gen_len),
            ] + extra)
        launches = {k: mod.LAUNCHES for k, mod in counters.items()}
        require(rc == 0, f"serve {arch} {engine} returned {rc}")
        line = next(x for x in buf.getvalue().splitlines() if x.startswith("serve-stats "))
        stats = json.loads(line[len("serve-stats "):])
        cfg = _run_cfg(arch, engine)
        calls = 1 + (gen_len - 1)  # one prefill, gen_len - 1 decode steps
        want = _expected_launches(cfg, calls)
        tokens = stats.pop("tokens")
        ok_tokens = all(0 <= t < cfg.vocab for row in tokens for t in row)
        emit({"phase": "serve", **stats, "engine": cfg.scan_engine, "launches": launches,
              "launches_per_step": sum(launches.values()) / calls,
              "sample_tokens": tokens[0][:8]})
        require(launches == want, f"serve {arch} {engine}: launches {launches} != {want}")
        require(ok_tokens and len(tokens) == batch and len(tokens[0]) == gen_len,
                f"serve {arch} {engine}: bad tokens")
        for k, n in launches.items():
            totals[k] += n
    return totals


def phase_profile():
    """Where a decode step's time goes (B = 4, after a 64-token prefill): host
    clock per step without the profiler, then torch.profiler's device time
    per step by kernel. Idle share = 1 - device time / step time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import lm
    from repro_torch.models.layers import _dtype
    from repro_torch.training.steps import build_decode_step, build_prefill_step

    steps = 8
    for arch, engine in PROFILE_RUNS:
        cfg = _run_cfg(arch, engine)
        params = lm._cast_params(
            lm.lm_init(torch.Generator().manual_seed(0), cfg, device="cuda"),
            _dtype(cfg.compute_dtype),
        )
        prefill = build_prefill_step(cfg, batch=4, max_len=64 + 3 * steps, device="cuda")
        decode = build_decode_step(cfg)
        prompt = torch.zeros((4, 64), dtype=torch.long, device="cuda")
        logits, caches = prefill(params, {"inputs": prompt})

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
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
        kernels = []  # device-side events only (kernels, copies): no double count
        for e in prof.key_averages():
            dev_us = getattr(e, "self_device_time_total", 0.0) or 0.0
            if e.device_type == DeviceType.CUDA and dev_us > 0:
                kernels.append((dev_us / steps, e.count / steps, e.key))
        kernels.sort(reverse=True)
        device_ms = sum(k[0] for k in kernels) / 1e3 if kernels else None
        ours_us = sum(k[0] for k in kernels if any(n in k[2] for n in OUR_KERNEL_SYMBOLS))
        emit({"phase": "profile", "arch": arch, "engine": cfg.scan_engine,
              "step_ms": wall_ms, "device_ms": device_ms,
              "idle_share": None if device_ms is None else 1.0 - device_ms / wall_ms,
              "our_kernels_us_per_step": ours_us,
              "top_kernels_us_per_step": [[round(k[0], 2), k[1], k[2][:70]] for k in kernels[:6]]})


def phase_parity():
    import torch

    from repro_torch.bridge import params_from_numpy, params_to_numpy
    from repro_torch.models import lm

    for arch, engine in PARITY_RUNS:
        cfg = _run_cfg(arch, engine).with_(compute_dtype="float32")
        params_cpu = lm.lm_init(torch.Generator().manual_seed(7), cfg, device="cpu")
        params_gpu = params_from_numpy(params_to_numpy(params_cpu), device="cuda")
        g = torch.Generator().manual_seed(8)
        prompt = torch.randint(0, cfg.vocab, (4, 64), generator=g)
        forced = torch.randint(0, cfg.vocab, (4, 8), generator=g)
        logits, caches = {}, {}
        with torch.inference_mode():
            for dev, params in (("cpu", params_cpu), ("cuda", params_gpu)):
                c = lm.lm_init_caches(cfg, 4, 72, device=dev)
                out, c = lm.lm_prefill(params, cfg, {"inputs": prompt.to(dev)}, c)
                steps = [out]
                for i in range(forced.shape[1]):
                    out, c = lm.lm_decode_step(params, cfg, c, forced[:, i:i + 1].to(dev))
                    steps.append(out)
                logits[dev] = torch.cat(steps, dim=1).cpu()
                caches[dev] = {k: v.cpu() for k, v in c["layers"].items()}
        err = (logits["cuda"] - logits["cpu"]).abs().max().item()
        cache_err = max((caches["cuda"][k] - caches["cpu"][k]).abs().max().item()
                        for k in caches["cpu"])
        finite = bool(torch.isfinite(logits["cuda"]).all().item())
        emit({"phase": "parity", "arch": arch, "engine": cfg.scan_engine, "compute": "float32",
              "logits_shape": list(logits["cuda"].shape), "max_abs_err": err,
              "cache_max_abs_err": cache_err, "tol": PARITY_TOL, "finite": finite})
        require(finite and err <= PARITY_TOL and cache_err <= PARITY_TOL,
                f"parity {arch} {engine}: logits err {err}, cache err {cache_err} > {PARITY_TOL}")


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
