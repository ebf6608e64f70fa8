"""Serving entry point of the port (``repro/launch/serve.py``), in two modes
(``--mode``):

* ``batch`` (default) — one batched prefill, then ``--gen-len`` greedy decode
  steps, all lanes in lockstep;
* ``continuous`` — a thin layer over ``serving/`` (the ``Scheduler``,
  ``run_continuous``): ``--requests`` independent streams arrive open-loop
  (Poisson at ``--arrival-rate`` req/s; 0 = all at t=0) with mixed prompt
  and generation lengths, are admitted into ``--batch`` slots as lanes free
  up, chunk-prefilled (``--chunk``) while resident streams keep decoding, and
  report per-stream TTFT/TPOT, goodput and slot occupancy. RNN stacks only,
  as in JAX. ``--prefix-cache-mb``, ``--async-depth`` and ``--prefix-share``
  are the JAX flags; ``--headline-trace`` replays the JAX benchmarks'
  seed-pinned trace (``serving/workload.py::HEADLINE_TRACE``) instead.

Runs on the card unless ``--device cpu`` is given:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch sru-paper-large-stacked \\
        --batch 4 --prompt-len 64 --gen-len 32

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b --reduced --device cpu

    PYTHONPATH=src python -m repro_torch.launch.serve --arch sru-paper-large-stacked \\
        --mode continuous --requests 16 --batch 4 --prompt-len 64 --gen-len 32

The port serves every ``paper_rnn`` config (SRU/QRNN/LSTM, the ``*-int8``
ones included), the dense GQA attention LMs ``llama3-8b`` and
``smollm-360m``, whose decode attention runs on the CUDA port of the
``gqa_decode`` kernel (B5), and the Mamba-2 LM ``mamba2-2.7b``, whose every
SSD (prefill and each decode step) runs on the CUDA port of the chunked
``ssd`` kernel (B4). Other archs are refused by ``lm_init``.

``--engine`` overrides ``cfg.scan_engine`` with any of the six engines of
the JAX ``launch/serve.py`` (``ENGINE_MATRIX``); an unknown one exits with
the list (``validate_engine``, the engine and int8 checks of the JAX
``validate_engine_mesh`` without its mesh parts). LSTM, the attention LMs
and Mamba-2 do not consult the engine. ``--weight-quant int8`` overrides
``cfg.weight_quant`` (the ``*-int8`` configs carry it): the SRU/QRNN gate
slabs are quantized at init and served through the int8 forms of the fused
kernels, on ``fused``/``fused_stack`` only; it leaves every other leaf (all
of an attention LM) as it is, as in JAX. A config's ``ring_overlap`` changes
nothing on one device.
On the card every step runs as a CUDA graph, as the JAX ``launch/serve.py``
runs each step as one jitted executable (batch: ``capture_batch_steps``;
continuous: ``Scheduler.warmup``; the capture's time is ``capture_ms``);
``main(argv, graphs=False)`` runs the eager steps instead, for comparison
(no flag: the JAX script has none for jit). On the CPU the steps run
eagerly. Speculative decode, the telemetry flags and the mesh flags of the
JAX ``launch/serve.py`` wait for later slices. Besides the human-readable
lines, a batch run prints one ``serve-stats {json}`` line and a continuous
run one ``continuous-stats {json}`` line: timings, whether the steps ran as
graphs, whether the caches kept their storage, the card's peak memory
(``peak_mem_gb``, null on the CPU) and the tokens (per request id in
continuous mode).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.models import lm
from repro_torch.models.layers import _dtype, resolve_device
from repro_torch.serving import (Scheduler, headline_poisson_trace, poisson_trace,
                                 shared_prefix_trace)
from repro_torch.training import graphs as step_graphs
from repro_torch.training.steps import build_decode_step, build_prefill_step

# How each engine runs an SRU/QRNN layer on the card; its keys are the engines.
ENGINE_MATRIX = {
    "sequential": "plain PyTorch; gate GEMM, then a step-by-step recurrence",
    "chunked": "plain PyTorch; gate GEMM, then the MTS schedule (associative "
               "inside blocks of mts_block_size)",
    "associative": "plain PyTorch; gate GEMM, then a log-depth prefix scan",
    "pallas": "gate GEMM, then the linear-scan CUDA kernel (B3)",
    "fused": "the whole-layer CUDA kernel (B1), one launch per layer",
    "fused_stack": "the depth-fused stack (B2; d_model == hidden)",
}
ENGINES = tuple(ENGINE_MATRIX)


def _matrix_lines() -> str:
    rows = "\n".join(f"  {e:<12} {d}" for e, d in ENGINE_MATRIX.items())
    return f"supported engines:\n{rows}"


def validate_engine(cfg) -> None:
    """Fail fast on an engine the port does not serve, naming the engines,
    and on int8 gate slabs where no kernel dequantizes them (LSTM, and every
    engine but ``fused``/``fused_stack``)."""
    engine = cfg.scan_engine
    if engine not in ENGINES:
        raise SystemExit(
            f"serve: unknown engine {engine!r} (from --engine or the "
            f"{cfg.name!r} config)\n{_matrix_lines()}"
        )
    if cfg.weight_quant == "int8":
        if cfg.cell == "lstm":
            raise SystemExit(
                "serve: --weight-quant int8 does not apply to LSTM: only the "
                "SRU/QRNN lane-major gate slabs quantize "
                "(kernels/fused_rnn/layout.py); the LSTM recurrent GEMM "
                "stays fp."
            )
        if cfg.cell in ("sru", "qrnn") and engine not in ("fused", "fused_stack"):
            raise SystemExit(
                f"serve: --weight-quant int8 requires engine 'fused' or "
                f"'fused_stack' for cell {cfg.cell!r}: dequantization happens "
                f"INSIDE the fused kernels (after the gate GEMM accumulate); "
                f"the XLA engines would need fp slabs.\n{_matrix_lines()}"
            )


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _greedy(cfg, logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits[:, -1, : cfg.vocab], dim=-1)[:, None]


def capture_batch_steps(cfg, prefill_step, decode_step, params, inputs):
    """The batch path's two steps as CUDA graphs, as the JAX
    ``launch/serve.py`` jits them. Each step is warmed up eagerly first (the decode step over clones
    of the warm-up prefill's caches), then the prefill is captured at the
    run's (batch, prompt length, max_len), then the decode step over the
    caches the captured prefill outputs, which it updates in place, in the
    prefill graph's memory pool. Returns the two ``CapturedStep``s."""
    logits, caches = step_graphs.warm_up(prefill_step, params, inputs)
    token = _greedy(cfg, logits)
    step_graphs.warm_up(decode_step, params, caches, token)
    del logits, caches
    prefill = step_graphs.capture(prefill_step, params, inputs)
    decode = step_graphs.capture(decode_step, params, prefill.outputs[1], token,
                                 pool=prefill.pool)
    return prefill, decode


def run_batch(cfg, params, args, device: torch.device, graphs: bool = True) -> dict:
    """The lockstep path: one prefill, ``gen_len - 1`` decode steps. On a
    CUDA device with ``graphs`` both steps run as CUDA graph replays,
    captured before the timed region (``capture_batch_steps``); otherwise,
    and always on the CPU, the eager steps run. The greedy argmax runs
    outside the steps, as outside the jit in JAX. Returns the timings,
    whether the caches kept their storage, and the generated tokens."""
    max_len = args.prompt_len + args.gen_len
    prefill = build_prefill_step(cfg, batch=args.batch, max_len=max_len, device=device)
    decode = build_decode_step(cfg)
    gen = torch.Generator().manual_seed(args.seed)
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len), generator=gen)
    inputs = {"inputs": prompt.to(device)}

    captured = graphs and device.type == "cuda"
    capture_ms = None
    if captured:
        _sync(device)
        t0 = time.perf_counter()
        prefill, decode = capture_batch_steps(cfg, prefill, decode, params, inputs)
        _sync(device)
        capture_ms = (time.perf_counter() - t0) * 1e3

    _sync(device)
    t0 = time.perf_counter()
    logits, caches = prefill(params, inputs)
    _sync(device)
    t_prefill = time.perf_counter() - t0
    storage = [t.data_ptr() for t in step_graphs.leaves(caches)]

    tok = _greedy(cfg, logits)
    out_tokens = [tok]
    t0 = time.perf_counter()
    for _ in range(args.gen_len - 1):
        logits, caches = decode(params, caches, tok)
        tok = _greedy(cfg, logits)
        out_tokens.append(tok)
    _sync(device)
    t_decode = time.perf_counter() - t0
    tokens = torch.cat(out_tokens, dim=1).cpu()
    n_dec = args.gen_len - 1
    return {
        "arch": cfg.name,
        "device": str(device),
        "graphs": captured,
        "capture_ms": capture_ms,
        "prefill_ms": t_prefill * 1e3,
        "decode_ms": t_decode * 1e3,
        "prefill_tok_s": args.batch * args.prompt_len / max(t_prefill, 1e-9),
        "decode_tok_s": args.batch * n_dec / max(t_decode, 1e-9),
        "decode_steps": n_dec,
        "cache_in_place": [t.data_ptr() for t in step_graphs.leaves(caches)] == storage,
        "tokens": tokens.tolist(),
    }


def continuous_trace(cfg, args, chunk: int):
    """The open-loop trace of a continuous run, as the JAX
    ``run_continuous`` builds it from the flags: a shared-prefix trace under
    ``--prefix-share``, else Poisson arrivals with prompts of
    ``--prompt-len`` and half of it; ``--headline-trace`` replays
    ``headline_poisson_trace`` instead."""
    if args.headline_trace:
        return headline_poisson_trace(cfg.vocab)
    gen_mix = ((max(2, args.gen_len // 4), 0.8), (args.gen_len, 0.2))
    if args.prefix_share > 0:
        # the largest chunk-aligned prefix that still leaves a tail token (a
        # cached boundary sits strictly inside the prompt); at least one
        # chunk where the prompt allows
        prefix_len = min(max(args.prompt_len // 2, chunk) // chunk * chunk,
                         (args.prompt_len - 1) // chunk * chunk)
        return shared_prefix_trace(
            args.requests, rate=args.arrival_rate, prefix_len=prefix_len,
            prompt_len=args.prompt_len, share=args.prefix_share, gen_mix=gen_mix,
            vocab=cfg.vocab, seed=args.seed)
    return poisson_trace(
        args.requests, rate=args.arrival_rate,
        prompt_lens=sorted({max(1, args.prompt_len // 2), args.prompt_len}),
        gen_mix=gen_mix, vocab=cfg.vocab, seed=args.seed)


def run_continuous(cfg, params, args, device: torch.device, graphs: bool = True) -> dict:
    """The continuous-batching path (JAX ``run_continuous``): the flags'
    open-loop trace served by a ``Scheduler`` over ``--batch`` slots, its
    steps captured as CUDA graphs on the card before the run (``graphs``).
    Returns the engine's metrics report with the capture time, whether the
    steps ran as graphs and the caches kept their storage, the prefix
    cache's report, and each request's tokens."""
    engine = Scheduler(
        cfg, params, batch=args.batch, chunk=args.chunk, queue_capacity=args.queue_cap,
        prefix_cache_mb=args.prefix_cache_mb, async_depth=args.async_depth,
        device=device, graphs=graphs)
    trace = continuous_trace(cfg, args, engine.chunk)
    engine.warmup()
    _sync(device)
    engine.run(trace)
    _sync(device)
    rep = engine.metrics.report()
    rep.update(
        arch=cfg.name, device=str(device), graphs=engine.captured,
        capture_ms=engine.capture_ms, cache_in_place=engine.cache_in_place,
        chunk=engine.chunk, async_depth=args.async_depth, requests=len(trace),
        prefix_cache=engine.prefix_cache.report() if engine.prefix_cache else None,
        tokens={r.rid: list(r.tokens) for r in trace})
    return rep


def _print_continuous(rep: dict, args) -> None:
    print(
        f"continuous: {rep['completed']}/{rep['requests']} requests, "
        f"{rep['completed_tokens']} tokens in {rep['elapsed_s']*1e3:.0f}ms "
        f"({rep['goodput_tok_s']:.0f} tok/s goodput)"
    )
    print(
        f"  slots: {args.batch}  occupancy: {rep['occupancy_mean']*100:.0f}%  "
        f"ticks: {rep['ticks']} ({rep['prefill_chunks']} prefill chunks, "
        f"{rep['decode_steps']} decode steps)"
    )
    print(
        f"  ttft p50/p95: {rep['ttft_s']['p50']*1e3:.1f}/"
        f"{rep['ttft_s']['p95']*1e3:.1f}ms  "
        f"tpot p50: {rep['tpot_s']['p50']*1e3:.2f}ms  "
        f"fetch wait: {rep['fetch_wait_s']*1e3:.1f}ms "
        f"(async depth {args.async_depth})"
    )
    pc = rep["prefix_cache"]
    if pc is not None:
        print(
            f"  prefix cache: {rep['prefix_hits']} hits / "
            f"{rep['prefix_misses']} misses, "
            f"{rep['prefix_hit_tokens']} prompt tokens skipped; "
            f"{pc['entries']} entries, {pc['used_bytes']/2**20:.2f}/"
            f"{pc['budget_bytes']/2**20:.0f} MiB"
            + (f", {pc['evicted']} evicted" if pc["evicted"] else "")
        )
    done = sorted(rid for rid, toks in rep["tokens"].items() if toks)
    if done:
        print(f"sample tokens (rid {done[0]}):", np.asarray(rep["tokens"][done[0]][:16]))


def main(argv=None, graphs: bool = True) -> int:
    """The command line; ``graphs=False`` serves with the eager steps on the
    card too (``run_batch``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument(
        "--mode", choices=("batch", "continuous"), default="batch",
        help="batch: lockstep prefill+decode; continuous: slot-multiplexed "
             "streams through the serving engine (serving/)",
    )
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--engine", default=None,
        help=f"override cfg.scan_engine: one of {', '.join(ENGINES)}",
    )
    ap.add_argument(
        "--weight-quant", choices=("none", "int8"), default=None,
        help="override cfg.weight_quant: int8 stores the SRU/QRNN gate slabs "
             "as int8 with per-gate x per-lane-block scales, dequantized "
             "inside the fused kernels (engines fused/fused_stack only)",
    )
    ap.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="cuda (default) runs the CUDA kernels; cpu runs their plain versions",
    )
    ap.add_argument(
        "--requests", type=int, default=16,
        help="continuous mode: number of open-loop requests",
    )
    ap.add_argument(
        "--arrival-rate", type=float, default=0.0,
        help="continuous mode: Poisson arrival rate in req/s (0 = all at t=0)",
    )
    ap.add_argument(
        "--chunk", type=int, default=None,
        help="continuous mode: prefill chunk length (default cfg.mts_block_size)",
    )
    ap.add_argument(
        "--queue-cap", type=int, default=64,
        help="continuous mode: admission queue bound (backpressure beyond it)",
    )
    ap.add_argument(
        "--prefix-cache-mb", type=float, default=0.0,
        help="continuous mode: prefix-sharing state cache LRU budget in MiB "
             "(0 disables; hits skip chunk-prefill of the cached prompt prefix)",
    )
    ap.add_argument(
        "--async-depth", type=int, default=1,
        help="continuous mode: dispatched ticks in flight before the oldest "
             "retires (1 = synchronous, 2 = double-buffered tick pipeline)",
    )
    ap.add_argument(
        "--prefix-share", type=float, default=0.0,
        help="continuous mode: fraction of requests opening with one shared "
             "prompt prefix (shared_prefix_trace; 0 = fully random prompts)",
    )
    ap.add_argument(
        "--headline-trace", action="store_true",
        help="continuous mode: replay the JAX benchmarks' headline trace "
             "(128 requests, 150 req/s, prompt 32, seed 0) in place of the "
             "trace the other flags describe",
    )
    args = ap.parse_args(argv)
    if args.gen_len < 1 or args.prompt_len < 1 or args.batch < 1:
        ap.error("--batch, --prompt-len and --gen-len must be >= 1")
    if args.mode != "continuous" and args.headline_trace:
        ap.error("--headline-trace requires --mode continuous")

    cfg = get_config(args.arch)
    if args.engine:
        cfg = cfg.with_(scan_engine=args.engine)
    if args.weight_quant is not None:
        # Quantize on load: lm_init below quantizes the fresh gate slabs.
        cfg = cfg.with_(weight_quant=args.weight_quant)
    validate_engine(cfg)
    device = resolve_device(args.device)
    if args.reduced:
        cfg = cfg.reduced()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _sync(device)
    t0 = time.perf_counter()
    # The params are made in the compute dtype, leaf by leaf from a generator
    # on the device. The JAX package casts the fp32 params inside every step
    # (models/lm.py::_run_layers); the values are the same, and the per-step
    # casts in the port's lm.py are then no-ops.
    params = lm.lm_init(torch.Generator(device=device).manual_seed(args.seed), cfg,
                        device=device, dtype=_dtype(cfg.compute_dtype))
    _sync(device)
    init_ms = (time.perf_counter() - t0) * 1e3

    if args.mode == "continuous":
        stats = run_continuous(cfg, params, args, device, graphs=graphs)
    else:
        stats = run_batch(cfg, params, args, device, graphs=graphs)
    stats["init_ms"] = init_ms
    stats["peak_mem_gb"] = (torch.cuda.max_memory_allocated(device) / 1e9
                            if device.type == "cuda" else None)
    if args.mode == "continuous":
        _print_continuous(stats, args)
        print("continuous-stats " + json.dumps(stats))
        return 0
    print(f"prefill: {args.batch}x{args.prompt_len} in {stats['prefill_ms']:.1f}ms "
          f"({stats['prefill_tok_s']:.0f} tok/s)")
    print(f"decode:  {stats['decode_steps']} steps in {stats['decode_ms']:.1f}ms "
          f"({stats['decode_tok_s']:.0f} tok/s)")
    print("sample tokens:", stats["tokens"][0][:16])
    print("serve-stats " + json.dumps(stats))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
