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
  ``--speculative`` turns on speculative multi-token decode: a draft RNN
  (``--draft-config``, default ``sru-paper-draft``, params from ``--seed`` +
  1, reduced with ``--reduced``) proposes blocks of ``--spec-k`` tokens that
  the target verifies in one (B, k) chunk, with the plain greedy tokens.

Runs on the card unless ``--device cpu`` is given:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch sru-paper-large-stacked \\
        --batch 4 --prompt-len 64 --gen-len 32

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b --reduced --device cpu

    PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-2b

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b --reduced --device cpu

    PYTHONPATH=src python -m repro_torch.launch.serve --arch sru-paper-large-stacked \\
        --mode continuous --requests 16 --batch 4 --prompt-len 64 --gen-len 32

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qrnn-paper-large-fused \\
        --mode continuous --headline-trace --speculative --spec-k 4

The port serves every ``paper_rnn`` config (SRU/QRNN/LSTM, the ``*-int8``
ones included), the dense attention LMs ``llama3-8b``, ``smollm-360m`` and
``granite-20b`` (MQA), whose decode attention runs on the CUDA port of the
``gqa_decode`` kernel (B5), the frontend-stub LMs ``internvl2-2b`` and
``musicgen-large`` (batch mode: the prompt is a normal draw of embeddings,
and each decode step is fed the embedding row of the token it chose, as in
the JAX ``run_batch``), the Mamba-2 LM ``mamba2-2.7b``, whose every SSD
(prefill and each decode step) runs on the CUDA port of the chunked ``ssd``
kernel (B4), the hybrid ``zamba2-7b`` (both kernels; batch mode), the MoE
LMs ``mixtral-8x22b`` and ``qwen3-moe-235b-a22b`` (``models/moe.py``) and
the dense ``nemotron-4-340b`` (batch mode; one card holds these only cut in
depth, which ``chip_smoke.py`` does, since this script has no depth flag,
as JAX's has none). ``--mode continuous`` serves the RNN stacks only, as in
JAX.

``--engine`` overrides ``cfg.scan_engine`` with any of the six engines of
the JAX ``launch/serve.py`` (``ENGINE_MATRIX``); an unknown one exits with
the list (``validate_engine_mesh``, JAX's checks and messages). LSTM, the
attention LMs and Mamba-2 do not consult the engine. ``--weight-quant int8`` overrides
``cfg.weight_quant`` (the ``*-int8`` configs carry it): the SRU/QRNN gate
slabs are quantized at init and served through the int8 forms of the fused
kernels, on ``fused``/``fused_stack`` only; it leaves every other leaf (all
of an attention LM) as it is, as in JAX. A config's ``ring_overlap`` changes
nothing on one device.

Multi-GPU serving: ``--model-shards N`` serves on a (data, model) mesh of
ranks over ``torch.distributed`` (``launch/mesh.py``), one rank per shard.
Each rank holds its lane shard of the RNN gate slabs, biases and carries at
rest and runs its layers over them: the fused kernel (B1) under the fused
engines (``distribution/fused_sharded.py``; ``--ring-overlap``, or a
config's ``ring_overlap``, runs the sharded stack's ring schedule), and
under the other engines and for the LSTM the gate GEMM on the rank's
columns, the recurrence on its lanes and a gather of the output
(``distribution/tensor_parallel.py``). ``embed`` and ``unembed`` hold the
rank's block of the padded vocab: the lookup and the logits run
vocab-parallel, and the logits are gathered before the greedy argmax. The
dense and Mamba LMs and the hybrid (``llama3-8b``, ``smollm-360m``,
``granite-20b``, ``nemotron-4-340b``, the frontend stubs, ``mamba2-2.7b``,
``zamba2-7b``, and the MoE LMs' attention) hold their attention, dense MLP
and Mamba leaves and caches as JAX's ``param_specs`` / ``cache_specs``
place them and run per rank (``models/attention.py``, ``mamba.py``): the
rank's q heads, K/V from the gathered ``w_kv`` columns, the ``w_o`` and
``w_down`` rows summed over the axis, the MLP's and the Mamba mixer's "ff"
columns, the SSD on the rank's heads (B4), and at decode B5 on the rank's
KV heads or, where the KV heads do not divide the axis (``granite-20b``'s
MQA), on its slots of a sequence-sharded cache with the ranks' partials
combined by log-sum-exp. Where JAX's GSPMD would take the combine and the
gathers itself, the port writes them out: the ``w_kv`` / ``w_q`` column
products are gathered whole (``w_kv``'s columns fall on K and V, not on
heads), and the sequence-sharded cache's partial softmaxes are combined by
their log-sum-exp. The MoE LMs' experts (``mixtral-8x22b``,
``qwen3-moe-235b-a22b``) are held as JAX places them in every schedule
(``models/moe.py``): a rank's ``E / k`` experts where their count divides
the axis, run on their rows of the dispatch buffer and gathered over the
expert dim, else (JAX's ``ff_moe`` fallback) the rank's ``f / k`` columns
of every expert, the partial outputs summed over the axis. Norms and
``wq_scale`` are held whole on every model rank; the startup line lists, in
``sharding.describe_replications``'s form, the large dims that this rank's
layout replicates. Without an initialised process group
the command starts its ranks itself (``torch.multiprocessing``, a
``file://`` rendezvous in a temporary directory): under NCCL (the default on
the card) one per card, ``--model-shards`` of them per data group, as JAX
spreads its devices; under gloo (``--device cpu``, or ``--dist-backend
gloo`` where ranks share a card) ``--model-shards`` ranks. Inside an
initialised process group, or under ``torchrun`` (its ``env://``
rendezvous), it joins, and the ranks beyond one model group form the data
axis. Rank 0 prints the mesh, the backend, the replicated dims, each model
rank's bytes of gate slabs, of vocab leaves, of attention, MLP and Mamba
leaves and of MoE experts and the ``serve-stats`` (``continuous-stats``)
line. The sharded
steps run eagerly (``graphs: false``): gloo cannot be captured. ``--mode
continuous`` runs the ``Scheduler`` on the mesh (one a rank over its lane
shards, every decision on rank 0's clock; see ``serving/engine.py``), the
``--speculative`` draft sliced as the target, the telemetry sinks written
by rank 0. CUDA graphs of the NCCL steps are not ported yet. ``--engine pallas`` is
refused under a model axis, with JAX's message, as JAX refuses it.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch sru-paper-large-stacked \
        --reduced --device cpu --model-shards 2 [--ring-overlap]

    PYTHONPATH=src python -m repro_torch.launch.serve --arch sru-paper-large-stacked \
        --reduced --device cpu --mode continuous --model-shards 2

    PYTHONPATH=src python -m repro_torch.launch.serve --arch sru-paper-large-stacked \
        --model-shards 2 --dist-backend gloo   # two ranks sharing one card

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b --reduced \
        --device cpu --model-shards 2   # also granite-20b, mamba2-2.7b, zamba2-7b,
                                        # mixtral-8x22b, qwen3-moe-235b-a22b

On the card every step runs as a CUDA graph, as the JAX ``launch/serve.py``
runs each step as one jitted executable (batch: ``capture_batch_steps``;
continuous: ``Scheduler.warmup``; the capture's time is ``capture_ms``);
``main(argv, graphs=False)`` runs the eager steps instead, for comparison
(no flag: the JAX script has none for jit). On the CPU the steps run
eagerly.

Telemetry, continuous mode only, as in JAX: ``--trace-out`` (Chrome
trace-event JSON of tick-phase spans and request lifecycles, the span
catalog of ``docs/observability.md``), ``--metrics-jsonl`` (rolling
live-metrics rows every ``--metrics-every`` ticks), ``--prom-out`` (an
end-of-run Prometheus text snapshot), and ``--torch-profile DIR``, the
port's ``--jax-profile``: a ``torch.profiler`` capture of the warm-up and
the run into DIR, each step dispatch inside a ``record_function``/NVTX
range named by its tick phase. Any of these turns on the straggler monitor
(``runtime/monitor.py``); its flagged ticks are ``straggler`` instants on
the trace. ``tools/trace_check.py`` validates the trace and the rows:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch sru-paper-small --reduced \
        --device cpu --mode continuous --requests 8 --batch 3 --prompt-len 12 \
        --gen-len 8 --chunk 8 --trace-out /tmp/t.json --metrics-jsonl /tmp/m.jsonl \
        --metrics-every 16 --prom-out /tmp/m.prom
    python tools/trace_check.py /tmp/t.json --metrics-jsonl /tmp/m.jsonl \
        --expect-phase decode --expect-phase fetch --expect-phase retire

Besides the human-readable lines, a batch run prints one
``serve-stats {json}`` line and a continuous run one ``continuous-stats
{json}`` line: timings, whether the steps ran as graphs, whether the caches
kept their storage, the card's peak memory (``peak_mem_gb``, null on the
CPU), the tokens (per request id in continuous mode) and, in continuous
mode, the flagged ticks (``stragglers``), the trace's events
(``trace_events``), the metrics rows (``metrics_rows``) and whether the
profiler ran (``torch_profile``), each null when its flag is off.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.registry import get_config
from repro_torch.distribution import fused_sharded, sharding, tensor_parallel
from repro_torch.launch.mesh import GROUP_TIMEOUT, make_local_mesh, torchrun_world
from repro_torch.models import lm
from repro_torch.models.layers import _dtype, resolve_device
from repro_torch.observability import Telemetry, torch_profile, write_prometheus
from repro_torch.runtime.monitor import StepMonitor
from repro_torch.serving import (Scheduler, headline_poisson_trace, poisson_trace,
                                 shared_prefix_trace)
from repro_torch.training import graphs as step_graphs
from repro_torch.training.steps import build_decode_step, build_prefill_step
from repro_torch.tree import flatten_with_paths, tree_map

# How each engine runs an SRU/QRNN layer on the card, and under a "model"
# mesh axis; its keys are the engines.
ENGINE_MATRIX = {
    "sequential": "plain PyTorch; gate GEMM, then a step-by-step recurrence; "
                  "under a model axis per rank over its H / model_shards lanes",
    "chunked": "plain PyTorch; gate GEMM, then the MTS schedule (associative "
               "inside blocks of mts_block_size); per rank over its lanes under "
               "a model axis",
    "associative": "plain PyTorch; gate GEMM, then a log-depth prefix scan; "
                   "per rank over its lanes under a model axis",
    "pallas": "gate GEMM, then the linear-scan CUDA kernel (B3); not served "
              "under a model axis (the train step runs it per rank)",
    "fused": "the whole-layer CUDA kernel (B1), one launch per layer; per rank "
             "over its H / model_shards lanes (requires rnn_hidden % "
             "model_shards == 0)",
    "fused_stack": "the depth-fused stack (B2; d_model == hidden); under a model "
                   "axis per layer on B1 + gather, or the ring with --ring-overlap",
}
ENGINES = tuple(ENGINE_MATRIX)


def _matrix_lines() -> str:
    rows = "\n".join(f"  {e:<12} {d}" for e, d in ENGINE_MATRIX.items())
    return f"supported engines:\n{rows}"


def validate_engine_mesh(cfg, model_shards: int, ring_overlap: bool, *, batch: int = None,
                         data_shards: int = None) -> None:
    """Fail fast, with JAX's messages, on an unserveable --engine /
    --model-shards / --batch: an unknown engine (naming the engines), an
    engine that cannot use the model axis, an indivisible hidden width, a
    ring without a sharded stack, a batch the data axis does not divide,
    and int8 gate slabs where no kernel dequantizes them (LSTM, and every
    engine but ``fused``/``fused_stack``)."""
    if batch is not None and data_shards is not None and data_shards > 1:
        if batch % data_shards:
            raise SystemExit(
                f"serve: --batch {batch} does not divide over the data axis "
                f"of the mesh {{'data': {data_shards}, 'model': "
                f"{model_shards}}}: batch lanes are the data-axis slots, so "
                f"an indivisible batch either replicates every lane on every "
                f"data device or dies as a GSPMD shape error deep in the "
                f"prefill step. Pick a multiple of {data_shards} (or change "
                f"--model-shards so the leftover device count divides it)."
            )
    engine = cfg.scan_engine
    if engine not in ENGINES:
        raise SystemExit(
            f"serve: unknown engine {engine!r} (from --engine or the "
            f"{cfg.name!r} config)\n{_matrix_lines()}"
        )
    is_rnn = cfg.cell in ("sru", "qrnn")
    if model_shards > 1 and is_rnn:
        if engine == "pallas":
            raise SystemExit(
                f"serve: engine 'pallas' cannot use --model-shards "
                f"{model_shards}: the elementwise-scan kernel runs replicated "
                f"under a model axis. Use an XLA engine (GSPMD TP) or "
                f"fused/fused_stack (shard_map).\n{_matrix_lines()}"
            )
        if engine in ("fused", "fused_stack") and cfg.rnn_hidden % model_shards:
            raise SystemExit(
                f"serve: rnn_hidden={cfg.rnn_hidden} is not divisible by "
                f"--model-shards {model_shards}: the fused shard_map path "
                f"would silently fall back to the replicated kernel. Pick a "
                f"divisor of {cfg.rnn_hidden} (or an XLA engine).\n"
                f"{_matrix_lines()}"
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
    # Only the explicit flag is validated: a config's ring_overlap (the
    # *-stacked-ring archs) changes nothing on one device.
    if ring_overlap and (engine != "fused_stack" or model_shards <= 1):
        raise SystemExit(
            "serve: --ring-overlap applies only to engine 'fused_stack' with "
            "--model-shards > 1 (it schedules the sharded stack's inter-layer "
            f"gathers; there is nothing to overlap otherwise).\n{_matrix_lines()}"
        )


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _greedy(cfg, logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits[:, -1, : cfg.vocab], dim=-1)[:, None]


def prompt_inputs(cfg, batch: int, prompt_len: int, seed: int, device) -> dict:
    """The batch path's prompt from a generator seeded with ``seed``: token
    ids (B, prompt_len), or with a frontend stub a normal draw of
    ``inputs_embeds`` (B, prompt_len, d_model), as the JAX ``run_batch``
    draws them."""
    gen = torch.Generator().manual_seed(seed)
    if cfg.frontend:
        return {"inputs_embeds": torch.randn((batch, prompt_len, cfg.d_model),
                                             generator=gen).to(device)}
    return {"inputs": torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen).to(device)}


def step_input(cfg, params, tok: torch.Tensor, mesh=None) -> torch.Tensor:
    """A decode step's input after the greedy ``tok`` (B, 1): the token, or
    with a frontend stub its embedding row (B, 1, d), under ``mesh`` looked
    up in this rank's block of the vocab. The JAX ``run_batch`` computes
    ``one_hot(tok) @ embed``; a product with one 1 and zeros is the row
    itself, so the two are equal bit for bit."""
    if not cfg.frontend:
        return tok
    return tensor_parallel.embed(params["embed"], tok, tensor_parallel.vocab_group(cfg, mesh))


def capture_batch_steps(cfg, prefill_step, decode_step, params, inputs):
    """The batch path's two steps as CUDA graphs, as the JAX
    ``launch/serve.py`` jits them. Each step is warmed up eagerly first (the decode step over clones
    of the warm-up prefill's caches), then the prefill is captured at the
    run's (batch, prompt length, max_len), then the decode step over the
    caches the captured prefill outputs, which it updates in place, in the
    prefill graph's memory pool. The decode step is captured on the step's
    input (``step_input``: a token, or with a frontend an embedding row),
    which each replay copies into the graph's static buffer. Returns the two
    ``CapturedStep``s."""
    logits, caches = step_graphs.warm_up(prefill_step, params, inputs)
    token = step_input(cfg, params, _greedy(cfg, logits))
    step_graphs.warm_up(decode_step, params, caches, token)
    del logits, caches
    prefill = step_graphs.capture(prefill_step, params, inputs)
    decode = step_graphs.capture(decode_step, params, prefill.outputs[1], token,
                                 pool=prefill.pool)
    return prefill, decode


def run_batch(cfg, params, args, device: torch.device, graphs: bool = True,
              mesh=None) -> dict:
    """The lockstep path: one prefill, ``gen_len - 1`` decode steps. On a
    CUDA device with ``graphs`` both steps run as CUDA graph replays,
    captured before the timed region (``capture_batch_steps``); otherwise,
    and always on the CPU or under a ``mesh``, the eager steps run. Under a
    mesh ``params`` are this rank's shards, each rank takes its rows of the
    prompt, and the tokens are gathered over the data axis. The greedy argmax
    runs outside the steps, as outside the jit in JAX. Returns the timings,
    whether the caches kept their storage, and the generated tokens."""
    max_len = args.prompt_len + args.gen_len
    prefill = build_prefill_step(cfg, mesh, batch=args.batch, max_len=max_len, device=device)
    decode = build_decode_step(cfg, mesh, max_len=max_len)
    inputs = prompt_inputs(cfg, args.batch, args.prompt_len, args.seed, device)
    if mesh is not None:
        inputs = tree_map(lambda x, spec: sharding.local_shard(x, spec, mesh), inputs,
                          sharding.batch_specs(inputs, mesh))

    captured = graphs and device.type == "cuda" and mesh is None
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
        logits, caches = decode(params, caches, step_input(cfg, params, tok, mesh))
        tok = _greedy(cfg, logits)
        out_tokens.append(tok)
    _sync(device)
    t_decode = time.perf_counter() - t0
    tokens = torch.cat(out_tokens, dim=1)
    if mesh is not None and fused_sharded._batch_spec(mesh, args.batch) is not None:
        tokens = mesh.axis("data").all_gather(tokens.T).T  # the data ranks' rows, in order
    tokens = tokens.cpu()
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


def draft_model(cfg, args, device: torch.device):
    """The speculative draft of ``--draft-config`` (reduced with
    ``--reduced``) and its params from ``--seed`` + 1, as the JAX
    ``run_continuous`` makes them; ``(None, None)`` without
    ``--speculative``. A draft with another vocab, or the prefix cache
    beside it, exits."""
    if not args.speculative:
        return None, None
    draft_cfg = get_config(args.draft_config)
    if args.reduced:
        draft_cfg = draft_cfg.reduced()
    if draft_cfg.vocab != cfg.vocab:
        raise SystemExit(
            f"serve: --draft-config {draft_cfg.name!r} has vocab "
            f"{draft_cfg.vocab} but the target's is {cfg.vocab}; "
            "speculative acceptance compares token ids, so draft and "
            "target must share the vocab"
        )
    if args.prefix_cache_mb > 0:
        raise SystemExit(
            "serve: --speculative and --prefix-cache-mb are mutually "
            "exclusive (a hit-injected target state has no draft-side "
            "counterpart)"
        )
    params = lm.lm_init(torch.Generator(device=device).manual_seed(args.seed + 1), draft_cfg,
                        device=device, dtype=_dtype(draft_cfg.compute_dtype))
    return draft_cfg, params


def run_continuous(cfg, params, args, device: torch.device, graphs: bool = True,
                   draft_cfg=None, draft_params=None, trace=None, mesh=None) -> dict:
    """The continuous-batching path (JAX ``run_continuous``): the flags'
    open-loop trace (or ``trace``, a list of ``Request``s, where given)
    served by a ``Scheduler`` over ``--batch`` slots, with the draft
    ``draft_cfg``/``draft_params`` if given (speculative decode in blocks of
    ``--spec-k``), its steps captured as CUDA graphs on the card before the
    run (``graphs``; never under ``mesh``, where ``params`` and the draft's
    are this rank's shards). Returns the engine's metrics report with
    the capture time, whether the steps ran as graphs and the caches (the
    draft's too) kept their storage, this rank's shape of the pool's
    carry, the admissions, the prefix cache's report, the draft and k, each
    request's tokens, and what the telemetry sinks recorded.

    The telemetry flags work as in the JAX ``run_continuous``: any of them
    adds a ``StepMonitor``; ``--torch-profile`` wraps the engine's
    construction, warm-up (the captures) and run in ``torch_profile`` and
    turns on the step annotations while the capture runs; the trace, the
    metrics rows and the Prometheus snapshot are written after the run,
    each announced by a line."""
    telemetry_on = bool(args.trace_out or args.metrics_jsonl or args.torch_profile
                        or args.prom_out)
    with torch_profile(args.torch_profile, device) as profiling:
        tel = Telemetry.from_flags(
            trace_out=args.trace_out, metrics_jsonl=args.metrics_jsonl,
            metrics_every=args.metrics_every,
            monitor=StepMonitor() if telemetry_on else None, profiling=profiling)
        engine = Scheduler(
            cfg, params, batch=args.batch, chunk=args.chunk, queue_capacity=args.queue_cap,
            prefix_cache_mb=args.prefix_cache_mb, async_depth=args.async_depth,
            draft_cfg=draft_cfg, draft_params=draft_params, spec_k=args.spec_k,
            telemetry=tel, device=device, graphs=graphs, mesh=mesh)
        if trace is None:
            trace = continuous_trace(cfg, args, engine.chunk)
        engine.warmup()
        _sync(device)
        engine.run(trace)
        _sync(device)
    rep = engine.metrics.report()
    trace_events = None
    if args.trace_out:
        doc = tel.trace.export(args.trace_out)
        trace_events = len(doc["traceEvents"])
        dropped = doc["otherData"]["dropped_events"]
        print(f"trace: {trace_events} events -> {args.trace_out}"
              + (f" ({dropped} dropped by the ring bound)" if dropped else ""))
    if args.metrics_jsonl:
        print(f"metrics: {tel.metrics_writer.rows} rows -> {args.metrics_jsonl}")
    if args.prom_out:
        write_prometheus(args.prom_out, rep)
        print(f"prometheus snapshot -> {args.prom_out}")
    if tel.monitor is not None and tel.monitor.events:
        print(f"stragglers: {len(tel.monitor.events)} flagged ticks")
    tel.close()
    rep.update(
        arch=cfg.name, device=str(device), graphs=engine.captured,
        capture_ms=engine.capture_ms, cache_in_place=engine.cache_in_place,
        pool_carry_shape=list(engine.pool.caches["layers"]["c"].shape),
        admissions=engine.admission_log, chunk=engine.chunk, async_depth=args.async_depth, requests=len(trace),
        prefix_cache=engine.prefix_cache.report() if engine.prefix_cache else None,
        speculative={"draft": draft_cfg.name, "k": engine.spec_k} if draft_cfg else None,
        stragglers=len(tel.monitor.events) if tel.monitor is not None else None,
        trace_events=trace_events,
        metrics_rows=tel.metrics_writer.rows if tel.metrics_writer is not None else None,
        torch_profile=profiling if args.torch_profile else None,
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
    spec = rep["speculative"]
    if spec is not None:
        print(
            f"  speculative: draft {spec['draft']} k={spec['k']}  "
            f"acceptance: {rep['spec_acceptance_rate']*100:.0f}% "
            f"({rep['spec_accepted']}/{rep['spec_proposed']} draft tokens)  "
            f"tokens/verify: {rep['accepted_tokens_per_cycle']:.2f}  "
            f"verify steps: {rep['verify_steps']}  draft steps: "
            f"{rep['draft_steps']}  rollbacks: {rep['spec_rollbacks']}"
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


def parse_args(argv=None) -> argparse.Namespace:
    """The command line's flags, checked as the JAX ``main`` checks them
    (``ap.error`` exits)."""
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
    ap.add_argument(
        "--speculative", action="store_true",
        help="continuous mode: speculative multi-token decode (draft RNN "
             "proposes, target verifies per fused (B, k) chunk; greedy output "
             "identical to plain decode)",
    )
    ap.add_argument(
        "--draft-config", default="sru-paper-draft",
        help="speculative mode: registered draft arch (must share the target "
             "vocab)",
    )
    ap.add_argument(
        "--spec-k", type=int, default=4,
        help="speculative mode: tokens per drafted block",
    )
    ap.add_argument(
        "--trace-out", default=None,
        help="continuous mode: write a Chrome trace-event JSON of per-tick "
             "phase spans + request lifecycles here (load in "
             "https://ui.perfetto.dev)",
    )
    ap.add_argument(
        "--metrics-jsonl", default=None,
        help="continuous mode: append rolling live-metrics rows (streaming "
             "TTFT/TPOT quantiles, goodput, occupancy) here, one JSON object "
             "per sample",
    )
    ap.add_argument(
        "--metrics-every", type=int, default=32,
        help="continuous mode: sample a --metrics-jsonl row every N ticks",
    )
    ap.add_argument(
        "--prom-out", default=None,
        help="continuous mode: write the end-of-run metrics report as a "
             "Prometheus text-exposition snapshot (textfile-collector format)",
    )
    ap.add_argument(
        "--torch-profile", default=None, metavar="DIR",
        help="continuous mode: capture a torch.profiler trace (host, and the "
             "card's kernels on a CUDA device) into DIR with tick-phase "
             "record_function/NVTX ranges on every step dispatch",
    )
    ap.add_argument(
        "--model-shards", type=int, default=1,
        help="size of the \"model\" mesh axis (default 1 = one device); the "
             "ranks beyond one model group form the \"data\" axis for batch DP",
    )
    ap.add_argument(
        "--ring-overlap", action="store_true",
        help="sharded fused_stack only: ring schedule that overlaps each "
             "inter-layer gather with the next layer's gate GEMM",
    )
    ap.add_argument(
        "--dist-backend", choices=("nccl", "gloo"), default=None,
        help="torch.distributed backend of the mesh's ranks: nccl (default on "
             "the card, one rank per card) or gloo (--device cpu, or ranks "
             "sharing a card, only when asked for)",
    )
    args = ap.parse_args(argv)
    if args.gen_len < 1 or args.prompt_len < 1 or args.batch < 1:
        ap.error("--batch, --prompt-len and --gen-len must be >= 1")
    if args.mode != "continuous" and args.headline_trace:
        ap.error("--headline-trace requires --mode continuous")
    if args.speculative and args.mode != "continuous":
        ap.error("--speculative requires --mode continuous")
    if args.spec_k < 1:
        ap.error("--spec-k must be >= 1")
    if args.mode != "continuous" and (
        args.trace_out or args.metrics_jsonl or args.prom_out or args.torch_profile
    ):
        ap.error(
            "--trace-out/--metrics-jsonl/--prom-out/--torch-profile require "
            "--mode continuous (the batch path has no tick phases to trace)"
        )
    if args.metrics_every < 1:
        ap.error("--metrics-every must be >= 1")
    if args.model_shards < 1:
        ap.error("--model-shards must be >= 1")
    return args


def config_of(args):
    """The config the flags select: ``--engine``, ``--ring-overlap`` and
    ``--weight-quant`` over the registry's, then ``--reduced``."""
    cfg = get_config(args.arch)
    if args.engine:
        cfg = cfg.with_(scan_engine=args.engine)
    if args.ring_overlap:
        cfg = cfg.with_(ring_overlap=True)
    if args.weight_quant is not None:
        # Quantize on load: lm_init quantizes the fresh gate slabs.
        cfg = cfg.with_(weight_quant=args.weight_quant)
    return cfg.reduced() if args.reduced else cfg


# ---------------------------------------------------------------------------
# Serving on a mesh of ranks
# ---------------------------------------------------------------------------

_SLAB = re.compile(r"(^|.*/)cell/(w|w0|w1|wq|w0q|w1q|wx|uh)$")
_VOCAB = re.compile(r"(^|.*/)embed/(embed|unembed)$")
_BLOCK = re.compile(r"(^|.*/)(attn|mlp|mamba)/[^/]+$")
_EXPERT = re.compile(r"(^|.*/)moe/(e_gate|e_up|e_down)$")
_SHARED_CARD = ("serve: --model-shards {k} needs {k} cards under NCCL, one rank a card, "
                "and {n} are here: ranks that share a card run over gloo, and only when "
                "asked for with --dist-backend gloo")


def _bytes(params, pattern) -> int:
    return sum(t.numel() * t.element_size() for path, t in flatten_with_paths(params)
               if pattern.match(path))


def slab_bytes(params) -> int:
    """Bytes of the RNN gate slabs (fp or int8; the LSTM's ``wx`` and
    ``uh``) in ``params``."""
    return _bytes(params, _SLAB)


def vocab_bytes(params) -> int:
    """Bytes of the vocab leaves (``embed``, ``unembed``) in ``params``."""
    return _bytes(params, _VOCAB)


def block_bytes(params) -> int:
    """Bytes of the attention, dense MLP and Mamba mixer leaves in
    ``params`` (a hybrid's shared block's included)."""
    return _bytes(params, _BLOCK)


def expert_bytes(params) -> int:
    """Bytes of the MoE expert leaves (``e_gate``, ``e_up``, ``e_down``) in
    ``params``."""
    return _bytes(params, _EXPERT)


def _backend(args, device: torch.device) -> str:
    backend = args.dist_backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl" and device.type == "cpu":
        raise SystemExit("serve: --dist-backend nccl runs on the card; --device cpu serves "
                         "over gloo")
    return backend


def _spawned_world(args, backend: str) -> int:
    """How many ranks serve starts: under NCCL one per card (the model axis
    must divide them, as JAX's device count), else ``--model-shards``."""
    k = args.model_shards
    if backend != "nccl":
        return k
    n = torch.cuda.device_count()
    if k > n:
        raise SystemExit(_SHARED_CARD.format(k=k, n=n))
    if n % k:
        raise SystemExit(f"serve: --model-shards {k} must divide the device count ({n})")
    return n


def _rank_device(args, backend: str) -> torch.device:
    """This rank's device: the CPU, or under NCCL its own card (refused when
    the host's ranks outnumber its cards), under gloo cards in turn."""
    if args.device == "cpu":
        return torch.device("cpu")
    resolve_device("cuda")
    n = torch.cuda.device_count()
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    if backend == "nccl" and int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size())) > n:
        raise SystemExit(_SHARED_CARD.format(k=args.model_shards, n=n))
    device = torch.device("cuda", local % n)
    torch.cuda.set_device(device)
    return device


def _rank_main(rank: int, world: int, backend: str, init_method: str, argv, cpu: bool) -> None:
    """A rank that ``main`` started: joins the process group, serves
    (``main`` sees the group and runs ``serve_mesh``), leaves it."""
    if cpu:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    elif backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=GROUP_TIMEOUT)
    try:
        rc = main(argv)
    finally:
        dist.destroy_process_group()
    if rc:
        raise SystemExit(rc)


def _spawn(argv, cfg, args) -> int:
    """Start the mesh's ranks (``torch.multiprocessing``, a ``file://``
    rendezvous in a temporary directory, so concurrent runs never share a
    port) and wait for them."""
    device = resolve_device(args.device)
    backend = _backend(args, device)
    world = _spawned_world(args, backend)
    validate_engine_mesh(cfg, args.model_shards, args.ring_overlap, batch=args.batch,
                         data_shards=world // args.model_shards)
    rdv = tempfile.mkdtemp(prefix="serve-rdv-")
    try:
        torch.multiprocessing.spawn(
            _rank_main, nprocs=world,
            args=(world, backend, f"file://{rdv}/store", argv, device.type == "cpu"))
    finally:
        shutil.rmtree(rdv, ignore_errors=True)
    return 0


def shard_params(cfg, params, mesh):
    """This rank's shards of the whole ``params`` (``rank_specs``) and the
    dims above 1024 they leave replicated (``describe_replications``)."""
    rank = fused_sharded.rank_specs(cfg, fused_sharded.serving_param_specs(params, mesh), mesh)
    return (tree_map(lambda x, spec: sharding.local_shard(x, spec, mesh), params, rank),
            sharding.describe_replications(params, rank))


def serve_mesh(cfg, args, *, trace=None, draft=None) -> dict:
    """One rank of a serve on the initialised process group: the (data,
    model) mesh (``--model-shards`` ranks a model group), the params made
    whole from ``--seed`` and sliced to this rank's shards at rest, then
    ``run_batch`` on them (eager), the tokens gathered, or with ``--mode
    continuous`` ``run_continuous`` on the mesh (the draft of
    ``--speculative`` sliced the same way, the trace made from ``--seed``
    alike on every rank; the telemetry sinks are rank 0's alone). ``trace``
    (``Request``s) replaces the flags' trace and ``draft`` (a config and its
    whole params on this rank's device) the ``--speculative`` draft, as
    ``run_continuous`` takes them. Rank 0 prints the mesh, the backend, the
    replicated dims, each model rank's bytes of gate slabs, of vocab leaves,
    of attention, MLP and Mamba leaves and of MoE experts and the ``serve-stats``
    (``continuous-stats``) line. Returns the stats on every rank."""
    world, k, backend = dist.get_world_size(), args.model_shards, dist.get_backend()
    if world % k:
        raise SystemExit(f"serve: --model-shards {k} must divide the {world} ranks")
    validate_engine_mesh(cfg, k, args.ring_overlap, batch=args.batch, data_shards=world // k)
    device = _rank_device(args, backend)
    mesh = make_local_mesh(k, device=device)
    _sync(device)
    t0 = time.perf_counter()
    params = lm.lm_init(torch.Generator(device=device).manual_seed(args.seed), cfg,
                        device=device, dtype=_dtype(cfg.compute_dtype))
    whole, vocab_whole = slab_bytes(params), vocab_bytes(params)
    block_whole, expert_whole = block_bytes(params), expert_bytes(params)
    params, replicated = shard_params(cfg, params, mesh)
    _sync(device)
    init_ms = (time.perf_counter() - t0) * 1e3
    mine = torch.tensor([[slab_bytes(params)], [vocab_bytes(params)], [block_bytes(params)],
                         [expert_bytes(params)]], dtype=torch.int64, device=device)
    per_rank, vocab_per_rank, block_per_rank, expert_per_rank = (
        mesh.axis("model").all_gather(mine).tolist())
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    rank0 = dist.get_rank() == 0
    if args.mode == "continuous":
        draft_cfg, draft_params = draft or draft_model(cfg, args, device)
        if draft_params is not None:
            draft_params, _ = shard_params(draft_cfg, draft_params, mesh)
        sinks = args if rank0 else argparse.Namespace(**dict(
            vars(args), trace_out=None, metrics_jsonl=None, prom_out=None, torch_profile=None))
        stats = run_continuous(cfg, params, sinks, device, draft_cfg=draft_cfg,
                               draft_params=draft_params, trace=trace, mesh=mesh)
    else:
        stats = run_batch(cfg, params, args, device, graphs=False, mesh=mesh)
    stats.update(init_ms=init_ms, mesh=mesh.shape, backend=backend, slab_bytes=per_rank,
                 slab_bytes_whole=whole, vocab_bytes=vocab_per_rank,
                 vocab_bytes_whole=vocab_whole, block_bytes=block_per_rank,
                 block_bytes_whole=block_whole, expert_bytes=expert_per_rank,
                 expert_bytes_whole=expert_whole, replicated=replicated,
                 peak_mem_gb=(torch.cuda.max_memory_allocated(device) / 1e9
                              if device.type == "cuda" else None))
    if rank0:
        print(f"mesh: {mesh.shape}  engine: {cfg.scan_engine}")
        print(mesh.describe())
        print("replicated on every model rank: " + ("; ".join(replicated) or "nothing"))
        print(f"gate slab bytes per model rank: {per_rank} of {whole}")
        print(f"vocab leaf bytes per model rank: {vocab_per_rank} of {vocab_whole}")
        print(f"attention/MLP/Mamba leaf bytes per model rank: {block_per_rank} of {block_whole}")
        print(f"expert leaf bytes per model rank: {expert_per_rank} of {expert_whole}")
        _print_stats(stats, args)
    return stats


def _print_stats(stats: dict, args) -> None:
    """The run's human-readable lines and its ``serve-stats`` (batch) or
    ``continuous-stats`` line."""
    if args.mode == "continuous":
        _print_continuous(stats, args)
        print("continuous-stats " + json.dumps(stats), flush=True)
        return
    print(f"prefill: {args.batch}x{args.prompt_len} in {stats['prefill_ms']:.1f}ms "
          f"({stats['prefill_tok_s']:.0f} tok/s)")
    print(f"decode:  {stats['decode_steps']} steps in {stats['decode_ms']:.1f}ms "
          f"({stats['decode_tok_s']:.0f} tok/s)")
    print("sample tokens:", stats["tokens"][0][:16])
    print("serve-stats " + json.dumps(stats), flush=True)


def main(argv=None, graphs: bool = True) -> int:
    """The command line; ``graphs=False`` serves with the eager steps on the
    card too (``run_batch``, ``run_continuous``). With ``--model-shards``
    above 1, inside an initialised process group, or under ``torchrun``
    (whose ``env://`` rendezvous it joins), it serves on a mesh of ranks
    (``serve_mesh``), starting them itself where no group exists."""
    args = parse_args(argv)
    cfg = config_of(args)
    if dist.is_initialized():
        serve_mesh(cfg, args)
        return 0
    if torchrun_world() > 1:
        device = resolve_device(args.device)
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0"))
                                  % torch.cuda.device_count())
        dist.init_process_group(_backend(args, device), timeout=GROUP_TIMEOUT)  # env://
        try:
            serve_mesh(cfg, args)
        finally:
            dist.destroy_process_group()
        return 0
    if args.model_shards > 1:
        return _spawn(sys.argv[1:] if argv is None else list(argv), cfg, args)
    validate_engine_mesh(cfg, 1, args.ring_overlap, batch=args.batch, data_shards=1)
    device = resolve_device(args.device)
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
        draft_cfg, draft_params = draft_model(cfg, args, device)
        stats = run_continuous(cfg, params, args, device, graphs=graphs,
                               draft_cfg=draft_cfg, draft_params=draft_params)
    else:
        stats = run_batch(cfg, params, args, device, graphs=graphs)
    stats["init_ms"] = init_ms
    stats["peak_mem_gb"] = (torch.cuda.max_memory_allocated(device) / 1e9
                            if device.type == "cuda" else None)
    _print_stats(stats, args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
