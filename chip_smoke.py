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
           stream's F = 1024 at T = 64 and a 1024-step prompt at F = 4096;
           the verify shape of speculative decode, T = 4 and 8, in bf16 and
           fp32, for the SRU and QRNN layer, both stacks, the int8 QRNN stack
           and the linear scan)
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
           shapes of granite-20b (a group of 48), zamba2-7b (head dim 112),
           nemotron-4-340b (head dim 192), internvl2-2b (16 query heads on 8)
           and musicgen-large (G = 1, head dim 64), mixtral-8x22b's full
           4096-slot sliding-window ring and qwen3-moe-235b-a22b's group of
           16 in bf16, and one fp32 case
           with 32 query heads per KV head, beside PyTorch's
           ``scaled_dot_product_attention`` on the same data, with each
           instance's shared memory, registers, CTAs per SM, tiles in
           flight and split plan; B5's log-sum-exp form (the rank's slots
           of a sequence-sharded cache) at granite-20b's head shape on a
           full shard, an empty one (lengths 0: out 0, lse -inf) and ragged
           lanes, bf16 and fp32; the chunked
           SSD (B4) at the mamba2-2.7b serve shapes (B = 4, 80 heads, P = 64,
           N = 128, bf16: prompts 1024 and 64 from a zero state, one decode
           step written in place over a random state, a ragged S = 100), at
           two grouped fp32 shapes of ``tests/test_kernels.py`` (G = 2, 4)
           and at the zamba2-7b serve shapes (112 heads, N = 64: prompt 64,
           one decode step in place), with the mma chunk kernel's resources
           and plan at both state sizes; max |error|
           against a stated tolerance, and kernel / plain times from CUDA
           events (decode cases and every SSD and linear-scan case also
           cold: the L2 flushed before each call); and the fused layer's
           and stack's autograd Functions (SRU and QRNN, both stacks, fp
           and int8 slabs, T = 64, B = 4, width 1024, bf16 and fp32): the
           gradient of every floating operand against autograd through the
           plain version, the launches of a forward and backward, and
           their times;
  contracts ``repro_torch/analysis``'s contract ledger on the card:
           ``check_contracts`` of ``CONTRACTS_TORCH.json`` (the 17 paper-RNN
           configs' six serving steps derived on meta) gives no violation;
           every kernel instance the ledger lists (B1, B2 and their int8
           forms, B3 on the ring configs' model shards), and B4's and B5's
           at CONTRACT_SSD and CONTRACT_GQA, has the registers, dynamic
           shared memory and CTAs per SM of its H100 model, as the
           wrapper's ``instance_info`` reads them, and fits 232,448 B a
           CTA; one speculative ``Scheduler`` of CONTRACT_SCHEDULER at the
           ledger's batch 8 and chunk 32 captures exactly the ledger's six
           signatures (its draft pool's five alike, and the draft block)
           and nothing after warm-up over CONTRACT_REQUESTS requests;
  serve    ``repro_torch.launch.serve.main`` in batch mode at full width
           (``--batch 4 --prompt-len 64 --gen-len 32``) for the stacked and
           fused configs, the base SRU/QRNN configs under ``--engine pallas``,
           ``sru-paper-large`` on its own chunked engine,
           ``lstm-paper-large``, the four ``*-int8`` configs, ``llama3-8b``
           (prompt 64 and 1024), ``smollm-360m``, ``mamba2-2.7b`` (prompt
           64 and 1024), ``granite-20b`` (MQA), the frontend stubs
           ``internvl2-2b`` and ``musicgen-large`` (an embedding prompt; each
           step fed its token's embedding row) and the hybrid ``zamba2-7b``
           (81 Mamba-2 blocks, the shared attention block applied 13 times),
           and, through ``serve.run_batch`` (serve.main has no depth flag), the
           configs one card holds only cut in depth (CUT_SERVE_RUNS: the MoE
           ``mixtral-8x22b`` and ``qwen3-moe-235b-a22b`` at 8 layers,
           ``nemotron-4-340b`` at 4), each twice: with the eager steps and with the
           steps as CUDA graphs (the default: prefill and every decode step
           a replay, ``capture_ms`` for the warm-ups and captures); each
           run's launches of each kernel instance, fp and int8 apart (counts
           set to 0 just before the run, read just after), its init time and
           peak memory; both modes must give the expected launches, keep the
           caches where they lie and give the same tokens;
  continuous  ``serve --mode continuous`` (the ``Scheduler``, B = 4 slots)
           at full width for ``sru-paper-large-stacked`` (B2),
           ``qrnn-paper-large-fused`` (B1), ``sru-paper-large --engine
           pallas`` (B3) and ``qrnn-paper-large-stacked-int8`` (B2 int8),
           five runs each: the JAX benchmarks' headline trace (128 requests,
           150 req/s, prompt 32) eager and captured at async depth 1 and
           captured at depth 2, and a shared-prefix trace with the prefix
           cache off and on; every stream's tokens must agree between eager
           and captured, depth 1 and 2, cache off and on (with a hit); each
           run's launches must equal its prefill chunks plus decode steps
           times a step's launches (counts set to 0 just before the run and
           read just after); the pool's caches must keep their storage;
           goodput, TTFT, TPOT, ms per tick, occupancy, fetch wait, capture
           time and peak memory per run; then two captured runs of 32
           requests per config, one with the tick trace on (host time per
           tick by phase) and one under torch.profiler (device time per
           tick, hence the idle share);
  speculative  ``serve --mode continuous --speculative`` (draft steps and the
           k-step draft block as graphs of a draft pool, the target's verify
           chunk at T = k) for the continuous phase's four configs: in fp32
           compute, 32 headline-trace requests, captured at depth 2, plain,
           the floor draft (``sru-paper-draft``, seed 1) at k = 4 and the
           oracle draft (the target itself) at k = 4 and 8, every stream's
           tokens equal to plain's, the oracle never rolling back and the
           floor at least once; in bf16 the headline trace at depth 2,
           plain captured, the floor at k = 4 eager and captured (same
           tokens required) and the oracle at k = 4 captured, each run's
           launches equal to its target and draft steps times a step's
           launches, both pools kept in place, the streams that differ from
           plain reported; then a tick-traced and a profiled oracle run per
           config (host ms per tick by phase, device idle);
  telemetry  ``serve --mode continuous`` with the telemetry flags for the
           continuous phase's four configs, captured, async depth 2: the
           headline trace with telemetry off and on in turns (off, on, on,
           off; on = ``--trace-out --metrics-jsonl --metrics-every 16
           --prom-out``), then ``--torch-profile DIR`` on 32 headline
           requests (the captures inside the session) and an oracle
           speculative run (k = 4) with the trace on; every run captured,
           complete, pools in place, launches = steps x a step's launches;
           the on runs' tokens equal the off runs' for every stream;
           ``tools/trace_check.py`` (a subprocess, its default epsilons)
           accepts each trace and the metrics rows; the Prometheus snapshot
           parses; the profile names the ``decode`` and ``prefill``
           annotations. Printed: ms per tick off and on (the overhead),
           stragglers, host ms per tick by phase (trace spans), and from the
           profile (``profile_split``) device ms per tick by phase, each
           device event attributed through its correlation id to the launch
           under a phase annotation (a graph replay's kernels to its
           ``cudaGraphLaunch``), the share no phase claimed, lost device
           events, and host ms per tick by phase and by call; the artifacts
           stay under ``build/telemetry/`` (the profiles open in Perfetto or
           TensorBoard);
  profile  per config (the fp fused, stacked and pallas runs, the two
           stacked int8 runs, llama3-8b, smollm-360m, mamba2-2.7b,
           granite-20b, zamba2-7b and the three cut configs), eager
           and captured, a decode step's host time and torch.profiler's
           device time by kernel, hence the device's idle share, against the
           step's bytes bound (mamba2: its SSM state read and written too;
           zamba2: also its shared block read at each application; MoE: every
           expert read, since the sorted schedule computes every expert's
           slots, and a second bound over the experts one step's routing
           touched);
           the card's count of our kernels per step, over profiled steps
           that kept all their device events, must equal the expected
           launches per step in both modes; the caches must keep their
           storage (written in place);
  parity   the stacked SRU and QRNN LMs, the base SRU and QRNN LMs under
           pallas, the LSTM LM, two int8 LMs (stacked SRU, fused QRNN),
           smollm-360m (cut to 8 of its 32 layers), llama3-8b, mamba2-2.7b,
           granite-20b, internvl2-2b and musicgen-large (each cut to 2
           layers so the CPU side fits in time and host memory), zamba2-7b
           (cut to 7: a
           group of 6 with its shared block, and a tail layer), and
           mixtral-8x22b, qwen3-moe-235b-a22b and nemotron-4-340b cut to 1
           (their prefill logits held at 3e-5) at full width
           in fp32 compute, same params, on the card versus the plain path on
           the CPU: teacher-forced prefill logits, 8 decode steps and their
           argmax; the attention and Mamba caches keep their storage;
  train    training at full width, 8 x 256 tokens a step, 4 steps, for
           ``sru``/``qrnn-paper-large-stacked`` (B2),
           ``qrnn-paper-large-fused`` (B1), ``smollm-360m`` and
           ``internvl2-2b`` (a frontend stub) through
           ``repro_torch.launch.train.main``, ``sru-paper-large`` on
           ``pallas`` (B3 forward and backward), ``mamba2-2.7b`` cut to 2
           layers, ``zamba2-7b`` cut to 7 and ``mixtral-8x22b`` and
           ``qwen3-moe-235b-a22b`` (bf16 moments) cut to 1 through the same
           loop over ``build_train_step``
           (``launch/train.py`` has no engine or depth flag, as in JAX):
           per config the fp32 step 0 on the card against the CPU's (same
           params and batch: loss and grad norm; cut to TRAIN_PARITY_DEPTH
           layers and the batch's first TRAIN_PARITY_ROWS rows), then the
           run in the config's dtypes with every kernel's count set to 0
           just before and read just after (launches equal to the
           expected), finite losses, ms per step,
           tokens/s, peak memory and the B1/B2 backward's recompute time;
           then a run saved half way and resumed against the uninterrupted
           one (max |param difference|);
  checkpoint  legacy gate-major checkpoints and the migration tool at full
           width: for ``sru``/``qrnn-paper-large-stacked`` (B2, B3),
           ``launch.train.main`` for 4 steps saved half way, that step
           rewritten as a gate-major binary wrote it (the port's
           ``tree_to_gate_major``, no ``cell_layout``), restored with the
           migration (the same bits), migrated by the tool in a copy (the
           lane-major step's files again) and resumed with ``--resume
           auto``: the final leaves must equal the uninterrupted run's
           exactly, with the expected launches; for
           ``qrnn-paper-large-stacked-int8`` (B2 int8) and
           ``sru-paper-large-int8`` (B1 int8), fp params from ``lm_init``
           saved gate-major, a ``--dry-run`` (no byte changed), ``python -m
           repro_torch.launch.migrate_checkpoint DIR --quantize int8`` as a
           subprocess on the card, a second run (skips), the restore
           (bitwise ``lm_init``'s int8 params) and ``serve.run_batch`` on
           the restored params eager and captured (``lm_init``'s tokens,
           the int8 launches). Printed: each checkpoint's bytes, the seconds
           of save, restore, migration, quantization and the resumed run,
           the leaves converted and the launches;
  sharded  multi-GPU serving of the fused RNN path, its ranks sharing the
           one card over gloo (so its times are not multi-GPU speed; a line
           says NCCL across cards was not run): B1 at a model shard's
           shapes (width 1024 over 2, 4 and 8 ranks, bf16 and fp32, T = 64
           and 1; int8 at H = 1000 over 8, a shard starting inside a scale
           block; fp32 IO on bf16 slabs at width 1024 over 2) against its
           plain version, warm and cold, with bound and instance; the
           single-device run (fp32 compute, eager, B = 4, prompt 64, gen 32)
           and teacher-forced logits of ``sru-paper-large-stacked``
           (barrier), ``-stacked-ring``, ``qrnn-paper-large-fused``,
           ``sru-paper-large-int8`` and ``qrnn-paper-large-stacked-int8``
           (ring), and of ``sru-paper-large-stacked`` under bf16 compute;
           two gloo ranks, (data 1, model 2), serving each through
           ``serve.serve_mesh`` (counts set to 0 just before each run, read
           just after): under fp32 the tokens must equal the single-device
           run's and the logits be within SHARDED_TOL, under bf16 the logits
           within SHARDED_BF16_TOL; every rank's launches the expected (L x
           32 per rank: B1 on the barrier and the layer, B3 on the ring,
           whose gate GEMM is the ring's chunk GEMMs), each rank's
           gate-slab bytes half of the whole; a decode step of the fp32 SRU
           barrier and ring split into each collective and the rest per
           rank (``timed_collectives``); then one full-width
           layer of ``mixtral-8x22b`` and ``qwen3-moe-235b-a22b`` under
           ``_moe_shard_map`` (E/2 experts a rank) against ``sorted`` on one
           rank at 2e-5; four ranks, (2, 2), serving
           ``sru-paper-large-stacked`` (the data axis) with the
           single-device tokens. Every run's vocab leaves are a block of
           the padded vocab a model rank (half the bytes each). Part (g),
           on the same (1, 2) ranks: ``sru-paper-large``,
           ``qrnn-paper-large`` and ``lstm-paper-large`` on their own
           ``chunked`` engine (tensor parallelism of the gate GEMM, the
           LSTM's columns and the vocab leaves; no kernel of ours), B = 4,
           prompt 64, gen 8, against the single-device tokens and logits,
           half the slab and vocab bytes a rank, a decode step split into
           collectives and the rest. Part (h), on the same ranks:
           ``llama3-8b``, ``granite-20b`` and ``mamba2-2.7b`` cut to 2
           layers and ``zamba2-7b`` to 7 at full width, B = 4, prompt 64,
           gen 8 (tensor parallelism of the attention, dense MLP and Mamba
           leaves: B4 on each rank's Mamba heads, B5 on its KV heads or, for
           granite's one KV head, its log-sum-exp form on the rank's half
           of the cache's slots), against the single-device tokens and
           logits, each rank's attention/MLP/Mamba leaf bytes about half of
           the whole, each rank's launches, a decode step split into
           collectives and the rest. Then training on two ranks: B1, B2 and
           B3 (forward and backward) at the train runs' shapes against
           their plain versions; ``build_train_step(cfg, mesh)`` for 2
           steps of 8 x 256 tokens in fp32 of ``sru-paper-large-stacked``
           on (1, 2), ``qrnn-paper-large-stacked`` on (2, 1) with FSDP and
           ``sru-paper-large --engine pallas`` on (1, 2) (B3 per rank on
           its lanes, forward and one-launch backward)
           (counts set to 0 just before, read just after), loss, grad norm
           and params against the single-device fp32 run on the card,
           each rank's launches the expected and one more step split into
           collectives and the rest; ``launch.train`` under
           ``torch.distributed.run`` on two gloo ranks to step 2, resumed
           with ``--resume auto`` on one rank to step 4, its params within
           5e-4 of the uninterrupted single-rank run's;
  dryrun   ``launch/dryrun.py``'s rank on the card (DRYRUN_CELLS:
           ``llama3-8b`` ``decode_32k`` and ``mamba2-2.7b`` ``long_500k`` at
           full depth, ``llama3-8b`` ``prefill_32k`` cut to 2 layers, rank
           (0, 0) of the (16, 16) pod): the meta run of the
           rank's step, then the same step on the card at the same local
           shapes under the same virtual rank (its collectives return the
           rank's operand tiled or copied: one rank, no communication), on
           random shards, eager, after a warm-up step: the inputs' shapes,
           the collectives (op, count, bytes) and each kernel's launches
           (B5's lse form on llama3's sequence-sharded cache, B4 on mamba2's
           5 heads) equal to the meta run's, finite logits, the peak memory
           beyond the inputs within DRYRUN_TEMP_RTOL plus
           DRYRUN_TEMP_ALLOWANCE of the meta run's temp bytes, and ms a step
           (host clock, synchronised).

Then one ``{"phase_seconds": {...}}`` line (each phase's wall time, the
serve phase's warm-ups included), one ``{"kernels": [...]}`` line (launches
from the serve, continuous, speculative, telemetry, train, checkpoint,
sharded and dryrun phases, eager and captured runs and the sharded phase's
ranks summed), the
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
import math
import os
import pathlib
import re
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PHASES = ("build", "kernels", "contracts", "serve", "continuous", "speculative", "telemetry",
          "profile", "parity", "train", "checkpoint", "sharded", "dryrun")
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
    ("granite-20b", None, 64), ("internvl2-2b", None, 64), ("musicgen-large", None, 64),
    ("zamba2-7b", None, 64),
)
# The configs one card serves only cut in depth, (arch, layers kept): the
# MoE LMs (8 layers of 5.0 GB in bf16) and nemotron-4-340b (4 layers of 6.9
# GB beside its 18.9 GB embedding and head). serve.main has no depth flag
# (nor has JAX's), so the serve and profile phases drive them through
# serve.run_batch, the function serve.main runs, on the cut config.
CUT_SERVE_RUNS = (("mixtral-8x22b", 8), ("qwen3-moe-235b-a22b", 8), ("nemotron-4-340b", 4))
# (arch, --engine override): the continuous phase's configs, one per kernel
# on the path (B2, B1, B3, B2 int8).
CONTINUOUS_CONFIGS = (("sru-paper-large-stacked", None), ("qrnn-paper-large-fused", None),
                      ("sru-paper-large", "pallas"), ("qrnn-paper-large-stacked-int8", None))
# (run, graphs, serve flags): the JAX benchmarks' headline trace eager and
# captured at async depth 1 and captured at depth 2; a shared-prefix trace
# (32 requests, 150 req/s, prompts of 64 of which 3 in 4 open with one
# 32-token prefix) with the prefix cache off and on.
_HEADLINE = ["--headline-trace"]
_SHARED = ["--requests", "32", "--arrival-rate", "150", "--prompt-len", "64",
           "--gen-len", "32", "--prefix-share", "0.75", "--async-depth", "2"]
CONTINUOUS_RUNS = (
    ("headline eager d1", False, _HEADLINE + ["--async-depth", "1"]),
    ("headline captured d1", True, _HEADLINE + ["--async-depth", "1"]),
    ("headline captured d2", True, _HEADLINE + ["--async-depth", "2"]),
    ("shared prefix, cache off", True, _SHARED),
    ("shared prefix, cache on", True, _SHARED + ["--prefix-cache-mb", "64"]),
)
# Requests of the profiled continuous run (a shorter headline-like trace).
CONTINUOUS_PROFILE_REQUESTS = 32
# Speculative decode: block widths of the verify-shape kernel cases, and the
# phase's runs. fp32 compute (the tokens must equal the plain run's): a
# 32-request headline-shaped trace, captured, async depth 2, plain, the floor
# draft (``sru-paper-draft``, seed 1) at k = 4, and the oracle draft (the
# target itself) at k = 4 and 8. bf16 (the served dtype; ties break
# otherwise in the chunk form and the step form, so the tokens against plain
# are reported, not required): the headline trace at depth 2, plain
# captured, the floor at k = 4 eager and captured, the oracle at k = 4
# captured. (run, draft, k, graphs).
VERIFY_KS = (4, 8)
SPEC_FP32_REQUESTS = 32
SPEC_FP32_RUNS = (("plain", None, 0, True), ("floor k=4", "floor", 4, True),
                  ("oracle k=4", "oracle", 4, True), ("oracle k=8", "oracle", 8, True))
SPEC_BF16_RUNS = (("plain captured d2", None, 0, True), ("floor k=4 eager d2", "floor", 4, False),
                  ("floor k=4 captured d2", "floor", 4, True),
                  ("oracle k=4 captured d2", "oracle", 4, True))
# Telemetry (phase ``telemetry``): per config of CONTINUOUS_CONFIGS, the
# headline trace captured at async depth 2 with telemetry off and on in
# turns (the overhead is the on runs' ms per tick against the off runs' in
# one call), "on" being every file sink: the tick trace, a metrics row every
# TELEMETRY_METRICS_EVERY ticks and the Prometheus snapshot. Then a
# ``--torch-profile`` run on CONTINUOUS_PROFILE_REQUESTS headline requests
# and an oracle speculative run (k = 4) with the trace on. Artifacts go to
# TELEMETRY_DIR.
TELEMETRY_RUNS = ("off", "on", "on again", "off again")
TELEMETRY_METRICS_EVERY = 16
TELEMETRY_DIR = ROOT / "build" / "telemetry"
# The tick phases the Scheduler annotates (``serving/engine.py``), and the
# host calls whose every call makes device work (a call with none in the
# profile lost its device events).
TICK_PHASES = ("reset", "inject", "prefill", "snapshot", "decode", "draft", "verify")
LAUNCH_CALLS = ("cudaGraphLaunch", "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync")
TELEMETRY_TOP_CALLS = 10
# A Prometheus text-exposition sample: ``name value`` or
# ``name{quantile="q"} value``.
PROM_SAMPLE = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{quantile="[0-9.]+"\})? (\S+)$')
# (arch, --engine override): the fused int8 runs are not profiled (their
# kernels take the bf16 twins' time), nor the long prompts.
PROFILE_RUNS = tuple(r[:2] for r in SERVE_RUNS[:6] + SERVE_RUNS[8:10] + SERVE_RUNS[12:13]
                     + SERVE_RUNS[14:16] + SERVE_RUNS[17:18] + SERVE_RUNS[20:21])
# (arch, --engine override, config overrides).
PARITY_RUNS = (
    ("sru-paper-large-stacked", None, {}), ("qrnn-paper-large-stacked", None, {}),
    ("sru-paper-large", "pallas", {}), ("qrnn-paper-large", "pallas", {}),
    ("lstm-paper-large", None, {}),
    ("sru-paper-large-stacked-int8", None, {}), ("qrnn-paper-large-int8", None, {}),
    ("smollm-360m", None, {"n_layers": 8}), ("llama3-8b", None, {"n_layers": 2}),
    ("mamba2-2.7b", None, {"n_layers": 2}),
    ("granite-20b", None, {"n_layers": 2}), ("internvl2-2b", None, {"n_layers": 2}),
    ("musicgen-large", None, {"n_layers": 2}),
    ("zamba2-7b", None, {"n_layers": 7}),  # one group of 6 and its shared block, a tail layer
    ("mixtral-8x22b", None, {"n_layers": 1}), ("qwen3-moe-235b-a22b", None, {"n_layers": 1}),
    ("nemotron-4-340b", None, {"n_layers": 1}),  # 51.5 GB of fp32 on the card and the host
)
# These runs also hold the prefill logits (the last position's, B x V) at
# this tolerance, the JAX package's own for logits.
PARITY_PREFILL_TOL = {"mixtral-8x22b": 3e-5, "qwen3-moe-235b-a22b": 3e-5,
                      "nemotron-4-340b": 3e-5}
# Training (phase ``train``): (arch, engine override, config overrides) at
# full width, TRAIN_BATCH x TRAIN_SEQ tokens a step, TRAIN_STEPS steps. The
# runs without overrides go through ``repro_torch.launch.train.main``; its
# flags (the JAX package's) have no --engine and no depth, so the others run
# ``build_train_step`` on the config in the same loop.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 256, 4
TRAIN_RUNS = (
    ("sru-paper-large-stacked", None, {}), ("qrnn-paper-large-stacked", None, {}),  # B2
    ("qrnn-paper-large-fused", None, {}),                                          # B1
    ("sru-paper-large", "pallas", {}),                                             # B3
    ("smollm-360m", None, {}), ("mamba2-2.7b", None, {"n_layers": 2}),
    ("internvl2-2b", None, {}),                                # frontend stub
    ("zamba2-7b", None, {"n_layers": 7}),                      # hybrid: a group and a tail
    # MoE at full width, one layer: 2.9 B / 3.7 B params, fp32 masters, fp32
    # / bf16 moments (about 46 / 45 GB of params, grads and moments).
    # nemotron-4-340b cannot train on one card at any depth: its embedding
    # and head alone are 9.4 B params, about 113 GB of train state.
    ("mixtral-8x22b", None, {"n_layers": 1}), ("qwen3-moe-235b-a22b", None, {"n_layers": 1}),
)
# The fp32 step-0 check of these runs is cut to this depth (the timed run
# keeps its own), so the host's CPU side fits in the script's time:
# internvl2-2b's 24 layers at full width take minutes of fp32 forward and
# backward there (2 keep the adapter, a layer pair and the 92672-column
# head), smollm-360m's 32 about half a minute.
TRAIN_PARITY_DEPTH = {"internvl2-2b": 2, "smollm-360m": 8}
# The fp32 step-0 check of these runs takes only the first rows of the batch
# on both sides (and as many microbatches at most), for the script's time:
# at all 8 rows each MoE check took about two minutes of the host's fp32
# forward and backward at full width, at 2 rows 39-46 s on a slow host
# (zamba2-7b's 7 layers at 8 rows 59 s, internvl2-2b's 20 s), which put the
# script at 1165 s of phases there.
TRAIN_PARITY_ROWS = {"mixtral-8x22b": 1, "qwen3-moe-235b-a22b": 1, "zamba2-7b": 2,
                     "internvl2-2b": 2}
# A run saved at step TRAIN_STEPS // 2 and resumed ends with the
# uninterrupted run's params: equal but for the last-ulp effect of atomics
# in the embedding gradient on fp32 masters of magnitude < 1 (~6e-8); a lost
# moment or step would move them by about one AdamW update (the learning
# rate, >= 1.5e-5 here).
TRAIN_RESUME_ARCH = "sru-paper-large-stacked"
TRAIN_RESUME_TOL = 1e-6
TRAIN_DIR = ROOT / "build" / "train"
# Checkpoints (phase ``checkpoint``), at full width: (a) for the B2 configs,
# ``launch.train.main`` saved half way, that step rewritten as a gate-major
# binary wrote it, and resumed from it; the resumed run must end with the
# uninterrupted run's leaves exactly, since the migration is a reshape. (b)
# fp params of the int8 configs (B2 int8, B1 int8) saved gate-major, both
# quantized by one run of the migration tool as a subprocess on the card,
# restored and served eager and captured.
CKPT_RESUME_ARCHS = ("sru-paper-large-stacked", "qrnn-paper-large-stacked")
CKPT_QUANT_ARCHS = ("qrnn-paper-large-stacked-int8", "sru-paper-large-int8")
CKPT_GEN_LEN = 32
CKPT_DIR = ROOT / "build" / "checkpoint"
# The sharded phase: serving on a (1, 2) mesh of gloo ranks sharing the one
# card, fp32 compute, against the single-device serve; (2, 2) for the data
# axis; MoE's expert-parallel schedule (``shard_map``) at full width, one
# layer, held to ``sorted`` on one rank (SHARDED_MOE); the MoE LMs' other
# layouts under the model axis in part (i).
SHARDED_RUNS = ("sru-paper-large-stacked", "sru-paper-large-stacked-ring",
                "qrnn-paper-large-fused", "sru-paper-large-int8", "qrnn-paper-large-stacked-int8")
SHARDED_DATA_RUN = "sru-paper-large-stacked"
# Served once more under bf16 compute (the config's own) on (1, 2): the
# barrier runs B1 in fp32 IO on the bf16 slabs, against the single-device
# bf16 run (B2, whose tensor-core GEMM rounds its input to bf16).
SHARDED_BF16_RUN = "sru-paper-large-stacked"
# A decode step of the two fp32 SRU stacks (barrier, ring) split into the
# collectives and the rest (launch/mesh.py::timed_collectives), per rank.
SHARDED_SPLIT_RUNS = ("sru-paper-large-stacked", "sru-paper-large-stacked-ring")
SHARDED_SPLIT_STEPS = 8
# Sharded logits (4 teacher-forced steps) against the single-device run's:
# fp32 at 5e-5 (readings at most 5.4e-6 on the H100, and 3e-5 the CPU
# tests' limit against JAX); bf16 at twice its reading there, 0.03125, one
# bf16 ulp of a logit in [4, 8): the single-device B2 rounds its GEMM input
# to bf16, the sharded barrier keeps it fp32 as JAX's does.
SHARDED_TOL = 5e-5
SHARDED_BF16_TOL = 0.0625
SHARDED_MOE = ("mixtral-8x22b", "qwen3-moe-235b-a22b")
SHARDED_LOGIT_STEPS = 4
# B1 at a model shard's shapes, (mode, H, k, shard, int8): SRU at width
# 1024 over k = 2, 4, 8 (Hl 512, 256, 128), the sharded serving runs' QRNN
# and int8 SRU layers (Hl 512), and the ragged int8 H = 1000 over 8 (Hl 125,
# shard 3: its lanes start 119 lanes into a scale block and cross into the
# next); each at T = 64 and 1, bf16 and fp32.
SHARD_CASES = (("sru_identity", 1024, 2, 1, False), ("sru_identity", 1024, 4, 1, False),
               ("sru_identity", 1024, 8, 1, False), ("qrnn", 1024, 2, 1, False),
               ("sru_identity", 1024, 2, 1, True), ("sru_identity", 1000, 8, 3, True))
# fp32 IO on bf16 slabs, the barrier's call under bf16 compute: (mode, H, k,
# shard), T = 64 and 1.
SHARD_MIXED_CASES = (("sru_identity", 1024, 2, 1), ("qrnn", 1024, 2, 1))
SHARDED_DIR = ROOT / "build" / "sharded"
# Sharded training (the sharded phase's last part): (arch, engine, model
# axis, fsdp, config overrides) trained SHARDED_TRAIN_STEPS steps by two gloo
# ranks sharing the card, fp32 compute, TF32 off, TRAIN_BATCH x TRAIN_SEQ
# tokens a step, against the single-device fp32 run on the card: the SRU
# stack on (1, 2) (the barrier: B1 a layer and rank forward, B3 in the
# backward's recompute), the QRNN stack on (2, 1) with FSDP (B2 on each data
# rank's rows, B3; the depth-fused stack gathers its whole stack at its
# call), the SRU layer under pallas on (1, 2) (part (g): the gate GEMM on the
# rank's lanes, B3 forward and its one-launch backward per rank, the vocab
# leaves vocab-parallel), and smollm-360m at full width cut to 8 of its 32
# layers on (2, 1) with FSDP, gathered a layer at a time inside each block's
# remat region (no kernel of ours: attention trains through plain PyTorch).
# Each run reports each rank's peak memory over its steps (the whole state
# drawn, sharded and freed before) and the largest all_gather over "data", of
# all leaves and of the layer leaves.
SHARDED_TRAIN_RUNS = (("sru-paper-large-stacked", None, 2, False, {}),
                      ("qrnn-paper-large-stacked", None, 1, True, {}),
                      ("sru-paper-large", "pallas", 2, False, {}),
                      ("smollm-360m", None, 1, True, {"n_layers": 8}))
SHARDED_TRAIN_STEPS = 2
# The CPU tests' limits against JAX's sharded step (tests/test_torch_sharded_
# train.py): loss 3e-5; grad norm, as a grad, and params after the steps 5e-4.
SHARDED_TRAIN_LOSS_TOL, SHARDED_TRAIN_GRAD_TOL, SHARDED_TRAIN_PARAM_TOL = 3e-5, 5e-4, 5e-4
# The CLI: ``torch.distributed.run`` of two gloo ranks of ``launch.train``
# (the config's own dtypes) saving at SHARDED_CLI_SAVE steps, ``--resume
# auto`` on one rank to SHARDED_CLI_STEPS, against the uninterrupted
# single-rank run. Every step is in the warm-up (--warmup 20), so the
# learning rate does not depend on --steps.
SHARDED_CLI_ARCH = "sru-paper-large-stacked"
SHARDED_CLI_SAVE, SHARDED_CLI_STEPS = 2, 4
# (f) Continuous serving on gloo ranks sharing the card, fp32 compute, through
# serve.serve_mesh's continuous branch: run -> (arch, trace, oracle draft),
# each on (1, 2), and SHARDED_CONT_DATA_RUNS on (2, 2) too (the shared
# prefix there broadcasts each lane snapshot over "data" from the rank that
# holds the lane and injects on that rank alone). B = 4 slots, chunk
# 32, SHARDED_CONT_REQUESTS requests all arriving at t = 0 (admission then
# follows ticks, not clocks), prompts of 32 ("prefix": a 64-token prefix
# every request shares plus 16, the prefix cache on at async depth 2), 32
# tokens each; the oracle draft is the target itself, k = 4. The barrier
# stack runs B1 a layer and rank at T = 32 (prefill), 1 (decode) and 4
# (verify); the int8 QRNN's config carries the ring (chunk GEMMs, B3).
# (g) Tensor parallelism of what JAX shards through GSPMD, on the (1, 2)
# ranks of (c): each of SHARDED_TP_RUNS on its own engine (chunked; the
# LSTM's own step) at full width, B = 4, prompt 64, SHARDED_TP_GEN tokens,
# fp32: the gate GEMM on the rank's lanes (the LSTM's 4H / k columns and one
# gather of z_t a step) and the vocab leaves a block of the padded vocab a
# rank. Against the single-device run: tokens equal, SHARDED_LOGIT_STEPS
# teacher-forced logits at SHARDED_TOL, half the slab and vocab bytes a rank;
# a decode step split into the collectives and the rest. The path launches
# none of our kernels; the pallas train run of SHARDED_TRAIN_RUNS runs B3.
SHARDED_TP_RUNS = ("sru-paper-large", "qrnn-paper-large", "lstm-paper-large")
SHARDED_TP_GEN = 8
# (h) Tensor parallelism of the attention, dense MLP and Mamba leaves, on the
# (1, 2) ranks of (c): each of SHARDED_LM_RUNS, (arch, layers kept), at full
# width cut in depth (zamba2-7b to 7: a group of 6 Mamba blocks, its shared
# attention block once, a tail block), B = 4, prompt 64, SHARDED_TP_GEN
# tokens, fp32: the rank's q heads, K/V from the gathered w_kv columns, the
# w_o and w_down rows summed over the axis, the MLP's and the Mamba mixer's
# "ff" columns, B4 on the rank's H/2 Mamba heads, and at decode B5 on the
# rank's KV heads (llama3-8b, zamba2-7b) or its log-sum-exp form on the
# rank's slots of the sequence-sharded cache (granite-20b's one KV head).
# Against the single-device run: tokens equal, SHARDED_LOGIT_STEPS
# teacher-forced logits at SHARDED_TOL, each rank's attention/MLP/Mamba leaf
# bytes at most SHARDED_LM_BYTES of the whole (the Mamba mixer's in_b, in_c,
# in_dt, B/C convs, A_log, D, dt_bias and the norms stay whole), each rank's
# launches the expected; a decode step split into the collectives and the rest.
SHARDED_LM_RUNS = (("llama3-8b", 2), ("granite-20b", 2), ("mamba2-2.7b", 2), ("zamba2-7b", 7))
SHARDED_LM_BYTES = 0.55
# (i) The MoE experts under the model axis, on the (1, 2) ranks of (c): each
# of SHARDED_MOE_LM_RUNS, (name, arch, config overrides), at full width cut to
# 1 layer, B = 4, prompt 64, SHARDED_TP_GEN tokens, fp32, under the config's
# own ``sorted`` schedule: mixtral-8x22b (its 8 experts over "model", 4 a
# rank, run on their rows of the whole dispatch buffer and gathered over the
# expert dim; B5 on the rank's 4 of 8 KV heads in the 4096-slot SWA ring),
# and a stand-in for mixtral's production layout (8 experts on a 16-wide
# axis: JAX's ``ff_moe`` fallback), whose 16 ranks could not share one card
# (each would draw the whole 11.7 GB layer before slicing): the same config
# with 3 experts, which do not divide 2, so each rank holds f / 2 = 8192
# columns of every expert and the partial outputs are summed over the axis.
# Against the single-device run: tokens equal, SHARDED_LOGIT_STEPS
# teacher-forced logits at SHARDED_TOL, each rank's expert leaf bytes
# SHARDED_MOE_SHARE of the whole within SHARDED_MOE_SHARE_TOL, each rank's
# launches the expected (B5 a decode step); a decode step split into the
# collectives and the rest.
SHARDED_MOE_LM_RUNS = (("mixtral-8x22b", "mixtral-8x22b", {}),
                       ("mixtral-8x22b ff_moe stand-in (n_experts=3)", "mixtral-8x22b",
                        {"n_experts": 3}))
SHARDED_MOE_SHARE, SHARDED_MOE_SHARE_TOL = 0.5, 0.01
SHARDED_CONT_RUNS = {"plain": ("sru-paper-large-stacked", "plain", False),
                     "prefix": ("sru-paper-large-stacked", "prefix", False),
                     "oracle": ("sru-paper-large-stacked", "plain", True),
                     "qrnn-int8": ("qrnn-paper-large-stacked-int8", "plain", False)}
SHARDED_CONT_DATA_RUNS = ("plain", "prefix")
SHARDED_CONT_REQUESTS, SHARDED_CONT_GEN = 16, 32
# Served once more inside timed_collectives: ms a tick in the collectives.
SHARDED_CONT_SPLIT = ("plain",)
# The dryrun phase's cells, (arch, shape, mesh): one rank of each, rank
# (0, 0) of the (16, 16) pod, run on meta by ``launch/dryrun.py`` and then
# on the card at the same local shapes under the same virtual rank (no
# collective runs: each returns the rank's operand tiled or copied), on
# random shards from DRYRUN_SEED, eager; (arch, shape, mesh, layers kept,
# None for all). llama3-8b decode_32k: 8 lanes, its FSDP-sharded weights
# gathered a layer at a time, its 8 KV heads' cache sequence-sharded (2048
# of the 32768 slots, every one valid: the cache position is the last), so
# B5's lse form runs; mamba2-2.7b long_500k: one lane, whole, B4 on 5 of the
# 80 heads; llama3-8b prefill_32k cut to 2 layers: 2 lanes of 32768 tokens,
# the rank's shards of the caches made in the step (no global cache).
DRYRUN_CELLS = (("llama3-8b", "decode_32k", "pod", None), ("mamba2-2.7b", "long_500k", "pod", None),
                ("llama3-8b", "prefill_32k", "pod", 2))
DRYRUN_SEED = 35
DRYRUN_STEPS = 5  # timed steps a cell, after the warm-up and the measured one
# The card's peak over the measured step, less what was allocated before
# it, against the meta run's temp_bytes with each storage rounded to the
# caching allocator's 512-byte blocks (both after a warm-up step, so the
# cuBLAS workspaces and B5's launch words are allocated before): within
# DRYRUN_TEMP_RTOL of the prediction plus DRYRUN_TEMP_ALLOWANCE, named for
# cuBLAS/cuBLASLt workspace a GEMM may still take in the step and for the
# meta branch's per-call launch words (4 KB a B5 call) the card keeps.
DRYRUN_TEMP_RTOL = 0.05
DRYRUN_TEMP_ALLOWANCE = 8 << 20
# The contracts phase: the live Scheduler that must capture exactly the
# ledger's trace set (CONTRACTS_TORCH.json), at the ledger's batch and
# chunk, speculative (so verify is captured too) with a random draft, and
# its requests; and the instances no ledger config runs: B4's at the
# served head shapes, ssd (x, B/C dtype, N) of mamba2-2.7b and zamba2-7b,
# each as a chunk and as a one-step kernel (P = 64, the 16-byte state form;
# CONTRACT_SSD_STEP4 P = 6, the 4-byte one), B5's gqa_decode (dtype, Dh, G)
# of llama3-8b, granite-20b and nemotron-4-340b, and B1/B2's CUDA-core body
# (fp32 IO) at the kernels phase's fp32 cases, (T, B, d, H, slab dtype,
# gates, stack layer, taps).
CONTRACT_SCHEDULER = "sru-paper-large-stacked"
CONTRACT_REQUESTS, CONTRACT_PROMPT, CONTRACT_GEN = 12, 40, 6
CONTRACT_SSD = (("bfloat16", "bfloat16", 128), ("bfloat16", "bfloat16", 64),
                ("float32", "float32", 16))
CONTRACT_GQA = (("bfloat16", 128, 4), ("bfloat16", 128, 48), ("bfloat16", 192, 12),
                ("float32", 128, 32))
CONTRACT_SSD_STEP4 = ("float32", "float32", 16)
CONTRACT_SIMT = ((64, 4, 1024, 1024, "float32", 3, False, 1), (13, 3, 1000, 1000, "float32", 3, False, 2),
                 (64, 4, 1024, 1024, "float32", 3, True, 1), (13, 3, 996, 996, "int8", 3, False, 2),
                 (64, 4, 1024, 512, "bfloat16", 3, False, 1),
                 (64, 4, 512, 1024, "float32", 4, False, 1))
# Autograd Functions of B1/B2 (kernels phase): their gradients against
# autograd through the plain version on the card. The Functions' backward
# recomputes the plain version with its recurrence through the linear scan
# (B3's chunked fold order, the plain walk's one step at a time), so fp32
# rounding differs along T = 64 steps and the backward's products: ATOL,
# plus GRAD_RTOL of the largest gradient (and one bf16 ulp of it for a bf16
# operand), the JAX package's gradient tolerance.
GRAD_RTOL = 5e-4
# Each kernel instance family with its launch counter (module attribute).
KERNELS = ("fused_rnn_layer", "fused_rnn_stack", "linear_scan",
           "fused_rnn_layer_int8", "fused_rnn_stack_int8", "gqa_decode", "gqa_decode_lse", "ssd")
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
# heads per KV head; then the llama3-8b serve shape at prompt 64, the
# full-width head shapes of granite-20b, zamba2-7b, nemotron-4-340b,
# internvl2-2b and musicgen-large at a 1056-row cache, granite-20b's
# serve shape at prompt 64 (its decode step's B5 against SDPA), mixtral-8x22b's
# sliding-window ring full (4096 slots) and qwen3-moe-235b-a22b's G = 16.
# ``bench_b5.py`` times the same cases.
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
    ("internvl2 B=4 Hq=16 Hkv=8 Dh=128 S=1056 len=1025",
     (4, 16, 8, 128, 1056, (1025,) * 4), "bfloat16"),
    ("musicgen B=4 Hq=32 Hkv=32 Dh=64 S=1056 len=1025",
     (4, 32, 32, 64, 1056, (1025,) * 4), "bfloat16"),
    ("granite prompt 64 S=96 len=65", (4, 48, 1, 128, 96, (65,) * 4), "bfloat16"),
    ("mixtral B=4 Hq=48 Hkv=8 Dh=128 SWA ring S=4096 full",
     (4, 48, 8, 128, 4096, (4096,) * 4), "bfloat16"),
    ("qwen3 B=4 Hq=64 Hkv=4 Dh=128 S=1056 len=1025",
     (4, 64, 4, 128, 1056, (1025,) * 4), "bfloat16"),
)
# B5's log-sum-exp form (a rank's slots of a sequence-sharded KV cache, part
# (h)'s granite-20b: MQA, its one KV head over 2 ranks) at granite's head
# shape, (name, (B, Hq, Hkv, Dh, S, lengths), dtype): the rank's 36 slots of
# a 72-slot cache (prompt 64 + 8) full, empty (a rank whose slots hold no
# valid row yet), and ragged lanes with an empty one, in bf16 and fp32. The
# output is held as B5's; the lse within B5_ATOL where the length is above
# 0, exactly -inf where it is 0.
GQA_LSE_CASES = (
    ("granite lse B=4 Hq=48 Hkv=1 Dh=128 S=36 len=36", (4, 48, 1, 128, 36, (36,) * 4),
     "bfloat16"),
    ("granite lse S=36 len=0 (empty shard)", (4, 48, 1, 128, 36, (0,) * 4), "bfloat16"),
    ("granite lse S=36 len=(36,0,17,1) fp32", (4, 48, 1, 128, 36, (36, 0, 17, 1)), "float32"),
    ("granite lse S=36 len=0 (empty shard) fp32", (4, 48, 1, 128, 36, (0,) * 4), "float32"),
    ("granite lse S=528 len=(528,0,300,1)", (4, 48, 1, 128, 528, (528, 0, 300, 1)),
     "bfloat16"),
)
# Chunked SSD (B4) cases, (name, (B, S, H, P, N, G, dtype, seed), options of
# ``_ssd_case``): the mamba2-2.7b serve shapes (prefill 1024 first: the
# summary's main row), the grouped fp32 shapes of test_kernels.py, then the
# zamba2-7b serve shapes (112 heads, N = 64). ``bench_b4.py`` times the same
# cases.
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
    ("zamba2 prefill B=4 S=64 H=112 N=64 bf16", (4, 64, 112, 64, 64, 1, "bfloat16", 506), {}),
    ("zamba2 decode B=4 S=1 H=112 N=64 bf16 in place", (4, 1, 112, 64, 64, 1, "bfloat16", 507),
     {"s0": True, "in_place": True}),
)
# Linear-scan (B3) cases, (name, T, F, dtype, seed): the pallas configs'
# prefill (first: the summary's main row) and decode step at B = 4 x H =
# 1024, the single stream at prompt 64, a 1024-step prompt at B = 4, then
# fp32, a ragged edge, one column, a long sequence and the verify shapes
# (T = k). ``bench_b3.py`` times the same cases, and the backward at
# SCAN_BWD_CASES.
SCAN_CASES = (
    ("T=64 F=4096", 64, 4096, "bfloat16", 6),
    ("T=1 F=4096", 1, 4096, "bfloat16", 12),
    ("T=64 F=1024 (single stream)", 64, 1024, "bfloat16", 13),
    ("T=1024 F=4096 (prompt 1024)", 1024, 4096, "bfloat16", 14),
    ("T=64 F=4096 fp32", 64, 4096, "float32", 201),
    ("ragged T=13 F=3000 fp32", 13, 3000, "float32", 202),
    ("T=64 F=1 fp32", 64, 1, "float32", 203),
    ("long T=4096 F=128 fp32", 4096, 128, "float32", 204),
    ("verify T=4 F=4096", 4, 4096, "bfloat16", 205),
    ("verify T=8 F=4096", 8, 4096, "bfloat16", 206),
    ("verify T=4 F=4096 fp32", 4, 4096, "float32", 207),
    ("verify T=8 F=4096 fp32", 8, 4096, "float32", 208),
)
SCAN_BWD_CASES = (("backward T=64 F=4096 fp32", 64, 4096, "float32", 301),
                  ("backward T=1024 F=4096 fp32", 1024, 4096, "float32", 303))
# Linear-scan gradients against autograd through the plain walk: past one
# chunk the kernel folds chunk aggregates, which round otherwise than the
# walk's steps, by a few fp32 ulps of the largest gradient.
B3_GRAD_RTOL = 2e-5
# torch.profiler has come back without any device event for one window of
# graph replays on the H100 (torch 2.11, CUDA 12.8), where another run's
# windows all had theirs. After many profiled sessions of graph replays in
# one process (the continuous, speculative and telemetry phases' profiled
# runs), a session also loses its first few device events (up to 8 of 168 on
# that card), and within a window it has lost some (11 of 512 of our kernels
# in eight mamba2 replays), while a window bounded on the card's clock let
# kernels of the steps before it in (llama3-8b eager: 32.125 a step). So
# each window's steps follow steps traced in the same session; the window's
# device events are those launched by the runtime calls inside its
# record_function range on the host, matched by correlation id
# (``profile_split``). Each step of a window has its own range, and a step
# that shows lost events (a launching call without device events, or a
# replay of the decode graph with fewer events than the window's fullest) is
# left out; windows are profiled until a window's worth of complete steps is
# in (``_profile_steps``): on the H100, zamba2-7b's captured decode has shown
# lost events in three windows running (the last at 93.875 of our 94 kernels
# a step), which failed the phase; a graph replays all of its kernels every
# time, so the shortfall was the profiler's.
PROFILE_WINDOWS = 3
PROFILE_WINDOW = "chip_smoke.window"
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


def _gqa_lse_call(q, k, v, lens):
    """B5's log-sum-exp form: ``(out, lse)``."""
    from repro_torch.kernels.gqa_decode.ops import gqa_decode

    return gqa_decode(q, k, v, lens, return_lse=True)


def _gqa_lse_plain(q, k, v, lens):
    from repro_torch.kernels.gqa_decode.ref import gqa_decode_ref

    return gqa_decode_ref(q, k, v, lens, return_lse=True)


def _gqa_lse_view(outs, args):
    """The lse form's outputs as compared (not timed): the lse is -inf
    exactly where the length is 0, and an empty lane's output 0; those lse
    entries are then set to 0."""
    import torch

    out, lse = outs
    lens = args[3]
    empty = (lens == 0)[:, None].expand_as(lse)
    require(bool(torch.equal(torch.isneginf(lse), empty)),
            "gqa_decode_lse: lse is -inf exactly where the length is 0")
    require(bool((out[lens == 0] == 0).all()), "gqa_decode_lse: an empty lane's out is 0")
    return out, torch.where(empty, torch.zeros_like(lse), lse)


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


def _varlen_lse(q, k, v, lens):
    """The library yardstick of B5's log-sum-exp form: one
    ``torch.nn.attention.varlen.varlen_attn`` call (flash attention) on the
    same data, never on the port's path: one query a lane, the lse asked
    for; returns ``(out, lse)`` with the lse as (B, Hq) (a transposed view
    where the call gives (Hq, B)). Where the call takes ``seqused_k`` the
    cache is flattened to (B S, Hkv, Dh) (a view) with the lengths as
    ``seqused_k``; else each lane's valid rows are packed outside the timed
    call and delimited by ``cu_seq_k``. ``enable_gqa`` is passed where the
    call has it (older ones take the KV heads as they are). The call
    refuses fp32 operands."""
    import inspect

    import torch
    from torch.nn.attention.varlen import AuxRequest, varlen_attn

    B, S, Hkv, Dh = k.shape
    takes = inspect.signature(varlen_attn).parameters
    kw = {"return_aux": AuxRequest(lse=True)}
    if "enable_gqa" in takes:
        kw["enable_gqa"] = True
    cu_q = torch.arange(B + 1, dtype=torch.int32, device=q.device)
    if "seqused_k" in takes:
        kf, vf = k.reshape(B * S, Hkv, Dh), v.reshape(B * S, Hkv, Dh)
        cu_k, max_k = cu_q * S, S
        kw["seqused_k"] = lens
    else:
        n = lens.tolist()
        kf = torch.cat([k[b, :n[b]] for b in range(B)])
        vf = torch.cat([v[b, :n[b]] for b in range(B)])
        cu_k = torch.zeros(B + 1, dtype=torch.int32, device=q.device)
        cu_k[1:] = torch.cumsum(lens, 0).to(torch.int32)
        max_k = max(n)

    def call():
        out, lse = varlen_attn(q, kf, vf, cu_q, cu_k, 1, max_k, **kw)
        return out, (lse if lse.shape == (B, q.shape[1]) else lse.t())

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


def _library_row(library, args, plain_outs) -> dict:
    """``library_ms`` and the library call's errors against the plain
    version's outputs (see :func:`_run_cases`)."""
    import torch

    try:
        call = library(*args)
        got = call()
        torch.cuda.synchronize()
    except (RuntimeError, ValueError, TypeError) as e:  # the call refuses this case
        return {"library_ms": None,
                "library_refused": f"{type(e).__name__}: {(str(e).strip().splitlines() or [''])[0]}"}
    got = got if isinstance(got, tuple) else (got,)
    err, mismatched = 0.0, 0
    for a, b in zip(got, plain_outs):
        a, b = a.float(), b.float()
        fin = torch.isfinite(b)
        if bool(fin.any()):
            err = max(err, (a[fin] - b[fin]).abs().max().item())
        mismatched += int((~fin & (a != b)).sum().item())
    return {"library_ms": time_ms(call, iters=50), "library_max_abs_err": err,
            "library_nonfinite_mismatched": mismatched}


def _run_cases(kname, wrapper, plain, cases, atol=ATOL, rtol=0.0, library=None, cold=False,
               phase="kernels", view=None):
    """Each case against its plain version (computed first: a wrapper may
    write a state operand in place); decode cases (T = 1), and every case
    with ``cold``, are also timed cold, with the L2 flushed before each call
    (``cold_ms``).
    ``library(*args)`` gives the one PyTorch call that computes the same
    function, timed as ``library_ms`` (with its max |error| against the
    plain version where that is finite, and the count of non-finite plain
    entries it does not match, not checked); a case the call refuses
    (raises) has ``library_ms`` None and the refusal's first line.
    ``view(outs, args)``, where given, checks and maps both sides' outputs
    before the comparison, outside the timed calls."""
    import torch

    l2 = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    rows = []
    for dtype, T, name, args, kw, rw, ops in cases:
        ref = plain(*args, **kw)
        out = wrapper(*args, **kw)
        torch.cuda.synchronize()
        out, ref = (x if isinstance(x, tuple) else (x,) for x in (out, ref))
        plain_outs = ref
        if view is not None:
            out, ref = view(out, args), view(ref, args)
        err, tol, finite = compare(out, ref, atol, rtol)
        each = errors(out, ref, atol, rtol)  # before the timed calls, which may write out
        ms = time_ms(lambda: wrapper(*args, **kw), iters=50)
        cold_ms = None
        if T == 1 or cold:
            cold_ms = time_ms(lambda: wrapper(*args, **kw), iters=50, flush=l2.zero_)
        plain_ms = time_ms(lambda: plain(*args, **kw), iters=3, warmup=1)
        b_ms, b_by = bound(rw, ops, dtype)
        row = {
            "phase": phase, "kernel": kname, "case": name, "dtype": dtype, "T": T,
            "max_abs_err": err, "tol": tol, "finite": finite,
            "max_abs_err_each": [e[0] for e in each], "tol_each": [e[1] for e in each],
            "ms": ms, "cold_ms": cold_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "bound_fp32_simt_ms": bound(rw, ops, "float32")[0],
        }
        if library is not None:
            row.update(_library_row(library, args, plain_outs))
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


def _grad_inputs(args, kw):
    """Copies of a kernel call's ``(args, kw)`` (taps in a tuple), each
    floating tensor a leaf that wants its gradient, and the list of those."""
    import torch

    def one(t):
        if not torch.is_tensor(t):
            return t
        return t.detach().clone().requires_grad_(t.is_floating_point())

    a = [tuple(one(t) for t in x) if isinstance(x, tuple) else one(x) for x in args]
    k = {key: one(v) for key, v in kw.items()}
    flat = [t for x in a for t in (x if isinstance(x, tuple) else (x,))] + list(k.values())
    return a, k, [t for t in flat if torch.is_tensor(t) and t.requires_grad]


def _fn_grad_row(kname, fn, plain, dtype, name, args, kw, rw, ops):
    """One autograd Function of B1/B2 (``ops.fused_layer`` /
    ``stacked.fused_stack``) against autograd through its plain version on
    the card, on the same inputs and output cotangents: the gradient of every
    floating operand (int8 slabs get none: straight-through). A call
    launches the fused kernel once per layer, and its backward the linear
    scan twice per layer (the recompute's recurrence). ``op_ms`` is
    forward + backward through the Function, ``plain_ms`` through the plain
    version; the bound counts the forward's bytes plus every gradient written
    once, and three times the forward's operations (the forward's product
    and the two of its backward)."""
    import torch

    from repro_torch.kernels.fused_rnn import fused_rnn, stacked
    from repro_torch.kernels.linear_scan import linear_scan

    g = torch.Generator(device="cuda").manual_seed(len(name))
    with torch.no_grad():
        shapes = [o for o in fn(*args, **kw) if o is not None]
    cots = [torch.randn(o.shape, generator=g, device="cuda").to(o.dtype) for o in shapes]

    def grads(f):
        a, k, wrt = _grad_inputs(args, kw)
        outs = [o for o in f(*a, **k) if o is not None]
        return torch.autograd.grad(outs, wrt, cots)

    counter = stacked if kname.startswith("fused_rnn_stack") else fused_rnn
    attr = "LAUNCHES_INT8" if kname.endswith("int8") else "LAUNCHES"
    before, scans_before = getattr(counter, attr), linear_scan.LAUNCHES
    got = grads(fn)
    launches = getattr(counter, attr) - before
    scans = linear_scan.LAUNCHES - scans_before
    want = grads(plain)
    torch.cuda.synchronize()
    err, tol, finite = compare(got, want, ATOL, GRAD_RTOL)
    b_ms, b_by = bound(rw + nbytes(*_grad_inputs(args, kw)[2]), 3.0 * ops, dtype)
    L = args[1][0].shape[0] if "mode" not in kw else 1
    row = {"phase": "kernels", "kernel": kname, "case": "autograd " + name, "dtype": dtype,
           "max_abs_err": err, "tol": tol, "finite": finite, "launches_per_call": launches,
           "linear_scan_launches_per_call": scans,
           "op_ms": time_ms(lambda: grads(fn), iters=5, warmup=1),
           "plain_ms": time_ms(lambda: grads(plain), iters=2, warmup=1),
           "bound_ms": b_ms, "bound_by": b_by}
    emit(row)
    require(finite and err <= tol, f"{kname} [autograd {name}]: err {err} > tol {tol}")
    require(launches == L and scans == 2 * L,
            f"{kname} [autograd {name}]: {launches} launches and {scans} of the linear scan, "
            f"expected {L} and {2 * L}")
    return row


def fused_fn_grad_rows():
    """The B1/B2 autograd Functions at the main path's shapes (T = 64, B =
    4, width 1024): the SRU and QRNN layer and both L = 4 stacks, fp and int8
    slabs, in bf16 and fp32."""
    from repro_torch.kernels.fused_rnn import fused_rnn, ops, stacked

    rows, seed = [], 600
    for dtype in ("bfloat16", "float32"):
        for quant in (False, True):
            q = "_int8" if quant else ""
            tag = "int8 " if quant else ""
            for mode in ("sru_identity", "qrnn"):
                seed += 1
                rows.append(_fn_grad_row(
                    "fused_rnn_layer" + q, ops.fused_layer, fused_rnn.fused_rnn_layer_plain, dtype,
                    *_layer_case(f"{tag}{mode} T=64 d=1024 {dtype}", mode, 64, 4, 1024, 1024,
                                 dtype, seed, quant=quant)))
            for cell in ("sru", "qrnn"):
                seed += 1
                rows.append(_fn_grad_row(
                    "fused_rnn_stack" + q, stacked.fused_stack, stacked.fused_rnn_stack_plain,
                    dtype, *_stack_case(f"{tag}{cell} L=4 T=64 {dtype}", cell, 64, 4, 1024, 4,
                                        dtype, seed, quant=quant)))
    return rows


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
    # The verify shape of speculative decode: the target's layers at T = k,
    # k = 4 and 8, B = 4, width 1024, in both IO dtypes.
    for T in VERIFY_KS:
        for dtype in ("bfloat16", "float32"):
            for mode in ("sru_identity", "qrnn"):
                seed += 1
                cases["fused_rnn_layer"].append((dtype, T) + _layer_case(
                    f"verify {mode} T={T} d=1024 {dtype}", mode, T, 4, 1024, 1024, dtype, seed))
            for cell in ("sru", "qrnn"):
                seed += 1
                cases["fused_rnn_stack"].append((dtype, T) + _stack_case(
                    f"verify {cell} L=4 T={T} {dtype}", cell, T, 4, 1024, 4, dtype, seed))
            seed += 1
            cases["fused_rnn_stack_int8"].append((dtype, T) + _stack_case(
                f"verify int8 qrnn L=4 T={T} {dtype}", "qrnn", T, 4, 1024, 4, dtype, seed,
                quant=True))
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
    lse_cases = []
    for i, (name, shape, dtype) in enumerate(GQA_LSE_CASES):
        case = _gqa_case(name, *shape, dtype, 450 + i)
        B_, Hq = shape[0], shape[1]
        lse_cases.append((dtype, 1) + case[:3] + (case[3] + B_ * Hq * 4, case[4]))

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
    for row in fused_fn_grad_rows():  # the autograd Functions' backward
        summaries[row["kernel"]].setdefault("autograd_cases_passed", 0)
        summaries[row["kernel"]]["autograd_cases_passed"] += 1
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
    # B5's log-sum-exp form: bytes one lse more (B x Hq fp32) than B5's; the
    # library yardstick is flash attention's varlen call with the lse.
    rows = _run_cases("gqa_decode_lse", _gqa_lse_call, _gqa_lse_plain, lse_cases,
                      atol=B5_ATOL, view=_gqa_lse_view, library=_varlen_lse)
    summaries["gqa_decode_lse"] = _summary(
        "gqa_decode_lse", "src/repro_torch/kernels/gqa_decode/csrc/gqa_decode.cu",
        "src/repro/kernels/gqa_decode/gqa_decode.py:66", rows)

    # Chunked SSD: SSD_CASES, each also timed cold.
    ssd_cases = []
    for name, shape, kw in SSD_CASES:
        case = _ssd_case(name, *shape, **kw)
        x = case[1][0]
        ssd_cases.append((str(x.dtype).split(".")[-1], x.shape[1]) + case)
    rows = _run_cases("ssd", _ssd_kernel_call, _ssd_plain_call, ssd_cases, atol=0.0,
                      rtol=B4_RTOL, cold=True)
    for arch, H, N in (("mamba2", 80, 128), ("zamba2", 112, 64)):
        heads_per_cta, grid = ssd_kernel.plan(4, H, 1, 64, N)
        emit({"phase": "kernels", "kernel": "ssd",
              "instance": f"mma chunk kernel, bf16, N = {N} ({arch}, H = {H})",
              **ssd_kernel.instance_info(torch.bfloat16, torch.bfloat16, N),
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
            "gqa_decode_lse": (gqa_decode, "LAUNCHES_LSE"),
            "ssd": (ssd, "LAUNCHES")}


def _counted_run(counters, call, what):
    """``call()`` (``serve.main`` or ``serve.run_continuous``, its output
    captured) with every kernel's count set to 0 just before it and read
    just after. Returns the run's ``continuous-stats`` dict (JSON round
    trip: the request ids as serve prints them) and the launches."""
    buf = io.StringIO()
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    with contextlib.redirect_stdout(buf):
        rc = call()
    launches = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
    if isinstance(rc, dict):
        stats = json.loads(json.dumps(rc))
    else:
        require(rc == 0, f"{what} returned {rc}")
        line = next(x for x in buf.getvalue().splitlines() if x.startswith("continuous-stats "))
        stats = json.loads(line[len("continuous-stats "):])
    return stats, launches


def _release():
    """Free a finished run's params, caches and graph pools before the next
    run allocates (granite-20b's 40.6 GB must not sit beside another
    model's)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


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
    Mamba-2, one SSD per layer per call (the prompt's, then each step's),
    and for a hybrid one decode attention per application of its shared
    block per decode step."""
    want = dict.fromkeys(KERNELS, 0)
    if cfg.ssm:
        want["ssd"] = cfg.n_layers * (1 + decode_steps)
        if cfg.attn_every:
            want["gqa_decode"] = cfg.n_layers // cfg.attn_every * decode_steps
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
        _release()
    totals = dict.fromkeys(KERNELS, 0)
    for arch, engine, prompt_len in SERVE_RUNS:
        extra = ["--engine", engine] if engine else []
        cfg = _run_cfg(arch, engine)
        want = _expected_launches(cfg, gen_len - 1)
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
            tokens[graphs] = _check_serve(what, cfg, graphs, json.loads(line[len("serve-stats "):]),
                                          launches, want, totals, batch, gen_len,
                                          prompt_len=prompt_len, engine=engine_used)
            _release()
        require(tokens[True] == tokens[False],
                f"serve {arch} {engine}: the captured steps' tokens differ from the eager ones")
    _serve_cut_runs(counters, totals)
    return totals


def _check_serve(what, cfg, graphs, stats, launches, want, totals, batch, gen_len, **fields):
    """Print one serve run's line and hold it to the mode asked for, the
    expected launches, caches in place and ``batch`` x ``gen_len`` tokens in
    the vocabulary; add its launches to ``totals``. Returns its tokens."""
    tokens = stats.pop("tokens")
    emit({"phase": "serve", **stats, **fields, "launches": launches,
          "launches_per_step": sum(launches.values()) / gen_len,  # a prefill, gen_len - 1 steps
          "sample_tokens": tokens[0][:8]})
    require(stats["graphs"] == graphs, f"{what}: graphs {stats['graphs']}")
    require(launches == want, f"{what}: launches {launches} != {want}")
    require(stats["cache_in_place"], f"{what}: the caches moved")
    require(all(0 <= t < cfg.vocab for row in tokens for t in row) and len(tokens) == batch
            and len(tokens[0]) == gen_len, f"{what}: bad tokens")
    for k, n in launches.items():
        totals[k] += n
    return tokens


def _cut_cfg(arch, layers):
    return _run_cfg(arch, None).with_(n_layers=layers)


def _serve_cut_runs(counters, totals):
    """CUT_SERVE_RUNS at full width through ``serve.run_batch``, the function
    ``serve.main`` runs, with serve.main's flags and params (made once per
    config, in the compute dtype, from seed 0): a 2-token warm-up, then the
    eager and the captured run (``serve.capture_batch_steps``), every
    kernel's count set to 0 just before each and read just after. Both must
    give the expected launches (B5: layers x 31), keep the caches where they
    lie and give the same tokens. Adds the launches to ``totals``."""
    import torch

    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.models.layers import _dtype

    gen_len, batch, prompt_len = 32, 4, 64
    device = torch.device("cuda")
    for arch, layers in CUT_SERVE_RUNS:
        cfg = _cut_cfg(arch, layers)
        argv = ["--arch", arch, "--batch", str(batch), "--prompt-len", str(prompt_len)]
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = lm.lm_init(torch.Generator(device=device).manual_seed(0), cfg, device=device,
                            dtype=_dtype(cfg.compute_dtype))
        torch.cuda.synchronize()
        init_ms = (time.perf_counter() - t0) * 1e3
        serve.run_batch(cfg, params, serve.parse_args(argv + ["--gen-len", "2"]), device,
                        graphs=False)  # warm-up
        want = _expected_launches(cfg, gen_len - 1)
        tokens = {}
        for graphs in (False, True):
            what = f"serve {arch} ({layers} layers, {'captured' if graphs else 'eager'})"
            for mod, attr in counters.values():
                setattr(mod, attr, 0)
            stats = serve.run_batch(cfg, params, serve.parse_args(argv + ["--gen-len", str(gen_len)]),
                                    device, graphs=graphs)
            launches = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
            tokens[graphs] = _check_serve(
                what, cfg, graphs, stats, launches, want, totals, batch, gen_len,
                n_layers=layers, depth_cut_from=_run_cfg(arch, None).n_layers, init_ms=init_ms,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, prompt_len=prompt_len,
                engine=None, moe_impl=cfg.moe_impl if cfg.moe else None)
        require(tokens[True] == tokens[False],
                f"serve {arch}: the captured steps' tokens differ from the eager ones")
        del params
        _release()


def phase_continuous():
    """Continuous batching (``serve --mode continuous``, B = 4 slots, full
    width, bf16): each config's five runs (``CONTINUOUS_RUNS``) through
    ``serve.main``, every kernel's count set to 0 just before each run and
    read just after. Required: the eager and captured runs, and depth 1 and
    2, give every stream the same tokens; the prefix cache on gives the
    cache-off tokens with at least one hit; each run's launches equal its
    engine steps (prefill chunks plus decode steps) times the launches of a
    step; every pool cache leaf keeps its storage; every request completes.
    Then one captured depth-2 run of a shorter trace under torch.profiler:
    device time per tick against the host's, hence the idle share. Returns
    the launches summed over the runs."""
    from repro_torch.launch import serve

    counters = _launch_counters()
    totals = dict.fromkeys(KERNELS, 0)
    for arch, engine in CONTINUOUS_CONFIGS:
        extra = ["--engine", engine] if engine else []
        cfg = _run_cfg(arch, engine)
        tokens, stats_of = {}, {}
        for run, graphs, flags in CONTINUOUS_RUNS:
            what = f"continuous {arch} {engine} [{run}]"
            stats, launches = _counted_run(
                counters, lambda: serve.main(["--arch", arch, "--mode", "continuous", "--batch",
                                              "4"] + flags + extra, graphs=graphs), what)
            tokens[run] = stats.pop("tokens")
            stats_of[run] = stats
            steps = stats["prefill_chunks"] + stats["decode_steps"]
            want = _expected_launches(cfg, steps - 1)
            ok_tokens = all(0 <= t < cfg.vocab for row in tokens[run].values() for t in row)
            emit({"phase": "continuous", "arch": arch, "engine": cfg.scan_engine, "run": run,
                  "launches": launches, "expected_launches": want,
                  "ms_per_tick": stats["busy_s"] / max(stats["ticks"], 1) * 1e3,
                  "ttft_p50_ms": stats["ttft_s"]["p50"] * 1e3,
                  "ttft_p95_ms": stats["ttft_s"]["p95"] * 1e3,
                  "tpot_p50_ms": stats["tpot_s"]["p50"] * 1e3, **stats})
            require(stats["graphs"] == graphs, f"{what}: graphs {stats['graphs']}")
            require(launches == want, f"{what}: launches {launches} != {want} "
                    f"({stats['prefill_chunks']} prefill chunks, {stats['decode_steps']} "
                    "decode steps)")
            require(stats["cache_in_place"], f"{what}: a pool cache leaf moved")
            require(stats["completed"] == stats["requests"] and ok_tokens,
                    f"{what}: {stats['completed']}/{stats['requests']} completed, tokens in "
                    f"vocab {ok_tokens}")
            for k, n in launches.items():
                totals[k] += n
        runs = [r for r, _, _ in CONTINUOUS_RUNS]
        for a, b, why in ((runs[0], runs[1], "eager and captured"),
                          (runs[1], runs[2], "async depth 1 and 2"),
                          (runs[3], runs[4], "the prefix cache off and on")):
            same = [rid for rid in tokens[a] if tokens[a][rid] == tokens[b][rid]]
            require(len(same) == len(tokens[a]) and tokens[a].keys() == tokens[b].keys(),
                    f"continuous {arch} {engine}: {why} differ on "
                    f"{len(tokens[a]) - len(same)} of {len(tokens[a])} streams")
        require(stats_of[runs[4]]["prefix_hits"] >= 1,
                f"continuous {arch} {engine}: the prefix cache had no hit")
        _profile_continuous(cfg, stats_of[runs[2]])
    return totals


def _profile_continuous(cfg, unprofiled, phase="continuous", spec_k=0):
    """Two captured depth-2 Schedulers on ``CONTINUOUS_PROFILE_REQUESTS``
    headline-trace requests: one with the tick trace on, for the host's time
    per tick by phase (span sums per tick); one under torch.profiler, for
    the device time of all device-side events (kernels, copies) per tick,
    against the host's busy time per tick in that run (inflated by the
    profiler) and in the unprofiled depth-2 headline run. With ``spec_k``
    both are speculative with the oracle draft (the target as its own
    draft) at that k."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import lm
    from repro_torch.models.layers import _dtype
    from repro_torch.observability import Telemetry, TraceRecorder
    from repro_torch.serving import Scheduler, headline_poisson_trace

    params = lm.lm_init(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda",
                        dtype=_dtype(cfg.compute_dtype))
    trace = headline_poisson_trace(cfg.vocab, requests=CONTINUOUS_PROFILE_REQUESTS)
    tel = Telemetry(trace=TraceRecorder(capacity=1 << 20))
    spec = dict(draft_cfg=cfg, draft_params=params, spec_k=spec_k) if spec_k else {}
    eng = Scheduler(cfg, params, batch=4, async_depth=2, device="cuda", telemetry=tel, **spec)
    eng.warmup()
    eng.run(trace)
    traced_ticks = eng.metrics.ticks
    spans = _span_ms_per_tick(tel.trace.to_chrome(), traced_ticks)
    eng = Scheduler(cfg, params, batch=4, async_depth=2, device="cuda", **spec)
    eng.warmup()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.run(headline_poisson_trace(cfg.vocab, requests=CONTINUOUS_PROFILE_REQUESTS))
        torch.cuda.synchronize()
    device_ms = sum(getattr(e, "self_device_time_total", 0.0) or 0.0
                    for e in prof.key_averages() if e.device_type == DeviceType.CUDA) / 1e3
    ticks, busy_ms = eng.metrics.ticks, eng.metrics.busy_s * 1e3
    device_per_tick = device_ms / max(ticks, 1)
    tick_ms = unprofiled["busy_s"] * 1e3 / max(unprofiled["ticks"], 1)
    what = f", oracle k={spec_k}" if spec_k else ""
    emit({"phase": phase, "arch": cfg.name, "engine": cfg.scan_engine,
          "run": f"profiled, captured d2{what}, {CONTINUOUS_PROFILE_REQUESTS} requests",
          "host_ms_per_tick_by_phase": spans,
          "traced_ticks": traced_ticks,
          "ticks": ticks, "device_ms": device_ms, "busy_ms": busy_ms,
          "device_ms_per_tick": device_per_tick, "ms_per_tick_profiled": busy_ms / max(ticks, 1),
          "idle_share_profiled": 1.0 - device_ms / busy_ms if busy_ms else None,
          "ms_per_tick_unprofiled": tick_ms,
          "idle_share_vs_unprofiled": 1.0 - device_per_tick / tick_ms if tick_ms else None})
    require(device_ms > 0, f"{phase} profile {cfg.name}: no device time traced")


def _spec_row(stats, plain=None):
    """A continuous run's line fields: the timings and the speculative
    counters; against ``plain`` tokens, how many streams differ and where
    each first differs."""
    row = {"ms_per_tick": stats["busy_s"] / max(stats["ticks"], 1) * 1e3,
           "ttft_p50_ms": stats["ttft_s"]["p50"] * 1e3, "ttft_p95_ms": stats["ttft_s"]["p95"] * 1e3,
           "tpot_p50_ms": stats["tpot_s"]["p50"] * 1e3}
    for k in ("goodput_tok_s", "spec_acceptance_rate", "accepted_tokens_per_cycle",
              "verify_steps", "draft_steps", "spec_rollbacks", "decode_steps", "prefill_chunks",
              "ticks", "completed", "requests", "capture_ms", "peak_mem_gb", "cache_in_place",
              "graphs", "fetch_wait_s", "occupancy_mean"):
        row[k] = stats.get(k)
    if plain is not None:
        first = {}
        for rid, toks in stats["tokens"].items():
            ref = plain[rid]
            if toks != ref:
                first[rid] = next((i for i, (a, b) in enumerate(zip(toks, ref)) if a != b),
                                  min(len(toks), len(ref)))
        row["streams_differing_from_plain"] = len(first)
        row["first_difference_at"] = sorted(first.values())
    return row


def _spec_fp32(arch, engine):
    """fp32 compute, captured, depth 2, ``SPEC_FP32_REQUESTS`` requests of
    the headline trace through the Scheduler: plain, then each draft of
    ``SPEC_FP32_RUNS``. Required: every stream's tokens equal the plain
    run's; the oracle rolls back never and accepts everything; the floor
    rolls back at least once; every request completes; both pools stay."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.models import lm
    from repro_torch.serving import Scheduler, clone_trace, headline_poisson_trace

    cfg = _run_cfg(arch, engine).with_(compute_dtype="float32")
    dcfg = get_config("sru-paper-draft").with_(compute_dtype="float32")
    params, dparams = (lm.lm_init(torch.Generator(device="cuda").manual_seed(seed), c,
                                  device="cuda", dtype=torch.float32)
                       for seed, c in ((0, cfg), (1, dcfg)))
    trace = headline_poisson_trace(cfg.vocab, requests=SPEC_FP32_REQUESTS)
    plain = None
    for run, draft, k, _ in SPEC_FP32_RUNS:
        what = f"speculative fp32 {arch} {engine} [{run}]"
        spec = {}
        if draft:
            spec = dict(draft_cfg=dcfg if draft == "floor" else cfg,
                        draft_params=dparams if draft == "floor" else params, spec_k=k)
        torch.cuda.reset_peak_memory_stats()
        eng = Scheduler(cfg, params, batch=4, async_depth=2, device="cuda", **spec)
        eng.warmup()
        done = eng.run(clone_trace(trace))
        torch.cuda.synchronize()
        stats = eng.metrics.report()
        stats.update(graphs=eng.captured, capture_ms=eng.capture_ms,
                     peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                     cache_in_place=eng.cache_in_place, requests=len(trace),
                     tokens={r.rid: list(r.tokens) for r in done})
        row = _spec_row(stats, plain)
        emit({"phase": "speculative", "arch": arch, "engine": cfg.scan_engine, "run": run,
              "compute": "float32", "draft": draft, "k": k or None, **row})
        require(stats["completed"] == len(trace) and eng.cache_in_place and eng.captured,
                f"{what}: {stats['completed']}/{len(trace)} completed, pools in place "
                f"{eng.cache_in_place}")
        if plain is None:
            plain = stats["tokens"]
            continue
        require(row["streams_differing_from_plain"] == 0,
                f"{what}: {row['streams_differing_from_plain']} streams differ from plain")
        if draft == "oracle":
            require(stats["spec_rollbacks"] == 0 and stats["spec_acceptance_rate"] == 1.0,
                    f"{what}: oracle rolled back {stats['spec_rollbacks']} times, acceptance "
                    f"{stats['spec_acceptance_rate']}")
        else:
            require(stats["spec_rollbacks"] >= 1, f"{what}: the floor draft never rolled back")
        del eng


def phase_speculative():
    """Speculative decode on the card (``serve --mode continuous
    --speculative``, B = 4 slots, full width): per config of
    ``CONTINUOUS_CONFIGS``, the fp32 runs (``_spec_fp32``), then the bf16
    runs of ``SPEC_BF16_RUNS`` on the headline trace at depth 2, through
    ``serve.main`` (the oracle, whose draft params are the target's, through
    ``serve.run_continuous``), every kernel's count set to 0 just before
    each run and read just after. Required: every request completes; the
    floor's eager and captured runs give the same tokens; both pools stay
    where they were allocated; the launches equal the target's steps
    (prefill chunks, decode steps, verify steps) times its launches a step,
    plus, for the oracle, the draft's steps (its prefill chunks, the
    target's here since every lane speculates, and ``draft_steps``) times
    the same. Reported: how many streams differ from the plain bf16 run.
    Then one tick-traced and one profiled oracle run per config. Returns
    the launches summed over the bf16 runs."""
    import torch

    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.models.layers import _dtype

    counters = _launch_counters()
    totals = dict.fromkeys(KERNELS, 0)
    dev = torch.device("cuda")
    for arch, engine in CONTINUOUS_CONFIGS:
        _spec_fp32(arch, engine)
        extra = ["--engine", engine] if engine else []
        cfg = _run_cfg(arch, engine)
        tokens, stats_of = {}, {}
        for run, draft, k, graphs in SPEC_BF16_RUNS:
            what = f"speculative {arch} {engine} [{run}]"
            flags = ["--arch", arch, "--mode", "continuous", "--batch", "4", "--headline-trace",
                     "--async-depth", "2"] + extra
            if draft:
                flags += ["--speculative", "--spec-k", str(k)]
            if draft == "oracle":
                # serve.main with the target's params as the draft's
                args = serve.parse_args(flags)
                torch.cuda.reset_peak_memory_stats(dev)
                params = lm.lm_init(torch.Generator(device=dev).manual_seed(args.seed), cfg,
                                    device=dev, dtype=_dtype(cfg.compute_dtype))
                stats, launches = _counted_run(
                    counters, lambda: serve.run_continuous(cfg, params, args, dev, graphs=graphs,
                                                           draft_cfg=cfg, draft_params=params),
                    what)
                stats["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
                del params
            else:
                stats, launches = _counted_run(
                    counters, lambda: serve.main(flags, graphs=graphs), what)
            stats_of[run] = stats
            tokens[run] = stats["tokens"]
            target_steps = stats["prefill_chunks"] + stats["decode_steps"] + stats["verify_steps"]
            want = _expected_launches(cfg, target_steps - 1)
            if draft == "oracle":
                draft_want = _expected_launches(cfg, stats["prefill_chunks"]
                                                + stats["draft_steps"] - 1)
                want = {k_: n + draft_want[k_] for k_, n in want.items()}
            ok_tokens = all(0 <= t < cfg.vocab for row in tokens[run].values() for t in row)
            plain = tokens[SPEC_BF16_RUNS[0][0]] if draft else None
            emit({"phase": "speculative", "arch": arch, "engine": cfg.scan_engine, "run": run,
                  "compute": "bfloat16", "draft": draft, "k": k or None, "launches": launches,
                  "expected_launches": want, **_spec_row(stats, plain)})
            require(stats["graphs"] == graphs, f"{what}: graphs {stats['graphs']}")
            require(launches == want, f"{what}: launches {launches} != {want} "
                    f"({stats['prefill_chunks']} prefill chunks, {stats['decode_steps']} decode "
                    f"steps, {stats['verify_steps']} verify steps, {stats['draft_steps']} draft "
                    "steps)")
            require(stats["cache_in_place"], f"{what}: a pool cache leaf moved")
            require(stats["completed"] == stats["requests"] and ok_tokens,
                    f"{what}: {stats['completed']}/{stats['requests']} completed, tokens in "
                    f"vocab {ok_tokens}")
            require(not draft or stats["verify_steps"] > 0, f"{what}: no verify step")
            for k_, n in launches.items():
                totals[k_] += n
        eager, captured = (tokens[r[0]] for r in SPEC_BF16_RUNS[1:3])
        same = [rid for rid in eager if eager[rid] == captured.get(rid)]
        require(len(same) == len(eager) == len(captured),
                f"speculative {arch} {engine}: eager and captured differ on "
                f"{len(eager) - len(same)} of {len(eager)} streams")
        _profile_continuous(cfg, stats_of[SPEC_BF16_RUNS[3][0]], phase="speculative", spec_k=4)
    emit({"phase": "speculative", "launches": totals})
    return totals


def _trace_check(what, path, *flags):
    """``tools/trace_check.py`` on ``path`` as a subprocess, with its own
    default epsilons; fails the phase unless it accepts the trace."""
    out = subprocess.run([sys.executable, str(ROOT / "tools" / "trace_check.py"), str(path),
                          *flags], capture_output=True, text=True, timeout=300)
    require(out.returncode == 0,
            f"{what}: trace_check refused {path}: {out.stdout.strip()} {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[-1]


def _prometheus_ok(text: str) -> bool:
    """Every non-comment line is a sample (``PROM_SAMPLE``) with a number
    for its value, and there is at least one."""
    samples = [x for x in text.splitlines() if x and not x.startswith("#")]
    for line in samples:
        m = PROM_SAMPLE.match(line)
        if m is None:
            return False
        try:
            float(m.group(2))
        except ValueError:
            return False
    return bool(samples)


def _span_ms_per_tick(doc, ticks):
    """Host ms per tick by phase from a tick trace (Chrome JSON: span sums
    on the tick track)."""
    track = next(e["tid"] for e in doc["traceEvents"]
                 if e.get("ph") == "M" and e.get("args", {}).get("name") == "tick")
    spans = {}
    for e in doc["traceEvents"]:
        if e.get("ph") == "X" and e.get("tid") == track:
            spans[e["name"]] = spans.get(e["name"], 0.0) + e["dur"] / 1e3
    return {k: v / max(ticks, 1) for k, v in sorted(spans.items())}


def profile_split(doc, ticks, phases=TICK_PHASES):
    """Split a torch.profiler trace (Chrome JSON; a ``--torch-profile``
    capture) by phase, the ``record_function`` annotations named in
    ``phases`` (the tick phases), from the first such annotation on (the
    warm-up and the captures before it are left out):

    * host: every host event on the annotations' thread (ops, runtime and
      driver calls) is nested by time; its self time goes to the phase of
      the annotation it lies in (``unannotated`` outside any), by name; an
      annotation's own self time is ``(python)``, the Python code of the
      dispatch between its calls;
    * device: each kernel, copy and set is attributed through its
      correlation id to the runtime call that launched it, and that call's
      phase (a graph replay's kernels run later on the card, at depth 2
      during the next tick, but carry the ``cudaGraphLaunch``'s id);
    * lost events: a launching call (``LAUNCH_CALLS``) with no device event
      lost them (torch.profiler drops a session's first events); the phase
      instances (one annotation each) with such a call are counted, and the
      per-phase device times are the complete instances' mean times the
      instances a tick. The device events of each phase's graph replays are
      counted per replay (``graph_launch_device_events``: the distinct
      counts; replays of one graph that lost none agree). A phase instance
      is complete when it has no launching call without device events and
      no graph replay with fewer device events than the phase's fullest
      replay (each phase replays one graph); ``complete_instances`` and
      ``device_us_by_name_complete`` count those instances alone.

    Returns a dict of ms per tick (and each phase's device us and events by
    name, over the run), or None when the trace has no phase annotation."""
    ev = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    anns = sorted((e for e in ev if e.get("cat") == "user_annotation"
                   and e.get("name") in phases), key=lambda e: e["ts"])
    if not anns:
        return None
    pid, tid, t0 = anns[0]["pid"], anns[0]["tid"], anns[0]["ts"]
    host = sorted((e for e in ev if e.get("cat") in ("cpu_op", "cuda_runtime", "cuda_driver",
                                                      "user_annotation")
                   and e.get("pid") == pid and e.get("tid") == tid and e["ts"] >= t0),
                  key=lambda e: (e["ts"], -e["dur"]))
    self_us, ann_us, instances = {}, {}, {}
    corr_of = {}       # correlation id -> (phase, instance or None)
    launches = []      # (correlation id, phase, instance) of launching calls
    graph_launches = []  # the same, of graph replays
    frames = []        # open events: [end, phase, name, dur, children's us, instance]

    def close(frame):
        _, phase, name, dur, kids, _ = frame
        key = (phase, name)
        self_us[key] = self_us.get(key, 0.0) + max(dur - kids, 0.0)

    for e in host:
        while frames and e["ts"] >= frames[-1][0]:
            close(frames.pop())
        phase = frames[-1][1] if frames else "unannotated"
        inst = frames[-1][5] if frames else None
        is_ann = e["cat"] == "user_annotation" and e["name"] in phases
        if is_ann:
            phase = e["name"]
            inst = instances.get(phase, 0)
            instances[phase] = inst + 1
            ann_us[phase] = ann_us.get(phase, 0.0) + e["dur"]
        if frames:
            frames[-1][4] += e["dur"]
        frames.append([e["ts"] + e["dur"], phase, "(python)" if is_ann else e["name"], e["dur"],
                       0.0, inst])
        corr = e.get("args", {}).get("correlation")
        if corr is not None and e["cat"] in ("cuda_runtime", "cuda_driver"):
            corr_of[corr] = (phase, inst)
            if e["name"] in LAUNCH_CALLS:
                launches.append((corr, phase, inst))
            if e["name"] == "cudaGraphLaunch":
                graph_launches.append((corr, phase, inst))
    while frames:
        close(frames.pop())

    dev_us, inst_us, by_name, per_corr, outside = {}, {}, {}, {}, 0
    inst_names = {}    # (phase, instance) -> {name: [us, events]}
    for e in ev:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        corr = e.get("args", {}).get("correlation")
        if corr not in corr_of:
            outside += 1  # the warm-up's and captures' device work
            continue
        per_corr[corr] = per_corr.get(corr, 0) + 1
        phase, inst = corr_of[corr]
        dev_us[phase] = dev_us.get(phase, 0.0) + e["dur"]
        inst_us[(phase, inst)] = inst_us.get((phase, inst), 0.0) + e["dur"]
        for table in (by_name.setdefault(phase, {}), inst_names.setdefault((phase, inst), {})):
            us_n = table.setdefault(e["name"], [0.0, 0])
            us_n[0] += e["dur"]
            us_n[1] += 1
    lost = [(c, p, i) for c, p, i in launches if c not in per_corr]
    graph_counts = {}
    for c, p, _ in graph_launches:
        graph_counts.setdefault(p, set()).add(per_corr.get(c, 0))
    lost_inst = {(p, i) for _, p, i in lost}
    fullest = {p: max(n) for p, n in graph_counts.items()}
    partial = {(p, i) for c, p, i in graph_launches if per_corr.get(c, 0) < fullest[p]}
    complete, by_name_complete = {}, {}
    for phase, n in instances.items():
        for i in range(n):
            if (phase, i) in lost_inst or (phase, i) in partial:
                continue
            complete[phase] = complete.get(phase, 0) + 1
            table = by_name_complete.setdefault(phase, {})
            for name, (us, k) in inst_names.get((phase, i), {}).items():
                us_n = table.setdefault(name, [0.0, 0])
                us_n[0] += us
                us_n[1] += k
    per_tick = 1e3 * max(ticks, 1)
    device_by_phase = {}
    for phase, n in instances.items():
        kept = [i for i in range(n) if (phase, i) not in lost_inst]
        if kept:
            mean_us = sum(inst_us.get((phase, i), 0.0) for i in kept) / len(kept)
            device_by_phase[phase] = mean_us * n / per_tick
    device_total = sum(dev_us.values())
    host_by_phase = {}
    for phase in list(instances) + ["unannotated"]:
        calls = sorted(((us, name) for (p, name), us in self_us.items() if p == phase),
                       reverse=True)
        total = ann_us.get(phase, sum(us for us, _ in calls))
        host_by_phase[phase] = {
            "ms_per_tick": total / per_tick,
            "calls_ms_per_tick": [[name, us / per_tick]
                                  for us, name in calls[:TELEMETRY_TOP_CALLS]]}
    return {"phase_instances": instances,
            "device_ms_per_tick": device_total / per_tick,
            "device_ms_per_tick_by_phase": device_by_phase,
            "device_ms_per_tick_unattributed": dev_us.get("unannotated", 0.0) / per_tick,
            "unattributed_share": (dev_us.get("unannotated", 0.0) / device_total
                                   if device_total else None),
            "host_ms_per_tick_by_phase": host_by_phase,
            "launching_calls": len(launches), "lost_launching_calls": len(lost),
            "phase_instances_with_lost_events": len({k for k in lost_inst if k[1] is not None}),
            "first_lost_call_at": (launches.index(lost[0]) if lost else None),
            "last_lost_call_at": (launches.index(lost[-1]) if lost else None),
            "graph_launch_device_events": {p: sorted(n) for p, n in graph_counts.items()},
            "device_events_before_the_run": outside, "device_us_by_name": by_name,
            "complete_instances": complete, "device_us_by_name_complete": by_name_complete}


def phase_telemetry():
    """Telemetry on the card (``serve --mode continuous`` with the telemetry
    flags, B = 4 slots, full width, bf16, captured, async depth 2) for each
    config of ``CONTINUOUS_CONFIGS``, every kernel's count set to 0 just
    before each run and read just after:

    1. the headline trace with telemetry off and on in turns
       (``TELEMETRY_RUNS``; on = ``--trace-out --metrics-jsonl
       --metrics-every 16 --prom-out``), through ``serve.main``;
    2. ``--torch-profile DIR`` on ``CONTINUOUS_PROFILE_REQUESTS`` headline
       requests, through ``serve.run_continuous``;
    3. the oracle draft (the target as its own draft) at k = 4 on the
       headline trace with the trace on.

    Required, a failure fails the phase: every run captured, complete,
    with its pool in place and the launches its steps account for (target
    steps, and the oracle draft's, times a step's launches); the on runs'
    tokens equal the off runs' for every stream, bit for bit; the off runs
    record nothing; ``tools/trace_check.py`` accepts the on runs' traces
    and metrics rows (overlap, decode, fetch, retire) and the speculative
    trace (draft, verify) at its default epsilons; the Prometheus snapshot
    parses; the profiler ran and its ``*.pt.trace.json`` names the
    ``decode`` and ``prefill`` annotations. Printed per config: ms per tick
    off and on (the telemetry's overhead), the straggler count, host ms per
    tick by phase from the trace, and from the profile device ms per tick
    by phase with the share no phase claimed and host ms per tick by phase
    and by call (``profile_split``). Returns the launches summed over the
    runs."""
    import torch

    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.models.layers import _dtype
    from repro_torch.serving import headline_poisson_trace

    counters = _launch_counters()
    totals = dict.fromkeys(KERNELS, 0)
    dev = torch.device("cuda")
    shutil.rmtree(TELEMETRY_DIR, ignore_errors=True)
    for arch, engine in CONTINUOUS_CONFIGS:
        extra = ["--engine", engine] if engine else []
        cfg = _run_cfg(arch, engine)
        base = ["--arch", arch, "--mode", "continuous", "--batch", "4", "--async-depth",
                "2"] + extra
        top = TELEMETRY_DIR / (arch + (f"-{engine}" if engine else ""))
        tokens, ms, on_stats = {}, {}, []

        def checked(stats, launches, what, draft_steps=None):
            target = stats["prefill_chunks"] + stats["decode_steps"] + stats["verify_steps"]
            want = _expected_launches(cfg, target - 1)
            if draft_steps is not None:  # the oracle draft: the target's own kernels
                drafted = _expected_launches(cfg, stats["prefill_chunks"] + draft_steps - 1)
                want = {k: n + drafted[k] for k, n in want.items()}
            require(stats["graphs"], f"{what}: the steps did not run as graphs")
            require(launches == want, f"{what}: launches {launches} != {want}")
            require(stats["cache_in_place"], f"{what}: a pool cache leaf moved")
            require(stats["completed"] == stats["requests"],
                    f"{what}: {stats['completed']}/{stats['requests']} completed")
            for k, n in launches.items():
                totals[k] += n

        for run in TELEMETRY_RUNS:
            what = f"telemetry {arch} {engine} [{run}]"
            d = top / run.replace(" ", "_")
            d.mkdir(parents=True)
            flags = base + ["--headline-trace"]
            on = run.startswith("on")
            if on:
                flags += ["--trace-out", str(d / "trace.json"), "--metrics-jsonl",
                          str(d / "metrics.jsonl"), "--metrics-every",
                          str(TELEMETRY_METRICS_EVERY), "--prom-out", str(d / "metrics.prom")]
            stats, launches = _counted_run(counters, lambda: serve.main(flags), what)
            checked(stats, launches, what)
            tokens[run] = stats["tokens"]
            ms[run] = stats["busy_s"] / max(stats["ticks"], 1) * 1e3
            sinks = (stats["stragglers"], stats["trace_events"], stats["metrics_rows"])
            if not on:
                require(sinks == (None, None, None), f"{what}: telemetry off recorded {sinks}")
                continue
            require(None not in sinks, f"{what}: a sink recorded nothing: {sinks}")
            verdict = _trace_check(what, d / "trace.json", "--metrics-jsonl",
                                   str(d / "metrics.jsonl"), "--expect-overlap",
                                   "--expect-phase", "decode", "--expect-phase", "fetch",
                                   "--expect-phase", "retire")
            prom = (d / "metrics.prom").read_text()
            require(_prometheus_ok(prom), f"{what}: the Prometheus snapshot does not parse")
            on_stats.append({"run": run, "stragglers": stats["stragglers"],
                             "trace_events": stats["trace_events"],
                             "metrics_rows": stats["metrics_rows"], "trace_check": verdict,
                             "host_ms_per_tick_by_phase": _span_ms_per_tick(
                                 json.loads((d / "trace.json").read_text()), stats["ticks"])})
        ref = tokens[TELEMETRY_RUNS[0]]
        for run in TELEMETRY_RUNS[1:]:
            differ = [rid for rid in ref if tokens[run].get(rid) != ref[rid]]
            require(not differ and tokens[run].keys() == ref.keys(),
                    f"telemetry {arch} {engine}: [{run}] differs from [off] on {len(differ)} "
                    f"of {len(ref)} streams")

        # the profiled run: the warm-up (captures) and the run in one session
        what = f"telemetry {arch} {engine} [torch profile]"
        d = top / "profile"
        args = serve.parse_args(base + ["--torch-profile", str(d)])
        params = lm.lm_init(torch.Generator(device=dev).manual_seed(args.seed), cfg, device=dev,
                            dtype=_dtype(cfg.compute_dtype))
        trace = headline_poisson_trace(cfg.vocab, requests=CONTINUOUS_PROFILE_REQUESTS)
        stats, launches = _counted_run(
            counters, lambda: serve.run_continuous(cfg, params, args, dev, trace=trace), what)
        checked(stats, launches, what)
        require(stats["torch_profile"] is True, f"{what}: the profiler did not run")
        files = sorted(d.glob("*.pt.trace.json"))
        require(len(files) == 1, f"{what}: {len(files)} *.pt.trace.json files in {d}")
        doc = json.loads(files[0].read_text())
        named = {e.get("name") for e in doc["traceEvents"] if e.get("cat") == "user_annotation"}
        require({"decode", "prefill"} <= named,
                f"{what}: the profile's annotations {sorted(named)} lack decode or prefill")
        split = profile_split(doc, stats["ticks"])
        require(split is not None and split["device_ms_per_tick"] > 0,
                f"{what}: no device time attributed to the run")
        del split["device_us_by_name"], split["device_us_by_name_complete"]  # in the profile
        busy = stats["busy_s"] / max(stats["ticks"], 1) * 1e3
        in_ops = sum(h["ms_per_tick"] for h in split["host_ms_per_tick_by_phase"].values())
        profile = {"requests": len(trace), "ticks": stats["ticks"], "ms_per_tick_profiled": busy,
                   "host_ms_per_tick_outside_phases_and_ops": busy - in_ops,
                   "trace_mb": files[0].stat().st_size / 2**20, **split}
        del doc

        # the oracle speculative run with the trace on
        what = f"telemetry {arch} {engine} [speculative oracle k=4]"
        d = top / "speculative"
        d.mkdir(parents=True)
        args = serve.parse_args(base + ["--headline-trace", "--speculative", "--spec-k", "4",
                                        "--trace-out", str(d / "trace.json")])
        stats, launches = _counted_run(
            counters, lambda: serve.run_continuous(cfg, params, args, dev, draft_cfg=cfg,
                                                   draft_params=params), what)
        checked(stats, launches, what, draft_steps=stats["draft_steps"])
        require(stats["verify_steps"] > 0 and stats["trace_events"],
                f"{what}: {stats['verify_steps']} verify steps, {stats['trace_events']} events")
        spec_verdict = _trace_check(what, d / "trace.json", "--expect-phase", "draft",
                                    "--expect-phase", "verify")
        del params

        off_ms = [ms[r] for r in TELEMETRY_RUNS if not r.startswith("on")]
        on_ms = [ms[r] for r in TELEMETRY_RUNS if r.startswith("on")]
        emit({"phase": "telemetry", "arch": arch, "engine": cfg.scan_engine,
              "ms_per_tick": ms, "ms_per_tick_off": sum(off_ms) / len(off_ms),
              "ms_per_tick_on": sum(on_ms) / len(on_ms),
              "overhead_ms_per_tick": sum(on_ms) / len(on_ms) - sum(off_ms) / len(off_ms),
              "tokens_on_equal_off": True, "graphs": True, "on_runs": on_stats,
              "speculative": {"stragglers": stats["stragglers"],
                              "trace_events": stats["trace_events"],
                              "spec_acceptance_rate": stats["spec_acceptance_rate"],
                              "ms_per_tick": stats["busy_s"] / max(stats["ticks"], 1) * 1e3,
                              "host_ms_per_tick_by_phase": _span_ms_per_tick(
                                  json.loads((d / "trace.json").read_text()), stats["ticks"]),
                              "trace_check": spec_verdict},
              "profile": profile})
    emit({"phase": "telemetry", "launches": totals})
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
    the host clock and, in one torch.profiler session, ``steps`` more
    traced and dropped, then the window: ``steps`` steps, each inside its
    own ``record_function`` (PROFILE_WINDOW), whose device events are the
    ones launched inside it (``profile_split``). A step that lost device
    events is left out; windows are profiled until ``steps`` complete
    steps are in, at most PROFILE_WINDOWS. Returns (host ms per step,
    [(device us per step, events per step, name)] of the complete steps'
    device-side events, whether the caches kept their storage, the caches,
    the windows profiled, the complete steps)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.launch import serve
    from repro_torch.training.graphs import leaves

    logits, caches = prefill(params, inputs)
    ptrs = [t.data_ptr() for t in leaves(caches)]

    def step():
        nonlocal logits, caches
        tok = torch.argmax(logits[:, -1, : cfg.vocab], dim=-1)[:, None]
        logits, caches = decode(params, caches, serve.step_input(cfg, params, tok))

    def run():
        for _ in range(steps):
            step()
        torch.cuda.synchronize()

    run()  # warm-up
    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    path = ROOT / "build" / "profile_window.pt.trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    by_name, complete = {}, 0
    for window in range(1, PROFILE_WINDOWS + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            for _ in range(steps):
                with record_function(PROFILE_WINDOW):
                    step()
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(path))
        split = profile_split(json.loads(path.read_text()), steps, phases=(PROFILE_WINDOW,)) or {}
        path.unlink()
        complete += split.get("complete_instances", {}).get(PROFILE_WINDOW, 0)
        window_names = split.get("device_us_by_name_complete", {}).get(PROFILE_WINDOW, {})
        for name, (us, n) in window_names.items():
            us_n = by_name.setdefault(name, [0.0, 0])
            us_n[0] += us
            us_n[1] += n
        if complete >= steps:
            break
    kernels = [(us / complete, n / complete, name) for name, (us, n) in by_name.items() if us > 0]
    in_place = [t.data_ptr() for t in leaves(caches)] == ptrs
    kernels.sort(reverse=True)
    return wall_ms, kernels, in_place, caches, window, complete


def _touched_experts(cfg, params, prefill, decode, inputs):
    """The experts one eager decode step (the first after the prompt) routes
    its B tokens to, counted per layer: the router's choices recorded while
    the step runs (a host read per layer, outside every timed run)."""
    import torch

    from repro_torch.launch import serve
    from repro_torch.models import moe

    counts, route = [], moe._route

    def recorded(p, c, x):
        w, ids, probs = route(p, c, x)
        counts.append(int(torch.unique(ids).numel()))
        return w, ids, probs

    logits, caches = prefill(params, inputs)
    tok = torch.argmax(logits[:, -1, : cfg.vocab], dim=-1)[:, None]
    moe._route = recorded
    try:
        decode(params, caches, serve.step_input(cfg, params, tok))
    finally:
        moe._route = route
    require(len(counts) == cfg.n_layers, f"profile {cfg.name}: {len(counts)} routings recorded")
    return counts


def phase_profile():
    """Where a decode step's time goes (B = 4, after a 64-token prefill), with
    the eager steps and with the steps as CUDA graphs: host clock per step
    without the profiler, then torch.profiler's device time per step by
    kernel. Idle share = 1 - device time / step time. The device counts the
    launches of our kernels per step (``OUR_KERNEL_SYMBOLS``) over the
    profiled steps that kept all their device events, at least ``steps`` of
    them, which must be the wrappers' expected launches per step in both
    modes: the card's own confirmation that each replay runs our kernels. The step's bound is the
    bytes it must move once over the HBM rate: every layer weight, the final
    norm, the logits matrix and the valid KV rows read, or for Mamba-2 its
    SSM state and conv tails read and written; a hybrid's shared block is
    read once per application, with its KV rows; an MoE step's bound reads
    every expert, and a second one only the experts its routing touched.
    The CUT_SERVE_RUNS configs run at their cut depth."""
    import torch

    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.models.layers import _dtype
    from repro_torch.training.steps import build_decode_step, build_prefill_step

    steps, prompt_len = 8, 64
    runs = ([(arch, engine, _run_cfg(arch, engine)) for arch, engine in PROFILE_RUNS]
            + [(arch, None, _cut_cfg(arch, layers)) for arch, layers in CUT_SERVE_RUNS])
    for arch, engine, cfg in runs:
        params = lm.lm_init(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda",
                            dtype=_dtype(cfg.compute_dtype))
        max_len = prompt_len + (2 + 2 * PROFILE_WINDOWS) * steps
        prefill = build_prefill_step(cfg, batch=4, max_len=max_len, device="cuda")
        decode = build_decode_step(cfg)
        inputs = serve.prompt_inputs(cfg, 4, prompt_len, 0, "cuda")
        per_step = (sum(_expected_launches(cfg, 1).values())
                    - sum(_expected_launches(cfg, 0).values()))
        head = params["embed"].get("unembed", params["embed"]["embed"])
        # a hybrid's shared block is read at each application: 13 x 0.41 GB
        # for zamba2-7b do not stay in the 50 MB L2
        n_shared = cfg.n_layers // cfg.attn_every if cfg.attn_every else 0
        weight_bytes = (_tree_bytes(params["layers"]) + _tree_bytes(params["final_norm"])
                        + _tree_bytes(head) + n_shared * _tree_bytes(params.get("shared_attn")))
        # MoE: the sorted schedule computes every expert's C slots, so the
        # bound reads every expert weight; the second bound reads only the
        # experts one decode step's routing touched.
        touched = _touched_experts(cfg, params, prefill, decode, inputs) if cfg.moe else None
        if touched is not None:
            expert_bytes = sum(_tree_bytes(v) for k, v in params["layers"]["moe"].items()
                               if k != "router")
            touched_bytes = (weight_bytes - expert_bytes
                             + sum(touched) * expert_bytes // (cfg.n_layers * cfg.n_experts))
        captured = serve.capture_batch_steps(cfg, prefill, decode, params, inputs)
        for graphs, (pre, dec) in ((False, (prefill, decode)), (True, captured)):
            wall_ms, kernels, in_place, caches, windows, complete = _profile_steps(
                cfg, params, pre, dec, inputs, steps)
            device_ms = sum(k[0] for k in kernels) / 1e3 if kernels else None
            ours = [k for k in kernels if any(n in k[2] for n in OUR_KERNEL_SYMBOLS)]
            ours_per_step = sum(k[1] for k in ours)
            kv_bytes = 0
            if cfg.ssm:  # every cache leaf read and written once per step
                kv_bytes = 2 * _tree_bytes(caches["layers"])
            attn_caches = n_shared if cfg.ssm else (cfg.n_layers if cfg.cell is None else 0)
            if attn_caches:  # mean valid rows over the profiled steps, K and V read
                rows = prompt_len + (1 + 2 * windows) * steps + (steps + 1) / 2
                k = caches["shared_attn" if cfg.ssm else "layers"]["k"]
                kv_bytes += (2 * attn_caches * 4 * rows * cfg.n_kv_heads * cfg.d_head
                             * k.element_size())
            step_bytes = weight_bytes + kv_bytes
            emit({"phase": "profile", "arch": arch,
                  "engine": cfg.scan_engine if cfg.cell in ("sru", "qrnn") else None,
                  "n_layers": cfg.n_layers, "graphs": graphs, "step_ms": wall_ms,
                  "device_ms": device_ms,
                  "profile_windows": windows, "profiled_complete_steps": complete,
                  "device_ops_per_step": sum(k[1] for k in kernels),
                  "idle_share": None if device_ms is None else 1.0 - device_ms / wall_ms,
                  "step_bound_ms": step_bytes / HBM_BYTES_PER_S * 1e3, "step_bytes": step_bytes,
                  "cache_bytes_per_step": kv_bytes, "cache_in_place": in_place,
                  "experts_touched_per_layer": touched,
                  "step_bound_touched_experts_ms": None if touched is None
                  else (touched_bytes + kv_bytes) / HBM_BYTES_PER_S * 1e3,
                  "our_kernels_us_per_step": sum(k[0] for k in ours),
                  "our_launches_per_step": ours_per_step, "expected_launches_per_step": per_step,
                  "top_kernels_us_per_step": [[round(k[0], 2), k[1], k[2][:70]]
                                              for k in kernels[:8]]})
            mode = "captured" if graphs else "eager"
            require(in_place, f"profile {arch} ({mode}): the decode step moved the cache")
            require(device_ms is not None, f"profile {arch} ({mode}): no device time traced")
            require(complete >= steps, f"profile {arch} ({mode}): {complete} profiled steps "
                    f"kept all their device events in {windows} windows, expected {steps}")
            require(ours_per_step == per_step,
                    f"profile {arch} ({mode}): the card ran {ours_per_step} of our kernels a "
                    f"step, expected {per_step}")
            del caches
        del params, captured, head, pre, dec  # the captured steps hold the params
        _release()


def phase_parity():
    """fp32 compute, the same params (drawn on the card, copied to the host),
    card against CPU: teacher-forced prefill logits, 8 decode steps, their
    greedy tokens and the caches (a hybrid's shared-block caches among
    them); on the card the attention and Mamba cache leaves keep their
    storage from prefill through decode. A frontend arch's prompt is a
    normal draw of embeddings and each forced token goes in as its
    embedding row, as the batch path feeds it."""
    import torch

    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.training.graphs import leaves

    for arch, engine, overrides in PARITY_RUNS:
        cfg = _run_cfg(arch, engine).with_(compute_dtype="float32", **overrides)
        params_gpu = lm.lm_init(torch.Generator(device="cuda").manual_seed(7), cfg, device="cuda")
        params_cpu = _tree_to(params_gpu, "cpu")
        g = torch.Generator().manual_seed(8)
        if cfg.frontend:
            prompt = {"inputs_embeds": torch.randn((4, 64, cfg.d_model), generator=g)}
        else:
            prompt = {"inputs": torch.randint(0, cfg.vocab, (4, 64), generator=g)}
        forced = torch.randint(0, cfg.vocab, (4, 8), generator=g)
        logits, caches = {}, {}
        with torch.inference_mode():
            for dev, params in (("cpu", params_cpu), ("cuda", params_gpu)):
                c = lm.lm_init_caches(cfg, 4, 72, device=dev)
                out, c = lm.lm_prefill(params, cfg, {k: v.to(dev) for k, v in prompt.items()}, c)
                ptrs = [t.data_ptr() for t in leaves(c)]
                steps = [out]
                for i in range(forced.shape[1]):
                    step_in = serve.step_input(cfg, params, forced[:, i:i + 1].to(dev))
                    out, c = lm.lm_decode_step(params, cfg, c, step_in)
                    steps.append(out)
                in_place = [t.data_ptr() for t in leaves(c)] == ptrs
                on = {t.device.type for t in steps + leaves(c)}
                require(on == {dev}, f"parity {arch}: the {dev} run's outputs lie on {on}")
                logits[dev] = torch.cat(steps, dim=1).cpu()
                caches[dev] = {f"{group}/{k}": v.cpu() for group, tree in c.items()
                               for k, v in tree.items()}
        err = (logits["cuda"] - logits["cpu"]).abs().max().item()
        prefill_err = (logits["cuda"][:, 0] - logits["cpu"][:, 0]).abs().max().item()
        prefill_tol = PARITY_PREFILL_TOL.get(arch, PARITY_TOL)
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
              "prefill_max_abs_err": prefill_err, "prefill_tol": prefill_tol,
              "cache_max_abs_err": cache_err, "same_greedy_tokens": same_tokens,
              "tol": PARITY_TOL, "finite": finite,
              "cache_in_place": in_place if cfg.cell is None else None})
        require(finite and err <= PARITY_TOL and cache_err <= PARITY_TOL and same_tokens
                and prefill_err <= prefill_tol,
                f"parity {arch} {engine}: logits err {err} (prefill {prefill_err}, tol "
                f"{prefill_tol}), cache err {cache_err} > {PARITY_TOL} or greedy tokens differ "
                f"({same_tokens})")
        require(cfg.cell is not None or in_place,
                f"parity {arch}: decode moved the cache's storage")
        del params_gpu, params_cpu
        _release()


def _expected_train_launches(cfg, steps: int) -> dict:
    """Launches of each kernel over ``steps`` train steps: the fused RNN
    kernels once per layer per forward, and under remat (``"block"``) the
    forward runs again in the backward's recompute; their autograd
    Functions' backward launches none. The linear scan adds its one-launch
    backward per layer. Attention and Mamba train through plain PyTorch (the
    decode kernels have no VJP in JAX): none."""
    want = dict.fromkeys(KERNELS, 0)
    if cfg.cell not in ("sru", "qrnn"):
        return want
    passes = 2 if cfg.remat != "none" else 1
    layers = cfg.n_layers * steps * cfg.microbatches
    if cfg.scan_engine == "fused_stack" and cfg.fuse_depth:
        want["fused_rnn_stack"] = passes * layers
    elif cfg.scan_engine in ("fused", "fused_stack"):
        want["fused_rnn_layer"] = passes * layers
    if cfg.scan_engine in ("fused", "fused_stack"):
        want["linear_scan"] = 2 * layers  # the recompute's recurrence, forward and backward
    elif cfg.scan_engine == "pallas":
        want["linear_scan"] = (passes + 1) * layers
    return want


def _train_cfg(arch, engine, overrides):
    """The config as ``launch.train.main`` runs it at TRAIN_BATCH."""
    cfg = _run_cfg(arch, engine).with_(**overrides)
    return cfg.with_(microbatches=min(cfg.microbatches, max(1, TRAIN_BATCH // 2)))


def _step0(cfg, params, batch):
    """Step 0's loss and grad norm: ``build_train_step``'s loss and grads
    (``steps.step_grads``) and the norm its AdamW clips by, without the
    update (not compared, and on the host half of a full-width MoE check)."""
    from repro_torch.optim.adamw import global_norm
    from repro_torch.training.steps import step_grads

    loss, grads = step_grads(cfg, params, batch)
    return loss.item(), global_norm(grads).item()


def _train_parity(cfg, rows=None):
    """Step 0 in fp32 compute on the card and on the CPU (``_step0``): the
    params ``launch.train.main`` draws (seed 0, drawn on the card, copied to
    the host) and its first batch (its first ``rows`` rows, where given, in
    at most as many microbatches). Returns (loss, grad norm) per device and
    each side's seconds."""
    import torch

    from repro_torch.data import make_pipeline
    from repro_torch.launch.train import batch_to_device
    from repro_torch.models import lm

    cfg32 = cfg.with_(compute_dtype="float32")
    if rows is not None:
        cfg32 = cfg32.with_(microbatches=min(cfg32.microbatches, rows))
    card = lm.lm_init(torch.Generator(device="cuda").manual_seed(0), cfg32, device="cuda")
    batch = make_pipeline(cfg32, TRAIN_BATCH, TRAIN_SEQ, seed=0).batch_at(0)
    if rows is not None:
        batch = {k: v[:rows] for k, v in batch.items()}
    out = {}
    for dev, params in (("cuda", card), ("cpu", None)):
        t0 = time.perf_counter()
        if params is None:
            params = _tree_to(card, "cpu")
            del card
        out[dev] = _step0(cfg32, params, batch_to_device(batch, dev))
        out[f"{dev}_s"] = time.perf_counter() - t0
        del params
    return out


def _recompute_ms(cfg):
    """Device ms per train step of the B1/B2 autograd Functions' backward
    (the recompute through the plain version, its recurrence on the linear
    scan, and its autograd), at the
    step's shapes in the compute dtype: forward + backward of one call less
    its forward, times the calls a step makes (a layer per call under
    ``fused``, the whole stack under ``fused_stack``, per microbatch). None
    for a config with neither."""
    from repro_torch.kernels.fused_rnn import ops, stacked

    B = TRAIN_BATCH // cfg.microbatches
    dtype = cfg.compute_dtype
    cell = cfg.cell
    if cfg.scan_engine == "fused_stack" and cfg.fuse_depth:
        fn, calls = stacked.fused_stack, cfg.microbatches
        _, args, kw, _, _ = _stack_case("train", cell, TRAIN_SEQ, B, cfg.d_model, cfg.n_layers,
                                        dtype, 900, block_t=cfg.mts_block_size)
    elif cfg.scan_engine == "fused":
        fn, calls = ops.fused_layer, cfg.microbatches * cfg.n_layers
        mode = "qrnn" if cell == "qrnn" else "sru_identity"
        _, args, kw, _, _ = _layer_case("train", mode, TRAIN_SEQ, B, cfg.d_model, cfg.rnn_hidden,
                                        dtype, 901, block_t=cfg.mts_block_size)
    else:
        return None
    import torch

    def fwd():
        with torch.no_grad():
            fn(*args, **kw)

    def fwd_bwd():
        a, k, _ = _grad_inputs(args, kw)
        outs = [o for o in fn(*a, **k) if o is not None]
        torch.autograd.backward(outs, [torch.ones_like(o) for o in outs])

    return (time_ms(fwd_bwd, iters=2, warmup=1) - time_ms(fwd, iters=5, warmup=1)) * calls


def _train_loop(cfg, monitor, metrics_out):
    """``launch.train.main``'s loop on a config its flags cannot name (an
    engine override, a cut depth): same seed, pipeline, schedule and
    monitor; writes the same metrics history."""
    import torch

    from repro_torch.data import make_pipeline
    from repro_torch.launch.train import batch_to_device
    from repro_torch.training.steps import build_train_step, init_train_state

    pipeline = make_pipeline(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    step_fn = build_train_step(cfg, base_lr=3e-4, warmup=20, total_steps=TRAIN_STEPS)
    state = init_train_state(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    history = []
    for step in range(TRAIN_STEPS):
        batch = batch_to_device(pipeline.batch_at(step), "cuda")
        monitor.start()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        monitor.stop(step)
        history.append({"step": step, "loss": loss,
                        **{k: float(v) for k, v in metrics.items() if k != "loss"}})
    metrics_out.write_text(json.dumps(history))
    return 0


def _step_leaves(step_dir) -> dict:
    """A saved step's ``{path: numpy array}`` (fp32 and integer leaves)."""
    import numpy as np

    manifest = json.loads((step_dir / "MANIFEST.json").read_text())
    return {e["path"]: np.load(step_dir / e["file"]) for e in manifest["leaves"]}


def _max_leaf_diff(a: dict, b: dict) -> float:
    import numpy as np

    require(a.keys() == b.keys(), "resume: the checkpoints' leaves differ")
    return max(float(np.abs(a[p].astype(np.float64) - b[p]).max()) for p in a)


def _resume_check(counters):
    """``launch.train.main`` on TRAIN_RESUME_ARCH: TRAIN_STEPS straight with
    a checkpoint at half way, and again from that checkpoint (a copy of it
    in a fresh directory, ``--resume auto``). Returns the max |difference|
    between the two final checkpoints' leaves, and the launches."""
    from repro_torch.launch import train

    full, resumed = TRAIN_DIR / "resume_full", TRAIN_DIR / "resume_from_half"
    k = TRAIN_STEPS // 2
    base = ["--arch", TRAIN_RESUME_ARCH, "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
            "--steps", str(TRAIN_STEPS), "--save-every", str(k), "--log-every", "1"]
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    with contextlib.redirect_stdout(io.StringIO()):
        require(train.main(base + ["--checkpoint-dir", str(full)]) == 0, "resume: full run")
        shutil.copytree(full / f"step_{k}", resumed / f"step_{k}")
        require(train.main(base + ["--checkpoint-dir", str(resumed), "--resume", "auto"]) == 0,
                "resume: resumed run")
    launches = {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}
    diff = _max_leaf_diff(_step_leaves(full / f"step_{TRAIN_STEPS}"),
                          _step_leaves(resumed / f"step_{TRAIN_STEPS}"))
    return diff, launches


def phase_train():
    """Training at full width (TRAIN_RUNS): per config the fp32 step-0
    parity with the CPU (TRAIN_PARITY_ROWS: on the first rows), then TRAIN_STEPS steps in the
    config's own dtypes
    (fp32 masters, bf16 compute) through ``launch.train.main`` (or its loop)
    with every kernel's count set to 0 just before and read just after:
    launches equal to the expected, finite losses, ms per step after the
    first, tokens/s, peak memory, and the B1/B2 backward's recompute time per
    step. Then the resume check."""
    import torch

    from repro_torch.launch import train
    from repro_torch.runtime import StepMonitor

    counters = _launch_counters()
    totals = dict.fromkeys(KERNELS, 0)
    if TRAIN_DIR.exists():
        shutil.rmtree(TRAIN_DIR)
    TRAIN_DIR.mkdir(parents=True)
    for arch, engine, overrides in TRAIN_RUNS:
        cfg = _train_cfg(arch, engine, overrides)
        what = f"train {arch} {engine or ''}".strip()
        depth = TRAIN_PARITY_DEPTH.get(arch, cfg.n_layers)
        rows = TRAIN_PARITY_ROWS.get(arch)
        parity = _train_parity(cfg.with_(n_layers=depth), rows)
        _release()  # the step-0 states before the run's own
        (loss_card, gn_card), (loss_cpu, gn_cpu) = parity["cuda"], parity["cpu"]
        loss_err, gn_err = abs(loss_card - loss_cpu), abs(gn_card - gn_cpu)
        require(loss_err <= PARITY_TOL and gn_err <= PARITY_TOL * gn_cpu,
                f"{what}: fp32 step 0 on the card (loss {loss_card}, grad norm {gn_card}) "
                f"!= the CPU's ({loss_cpu}, {gn_cpu})")
        step0 = {"n_layers": depth, "rows": rows or TRAIN_BATCH, "loss_card": loss_card,
                 "loss_cpu": loss_cpu, "loss_err": loss_err, "grad_norm_card": gn_card,
                 "grad_norm_cpu": gn_cpu, "grad_norm_err": gn_err, "tol": PARITY_TOL,
                 "grad_norm_rtol": PARITY_TOL, "host_s": parity["cpu_s"]}

        times = []

        class Monitor(StepMonitor):
            def stop(self, step):
                torch.cuda.synchronize()
                m = super().stop(step)
                times.append(m["step_time"])
                return m

        metrics_out = TRAIN_DIR / f"{arch}-{engine or 'own'}.json"
        argv = ["--arch", arch, "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
                "--steps", str(TRAIN_STEPS), "--log-every", "1", "--metrics-out", str(metrics_out)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        real_monitor, train.StepMonitor = train.StepMonitor, Monitor
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                rc = (train.main(argv) if engine is None and not overrides
                      else _train_loop(cfg, Monitor(), metrics_out))
        finally:
            train.StepMonitor = real_monitor
        launches = {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        require(rc == 0, f"{what}: returned {rc}")
        history = json.loads(metrics_out.read_text())
        losses = [h["loss"] for h in history]
        want = _expected_train_launches(cfg, TRAIN_STEPS)
        require(launches == want, f"{what}: launches {launches} != {want}")
        require(len(losses) == TRAIN_STEPS and all(math.isfinite(x) for x in losses),
                f"{what}: losses {losses}")
        step_ms = sum(times[1:]) / len(times[1:]) * 1e3
        recompute = _recompute_ms(cfg)
        emit({"phase": "train", "arch": arch, "engine": cfg.scan_engine,
              "via": "launch.train.main" if engine is None and not overrides else "train loop",
              "n_layers": cfg.n_layers, "depth_cut_from": _run_cfg(arch, engine).n_layers
              if overrides else None, "compute": cfg.compute_dtype, "remat": cfg.remat,
              "microbatches": cfg.microbatches, "moment_dtype": cfg.moment_dtype,
              "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
              "losses": losses, "grad_norms": [h["grad_norm"] for h in history],
              "step0_fp32": step0,
              "first_step_ms": times[0] * 1e3, "ms_per_step": step_ms,
              "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_ms * 1e3, "peak_mem_gb": peak_gb,
              "launches": {k: n for k, n in launches.items() if n},
              "expected_launches": {k: n for k, n in want.items() if n},
              "recompute_ms_per_step": recompute,
              "recompute_share": None if recompute is None else recompute / step_ms})
        for k, n in launches.items():
            totals[k] += n
        _release()
    diff, launches = _resume_check(counters)
    emit({"phase": "train", "arch": TRAIN_RESUME_ARCH, "resume_from_step": TRAIN_STEPS // 2,
          "steps": TRAIN_STEPS, "max_abs_param_diff": diff, "tol": TRAIN_RESUME_TOL})
    require(diff <= TRAIN_RESUME_TOL, f"train resume: params differ by {diff}")
    for k, n in launches.items():
        totals[k] += n
    emit({"phase": "train", "launches": totals})
    return totals


def _dir_bytes(d) -> int:
    return sum(p.stat().st_size for p in pathlib.Path(d).rglob("*") if p.is_file())


def _dir_snapshot(d) -> dict:
    """Every file under ``d`` by relative path -> its bytes' digest."""
    import hashlib

    d = pathlib.Path(d)
    return {str(p.relative_to(d)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(d.rglob("*")) if p.is_file()}


def _drop_cell_layout(step_dir) -> None:
    """Make a saved step's manifest look as a gate-major binary wrote it."""
    mpath = step_dir / "MANIFEST.json"
    manifest = json.loads(mpath.read_text())
    del manifest["cell_layout"]
    mpath.write_text(json.dumps(manifest))


def _manifest_shapes(step_dir) -> dict:
    manifest = json.loads((step_dir / "MANIFEST.json").read_text())
    return {e["path"]: e["shape"] for e in manifest["leaves"]}


def _same_bits(a, b) -> bool:
    """Two trees with the same paths, and at each the same dtype, shape and
    bytes."""
    from repro_torch.tree import flatten_with_paths

    fa, fb = flatten_with_paths(a), flatten_with_paths(b)
    if [p for p, _ in fa] != [p for p, _ in fb]:
        return False
    import torch

    return all(x.dtype == y.dtype and x.shape == y.shape
               and torch.equal(x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8))
               for (_, x), (_, y) in zip(fa, fb))


def _checkpoint_resume(arch, counted):
    """Part (a) for one config; returns its line."""
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.kernels.fused_rnn import layout
    from repro_torch.launch import migrate_checkpoint, train
    from repro_torch.training.steps import init_train_state

    cfg = _train_cfg(arch, None, {})
    k = TRAIN_STEPS // 2
    full, legacy, tool = (CKPT_DIR / f"{arch}-{w}" for w in ("full", "gate-major", "tool"))
    base = ["--arch", arch, "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
            "--steps", str(TRAIN_STEPS), "--save-every", str(k), "--log-every", "1"]
    rc, full_launches, _ = counted(lambda: train.main(base + ["--checkpoint-dir", str(full)]))
    require(rc == 0, f"checkpoint {arch}: the uninterrupted run returned {rc}")
    want = _expected_train_launches(cfg, TRAIN_STEPS)
    require(full_launches == want, f"checkpoint {arch}: launches {full_launches} != {want}")

    # Step k as a gate-major binary wrote it: the port's converter over the
    # restored state, saved by the port's manager, no cell_layout.
    target = init_train_state(torch.Generator(device="cuda").manual_seed(1), cfg, device="cuda")
    t0 = time.perf_counter()
    state, data_state = CheckpointManager(str(full)).restore(k, target)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    CheckpointManager(str(legacy)).save(k, layout.tree_to_gate_major(state), data_state)
    save_s = time.perf_counter() - t0
    _drop_cell_layout(legacy / f"step_{k}")
    lane, gate = _manifest_shapes(full / f"step_{k}"), _manifest_shapes(legacy / f"step_{k}")
    converted = sorted(p for p in lane if lane[p] != gate[p])
    require(converted and lane.keys() == gate.keys(),
            f"checkpoint {arch}: the gate-major step converts {converted}")
    t0 = time.perf_counter()
    migrated, migrated_data = CheckpointManager(str(legacy)).restore(k, target)
    torch.cuda.synchronize()
    restore_gate_major_s = time.perf_counter() - t0
    require(migrated_data == data_state and _same_bits(migrated, state),
            f"checkpoint {arch}: the restore-time migration changed the state")
    del state, migrated, target
    _release()

    # The tool's persisted migration of a copy gives the lane-major files.
    shutil.copytree(legacy / f"step_{k}", tool / f"step_{k}")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rc = migrate_checkpoint.main([str(tool)])
    migrate_s = time.perf_counter() - t0
    require(rc == 0 and f"migrated {len(converted)} leaves" in out.getvalue(),
            f"checkpoint {arch}: the migration tool said {out.getvalue()!r}")
    mine, theirs = _dir_snapshot(tool / f"step_{k}"), _dir_snapshot(full / f"step_{k}")
    require(mine.keys() == theirs.keys()
            and all(mine[f] == theirs[f] for f in mine if f != "MANIFEST.json")
            and json.loads((tool / f"step_{k}" / "MANIFEST.json").read_text())
            == json.loads((full / f"step_{k}" / "MANIFEST.json").read_text()),
            f"checkpoint {arch}: the migrated step's files differ from the lane-major step's")

    t0 = time.perf_counter()
    rc, launches, _ = counted(lambda: train.main(base + ["--checkpoint-dir", str(legacy),
                                                         "--resume", "auto"]))
    resume_run_s = time.perf_counter() - t0
    require(rc == 0, f"checkpoint {arch}: the resumed run returned {rc}")
    want = _expected_train_launches(cfg, TRAIN_STEPS - k)
    require(launches == want, f"checkpoint {arch}: resumed launches {launches} != {want}")
    diff = _max_leaf_diff(_step_leaves(full / f"step_{TRAIN_STEPS}"),
                          _step_leaves(legacy / f"step_{TRAIN_STEPS}"))
    require(diff == 0.0, f"checkpoint {arch}: the gate-major resume ends {diff} away")
    return {"phase": "checkpoint", "part": "gate-major resume", "arch": arch,
            "resume_from_step": k, "steps": TRAIN_STEPS,
            "checkpoint_bytes": _dir_bytes(full / f"step_{k}"),
            "gate_major_checkpoint_bytes": _dir_bytes(legacy / f"step_{k}"),
            "leaves": len(lane), "leaves_converted": len(converted),
            "restore_s": restore_s, "gate_major_save_s": save_s,
            "restore_gate_major_s": restore_gate_major_s, "migrate_tool_s": migrate_s,
            "resumed_run_s": resume_run_s, "max_abs_param_diff": diff,
            "launches": {n: c for n, c in launches.items() if c},
            "uninterrupted_launches": {n: c for n, c in full_launches.items() if c}}


def _checkpoint_quantize(counted):
    """Part (b); returns its lines."""
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.kernels.fused_rnn import layout
    from repro_torch.launch import migrate_checkpoint, serve
    from repro_torch.models import lm
    from repro_torch.models.layers import _dtype

    qdir, device = CKPT_DIR / "quantize", torch.device("cuda")
    steps = list(enumerate(CKPT_QUANT_ARCHS, 1))
    fp_bytes = {}
    for step, arch in steps:  # serve.main's seed, 0; the fp32 masters
        fp_cfg = _run_cfg(arch, None).with_(weight_quant="none")
        params = lm.lm_init(torch.Generator(device=device).manual_seed(0), fp_cfg, device=device)
        CheckpointManager(str(qdir)).save(step, layout.tree_to_gate_major(params))
        _drop_cell_layout(qdir / f"step_{step}")
        fp_bytes[arch] = _dir_bytes(qdir / f"step_{step}")
        del params
    fp_shapes = {step: _manifest_shapes(qdir / f"step_{step}") for step, _ in steps}
    before = _dir_snapshot(qdir)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rc = migrate_checkpoint.main([str(qdir), "--quantize", "int8", "--dry-run"])
    require(rc == 0 and out.getvalue().count("would quantize") == len(steps)
            and _dir_snapshot(qdir) == before,
            f"checkpoint: --dry-run changed the directory or said {out.getvalue()!r}")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.migrate_checkpoint", str(qdir),
         "--quantize", "int8"], capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    quantize_s = time.perf_counter() - t0
    slabs = {arch: 2 if _run_cfg(arch, None).cell == "qrnn" else 1 for _, arch in steps}
    want_lines = [f"{qdir}/step_{step}: quantized {slabs[arch]} slab leaves to int8"
                  for step, arch in steps]
    require(proc.returncode == 0 and proc.stdout.splitlines() == want_lines,
            f"checkpoint: the quantization tool returned {proc.returncode}: "
            f"{proc.stdout!r} {proc.stderr[-2000:]!r}")
    quantized = _dir_snapshot(qdir)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rc = migrate_checkpoint.main([str(qdir), "--quantize", "int8"])
    require(rc == 0 and out.getvalue().count("already weight_quant=int8, skipping") == len(steps)
            and _dir_snapshot(qdir) == quantized,
            f"checkpoint: a second quantization run said {out.getvalue()!r}")

    lines = []
    for step, arch in steps:
        cfg = _run_cfg(arch, None)
        want = lm.lm_init(torch.Generator(device=device).manual_seed(0), cfg, device=device)
        t0 = time.perf_counter()
        restored, _ = CheckpointManager(str(qdir)).restore(step, want)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        require(_same_bits(restored, want),
                f"checkpoint {arch}: the quantized checkpoint != lm_init's int8 params")
        compute = _dtype(cfg.compute_dtype)
        served = lm.lm_init(torch.Generator(device=device).manual_seed(0), cfg, device=device,
                            dtype=compute)  # what serve.main serves
        restored = layout.cast_params(restored, compute)
        require(_same_bits(restored, served), f"checkpoint {arch}: cast params differ")
        args = serve.parse_args(["--arch", arch, "--batch", "4", "--prompt-len", "64",
                                 "--gen-len", str(CKPT_GEN_LEN)])
        want_launches = _expected_launches(cfg, CKPT_GEN_LEN - 1)
        tokens, launches = {}, {}
        for what, params, graphs in (("lm_init captured", served, True),
                                     ("restored eager", restored, False),
                                     ("restored captured", restored, True)):
            stats, launches[what], _ = counted(
                lambda: serve.run_batch(cfg, params, args, device, graphs=graphs))
            require(launches[what] == want_launches and stats["cache_in_place"],
                    f"checkpoint {arch} {what}: launches {launches[what]} != {want_launches} "
                    f"or the caches moved")
            tokens[what] = stats["tokens"]
        require(all(t == tokens["lm_init captured"] for t in tokens.values()),
                f"checkpoint {arch}: the restored params serve other tokens")
        shapes = _manifest_shapes(qdir / f"step_{step}")
        lines.append({
            "phase": "checkpoint", "part": "quantize and serve", "arch": arch,
            "fp_checkpoint_bytes": fp_bytes[arch],
            "int8_checkpoint_bytes": _dir_bytes(qdir / f"step_{step}"),
            "slab_leaves_quantized": slabs[arch],
            "gate_major_leaves_migrated": sum(
                1 for p, sh in shapes.items() if p in fp_shapes[step] and fp_shapes[step][p] != sh),
            "quantize_subprocess_s": quantize_s, "restore_s": restore_s,
            "bitwise_lm_init": True, "sample_tokens": tokens["restored captured"][0][:8],
            "launches": {w: {n: c for n, c in ls.items() if c} for w, ls in launches.items()}})
        del want, restored, served, params
        _release()
    return lines


def phase_checkpoint():
    """Legacy gate-major checkpoints and the migration tool on the card:
    (a) per CKPT_RESUME_ARCHS, ``launch.train.main`` for TRAIN_STEPS steps
    saved half way; that step restored, rewritten gate-major (the port's
    ``tree_to_gate_major``, the port's manager, no ``cell_layout``), restored
    again with the migration (the same bits), migrated by the tool in a copy
    (the lane-major step's files again), and resumed with ``--resume auto``:
    the final leaves must equal the uninterrupted run's exactly, with the
    expected B2/B3 launches. (b) fp params of CKPT_QUANT_ARCHS saved
    gate-major, quantized by ``python -m repro_torch.launch.migrate_checkpoint
    DIR --quantize int8`` as a subprocess on the card (after a ``--dry-run``
    that must change no byte; a second run must skip), restored bitwise equal
    to ``lm_init`` of the int8 config, and served through ``serve.run_batch``
    eager and captured with ``lm_init``'s tokens and the B2/B1 int8 launches.
    Every kernel's count is set to 0 just before each run and read just
    after. Returns the launches."""
    counters = _launch_counters()
    totals = dict.fromkeys(KERNELS, 0)

    def counted(call):
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        with contextlib.redirect_stdout(io.StringIO()) as out:
            result = call()
        launches = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
        for k, n in launches.items():
            totals[k] += n
        return result, launches, out.getvalue()

    if CKPT_DIR.exists():
        shutil.rmtree(CKPT_DIR)
    CKPT_DIR.mkdir(parents=True)
    for arch in CKPT_RESUME_ARCHS:
        emit(_checkpoint_resume(arch, counted))
    for line in _checkpoint_quantize(counted):
        emit(line)
    emit({"phase": "checkpoint", "launches": totals})
    return totals


def _shard_case(name, mode, T, B, H, k, i, dtype_name, seed, quant=False, slabs=None):
    """One model shard's B1 call: the whole layer's operands (``_layer_case``,
    d = H) sliced to shard ``i`` of ``k`` as ``distribution/fused_sharded.py``
    slices them: the slab's lanes, the biases and carry, the shard's lane
    slice of the input as the skip, and for int8 the scale blocks its lanes
    touch with ``scale_lane0``; ``slabs``: the fp slabs' dtype, if not the
    IO's."""
    import torch

    from repro_torch.distribution import fused_sharded

    _, (u, taps, b3, c0), kw, _, _ = _layer_case(name, mode, T, B, H, H, dtype_name, seed,
                                                 quant=quant)
    Hl = H // k
    own = slice(i * Hl, (i + 1) * Hl)
    taps = tuple(t[..., own].to(slabs or t.dtype).contiguous() for t in taps)
    b3, c0 = b3[:, own].contiguous(), c0[:, own].contiguous()
    if mode == "sru_identity":
        kw["skip"] = u[..., own].contiguous()
    if quant:
        kw["scale"], kw["scale_lane0"] = fused_sharded._scale_shard(kw["scale"], i * Hl, Hl)
    ops = 2.0 * T * B * H * len(taps) * 3 * Hl
    out_bytes = (T * B * Hl + B * Hl) * u.element_size()
    rw = nbytes(u, *taps, b3, c0, kw.get("tail"), kw.get("skip"), kw.get("scale")) + out_bytes
    return name, (u, taps, b3, c0), kw, rw, ops


def shard_cases():
    """``(dtype, T, name, args, kw, rw, ops)`` of B1 at the shard shapes
    (SHARD_CASES, SHARD_MIXED_CASES, B = 4), keyed by kernel family, with
    each case's launches per rank in the (1, 2) serving runs
    (``_served_launches``)."""
    import torch

    cases = {"fused_rnn_layer": [], "fused_rnn_layer_int8": []}
    served = {}
    seed = 600
    for mode, H, k, i, quant in SHARD_CASES:
        for T in (64, 1):
            for dtype in ("bfloat16", "float32"):
                seed += 1
                name = (f"{'int8 ' if quant else ''}{mode} shard {i} Hl={H // k} of {H} T={T} "
                        f"{dtype}")
                cases["fused_rnn_layer" + ("_int8" if quant else "")].append(
                    (dtype, T) + _shard_case(name, mode, T, 4, H, k, i, dtype, seed, quant=quant))
                served[name] = _served_launches(mode, H, H // k, T, dtype, quant)
    for mode, H, k, i in SHARD_MIXED_CASES:
        for T in (64, 1):
            seed += 1
            name = f"{mode} shard {i} Hl={H // k} of {H} T={T} float32, bfloat16 slabs"
            cases["fused_rnn_layer"].append(
                ("float32", T) + _shard_case(name, mode, T, 4, H, k, i, "float32", seed,
                                             slabs=torch.bfloat16))
            served[name] = _served_launches(mode, H, H // k, T, "float32", False, bf16_slabs=True)
    return cases, served


def _served_launches(mode, H, Hl, T, dtype, quant, bf16_slabs=False) -> int:
    """A rank's launches at this shape in the (1, 2) serving runs (T = 64
    the prefill, T = 1 the 31 decode steps): SHARDED_RUNS under fp32
    compute, and SHARDED_BF16_RUN under bf16, whose barrier runs B1 in fp32
    IO on bf16 slabs. The ring schedule launches no B1."""
    n = 0
    for arch, compute in _sharded_runs():
        cfg = _sharded_cfg(_sharded_args(arch, 2), compute)
        ring = cfg.scan_engine == "fused_stack" and cfg.fuse_depth and cfg.ring_overlap
        cell_mode = {"sru": "sru_identity", "qrnn": "qrnn"}[cfg.cell]
        mixed = compute == "bfloat16" and cfg.scan_engine == "fused_stack"
        io = "float32" if mixed else compute
        if (not ring and dtype == io and mixed == bf16_slabs and cfg.rnn_hidden == H
                and H // 2 == Hl and (cfg.weight_quant == "int8") == quant
                and cell_mode == mode):
            n += cfg.n_layers * (1 if T == 64 else 31)
    return n


def _sharded_runs():
    """(arch, compute dtype) of the (1, 2) serving runs."""
    return [(a, "float32") for a in SHARDED_RUNS] + [(SHARDED_BF16_RUN, "bfloat16")]


def _run_key(arch, compute):
    return arch if compute == "float32" else f"{arch} {compute}"


def _sharded_args(arch, k, batch=4, gen=32):
    from repro_torch.launch import serve

    return serve.parse_args(["--arch", arch, "--batch", str(batch), "--prompt-len", "64",
                             "--gen-len", str(gen), "--model-shards", str(k),
                             "--dist-backend", "gloo"])


def _sharded_cfg(args, compute="float32"):
    from repro_torch.launch import serve

    return serve.config_of(args).with_(compute_dtype=compute)


def _logit_inputs(cfg):
    """Teacher-forced tokens: a 64-token prompt and SHARDED_LOGIT_STEPS more."""
    import torch

    g = torch.Generator().manual_seed(1)
    return torch.randint(0, cfg.vocab, (4, 64 + SHARDED_LOGIT_STEPS), generator=g)


def _split_steps(cfg, params, mesh, device, toks):
    """A sharded decode step split on the host clock, after a prefill over
    the 64-token prompt: SHARDED_SPLIT_STEPS greedy steps as served (ms a
    step), then as many inside ``launch/mesh.py::timed_collectives``, where
    each collective first waits for the card: ms a step in each collective,
    by name, and the rest (the kernels and GEMMs, their launches, the host
    work)."""
    import torch

    from repro_torch.launch.mesh import timed_collectives
    from repro_torch.training.steps import build_decode_step, build_prefill_step

    toks = toks.to(device)
    prefill = build_prefill_step(cfg, mesh, batch=toks.shape[0], max_len=toks.shape[1],
                                 device=device)
    decode = build_decode_step(cfg, mesh, max_len=toks.shape[1])
    logits, caches = prefill(params, {"inputs": toks[:, :64]})

    def steps():
        nonlocal logits, caches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SHARDED_SPLIT_STEPS):
            tok = torch.argmax(logits[:, -1, :cfg.vocab], dim=-1)[:, None]
            logits, caches = decode(params, caches, tok)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / SHARDED_SPLIT_STEPS

    steps()  # warm-up
    step_ms = steps()
    with timed_collectives(mesh) as clock:
        timed_ms = steps()
    coll = {k: v * 1e3 / SHARDED_SPLIT_STEPS for k, v in sorted(clock.items())}
    return {"step_ms": step_ms, "timed_step_ms": timed_ms, "collective_ms": coll,
            "rest_ms": timed_ms - sum(coll.values())}


def _step_logits(cfg, params, mesh, device, toks):
    """Every step's logits of a prefill over the prompt and
    SHARDED_LOGIT_STEPS decode steps (this rank's rows under a mesh)."""
    import torch

    from repro_torch.training.steps import build_decode_step, build_prefill_step

    toks = toks.to(device)
    prefill = build_prefill_step(cfg, mesh, batch=4, max_len=toks.shape[1], device=device)
    decode = build_decode_step(cfg, mesh, max_len=toks.shape[1])
    logits, caches = prefill(params, {"inputs": toks[:, :64]})
    out = [logits]
    for t in range(64, toks.shape[1]):
        logits, caches = decode(params, caches, toks[:, t:t + 1])
        out.append(logits)
    return torch.stack(out).cpu()


def _cont_args(run, k):
    """The serve flags of continuous run ``run`` of SHARDED_CONT_RUNS on
    ``k`` model ranks."""
    from repro_torch.launch import serve

    arch, trace, oracle = SHARDED_CONT_RUNS[run]
    flags = ["--arch", arch, "--mode", "continuous", "--batch", "4", "--chunk", "32",
             "--requests", str(SHARDED_CONT_REQUESTS), "--prompt-len", "32", "--gen-len",
             str(SHARDED_CONT_GEN), "--model-shards", str(k), "--dist-backend", "gloo"]
    if trace == "prefix":
        flags += ["--prefix-cache-mb", "64", "--async-depth", "2"]
    if oracle:
        flags += ["--speculative", "--spec-k", "4"]
    return serve.parse_args(flags)


def _cont_trace(cfg, run):
    """The requests of continuous run ``run``, made from seed 0."""
    from repro_torch.serving import poisson_trace, shared_prefix_trace

    mix = ((SHARDED_CONT_GEN, 1.0),)
    if SHARDED_CONT_RUNS[run][1] == "prefix":
        return shared_prefix_trace(SHARDED_CONT_REQUESTS, rate=0.0, prefix_len=64, prompt_len=80,
                                   share=1.0, gen_mix=mix, vocab=cfg.vocab, seed=0)
    return poisson_trace(SHARDED_CONT_REQUESTS, rate=0.0, prompt_lens=(32,), gen_mix=mix,
                         vocab=cfg.vocab, seed=0)


def _cont_single(run):
    """Continuous run ``run`` on the card alone, eager: the reference."""
    import torch

    from repro_torch.launch import serve
    from repro_torch.models import lm

    args = _cont_args(run, 1)
    cfg = _sharded_cfg(args)
    dev = torch.device("cuda")
    params = lm.lm_init(torch.Generator(device=dev).manual_seed(args.seed), cfg, device=dev,
                        dtype=torch.float32)
    oracle = SHARDED_CONT_RUNS[run][2]
    with contextlib.redirect_stdout(io.StringIO()):
        return serve.run_continuous(cfg, params, args, dev, graphs=False,
                                    draft_cfg=cfg if oracle else None,
                                    draft_params=params if oracle else None,
                                    trace=_cont_trace(cfg, run))


def _cont_rank(run, model_axis, device, counters, split):
    """One rank of continuous run ``run`` through ``serve.serve_mesh`` (the
    counts set to 0 just before and read just after), then, with ``split``,
    the same run inside ``timed_collectives``: the collectives' ms."""
    import torch

    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_local_mesh, timed_collectives
    from repro_torch.models import lm

    t0 = time.perf_counter()
    args = _cont_args(run, model_axis)
    cfg = _sharded_cfg(args)
    draft = None
    if SHARDED_CONT_RUNS[run][2]:  # the oracle: the target's params, whole
        draft = cfg, lm.lm_init(torch.Generator(device=device).manual_seed(args.seed), cfg,
                                device=device, dtype=torch.float32)
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        stats = serve.serve_mesh(cfg, args, trace=_cont_trace(cfg, run), draft=draft)
    launches = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
    del draft
    timed = None
    if split:
        mesh = make_local_mesh(model_axis, device=device)
        params = lm.lm_init(torch.Generator(device=device).manual_seed(args.seed), cfg,
                            device=device, dtype=torch.float32)
        params, _ = serve.shard_params(cfg, params, mesh)
        with timed_collectives(mesh) as clock, contextlib.redirect_stdout(io.StringIO()):
            rep = serve.run_continuous(cfg, params, args, device, trace=_cont_trace(cfg, run),
                                       mesh=mesh)
        ticks = max(rep["ticks"], 1)
        coll = {k: v * 1e3 / ticks for k, v in sorted(clock.items())}
        timed = {"tick_ms": rep["busy_s"] * 1e3 / ticks, "collective_ms": coll,
                 "collective_share": sum(coll.values()) / (rep["busy_s"] * 1e3 / ticks)}
        del params
    torch.cuda.empty_cache()
    return {"stats": stats, "launches": launches, "timed": timed,
            "seconds": time.perf_counter() - t0,
            "lines": [x for x in buf.getvalue().splitlines()
                      if not x.startswith("continuous-stats ")][:4]}


def _lm_runs(part=None):
    """(part, result key, name, arch, layers kept, config overrides) of
    SHARDED_LM_RUNS (part "h") and SHARDED_MOE_LM_RUNS ("i"), or of one
    part."""
    runs = ([("h", f"lm {arch}", arch, arch, layers, {}) for arch, layers in SHARDED_LM_RUNS]
            + [("i", f"lm {name}", name, arch, 1, over) for name, arch, over in
               SHARDED_MOE_LM_RUNS])
    return [r for r in runs if part in (None, r[0])]


def _lm_cfg(arch, k, layers=None, over=None):
    """(g), (h), (i): the serve flags of ``arch`` on ``k`` model ranks and
    its fp32 config, cut to ``layers`` when given, with ``over``'s fields."""
    args = _sharded_args(arch, k, gen=SHARDED_TP_GEN)
    cfg = _sharded_cfg(args).with_(**(over or {}))
    return args, (cfg if layers is None else cfg.with_(n_layers=layers))


def _tp_rank(arch, model_axis, device, counters, layers=None, over=None):
    """(g), (h), (i) One rank of ``arch`` (SHARDED_TP_RUNS on its own engine,
    or SHARDED_LM_RUNS / SHARDED_MOE_LM_RUNS cut to ``layers``, with
    ``over``'s fields): the serve through
    ``serve.serve_mesh`` (every count set to 0 just before, read just
    after), then its teacher-forced logits and a decode step split into the
    collectives and the rest."""
    import torch

    from repro_torch.distribution import sharding as shd
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import lm

    t0 = time.perf_counter()
    args, cfg = _lm_cfg(arch, model_axis, layers, over)
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        stats = serve.serve_mesh(cfg, args)
    launches = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
    mesh = make_local_mesh(model_axis, device=device)
    params = lm.lm_init(torch.Generator(device=device).manual_seed(args.seed), cfg,
                        device=device, dtype=torch.float32)
    params, _ = serve.shard_params(cfg, params, mesh)
    toks = _logit_inputs(cfg)
    toks = shd.local_shard(toks, shd.batch_specs({"t": toks}, mesh)["t"], mesh)
    logits = _step_logits(cfg, params, mesh, device, toks)
    split = _split_steps(cfg, params, mesh, device, toks)
    del params
    return {"stats": stats, "launches": launches, "logits": logits, "split": split,
            "seconds": time.perf_counter() - t0,
            "lines": [x for x in buf.getvalue().splitlines() if not x.startswith("serve-stats ")]}


def _sharded_tp(single, ref_logits, ranks, totals):
    """(g): each of SHARDED_TP_RUNS on the (1, 2) ranks against the
    single-device run: the tokens equal, the logits within SHARDED_TOL, the
    ranks alike, half the slab and vocab bytes a model rank, no launch of
    our kernels (the chunked engine and the LSTM are plain PyTorch). Emits a
    line each; returns the part's seconds on the ranks."""
    gloo = "gloo ranks sharing one card: the times are not multi-GPU speed"
    seconds = 0.0
    for arch in SHARDED_TP_RUNS:
        key = f"tp {arch}"
        mine = [r[key] for r in ranks]
        st = mine[0]["stats"]
        cfg = _sharded_cfg(_sharded_args(arch, 2, gen=SHARDED_TP_GEN))
        diff = (mine[0]["logits"] - ref_logits[arch]).abs().max().item()
        seconds += max(m["seconds"] for m in mine)
        split = [m["split"] for m in mine]
        emit({"phase": "sharded", "tp": arch, "engine": cfg.scan_engine, "cell": cfg.cell,
              "mesh": st["mesh"], "compute": cfg.compute_dtype,
              "tokens_equal": st["tokens"] == single[arch]["tokens"],
              "logits_max_abs_diff": diff, "tol": SHARDED_TOL,
              "launches_per_rank": [{n: c for n, c in m["launches"].items() if c} for m in mine],
              "slab_bytes": st["slab_bytes"], "slab_bytes_whole": st["slab_bytes_whole"],
              "vocab_bytes": st["vocab_bytes"], "vocab_bytes_whole": st["vocab_bytes_whole"],
              "prefill_ms": [m["stats"]["prefill_ms"] for m in mine],
              "decode_ms_per_step": [m["stats"]["decode_ms"] / m["stats"]["decode_steps"]
                                     for m in mine],
              "single_prefill_ms": single[arch]["prefill_ms"],
              "single_decode_ms_per_step": (single[arch]["decode_ms"]
                                            / single[arch]["decode_steps"]),
              "split_per_rank": split,
              "collective_share_per_rank": [sum(x["collective_ms"].values()) / x["timed_step_ms"]
                                            for x in split],
              "seconds_per_rank": [m["seconds"] for m in mine], "note": gloo,
              "lines": mine[0]["lines"]})
        require(st["tokens"] == single[arch]["tokens"],
                f"sharded tp {arch}: tokens differ from the single-device run's")
        require(all(m["stats"]["tokens"] == st["tokens"] for m in mine),
                f"sharded tp {arch}: the ranks' tokens differ")
        require(diff <= SHARDED_TOL, f"sharded tp {arch}: logits differ by {diff}")
        for field in ("slab_bytes", "vocab_bytes"):
            require(st[field] == [st[f"{field}_whole"] // 2] * 2 and st[field][0] > 0,
                    f"sharded tp {arch}: {field} {st[field]} of {st[f'{field}_whole']}")
        for m in mine:
            require(not any(m["launches"].values()),
                    f"sharded tp {arch}: launches {m['launches']} on a plain path")
            for n, c in m["launches"].items():
                totals[n] += c
    emit({"phase": "sharded", "tp_seconds": seconds})
    return seconds


def _expected_lm_launches(cfg, k: int, decode_steps: int) -> dict:
    """(h) One rank's launches: the single device's (B4 a layer a call, B5 a
    layer (a hybrid: a shared block's application) a decode step), B5 in its
    log-sum-exp form where the KV heads do not divide the model axis."""
    want = _expected_launches(cfg, decode_steps)
    if cfg.n_kv_heads and cfg.n_kv_heads % k:
        want["gqa_decode_lse"], want["gqa_decode"] = want["gqa_decode"], 0
    return want


def _sharded_lm(single, ref_logits, ranks, totals, part):
    """(h), (i): each run of ``part`` (``_lm_runs``) on the (1, 2) ranks
    against the single-device run: the tokens equal, the logits within
    SHARDED_TOL, the ranks alike, each rank's attention/MLP/Mamba leaf
    bytes at most SHARDED_LM_BYTES of the whole, half the vocab bytes and,
    for an MoE LM, SHARDED_MOE_SHARE of the expert bytes (within
    SHARDED_MOE_SHARE_TOL), each rank's launches the expected. Emits a line
    each; returns the part's seconds on the ranks."""
    from repro_torch.distribution import fused_sharded
    from repro_torch.launch.mesh import Mesh

    gloo = "gloo ranks sharing one card: the times are not multi-GPU speed"
    seconds = 0.0
    for _, key, name, arch, layers, over in _lm_runs(part):
        mine = [r[key] for r in ranks]
        st = mine[0]["stats"]
        _, cfg = _lm_cfg(arch, 2, layers, over)
        want = _expected_lm_launches(cfg, 2, st["decode_steps"])
        diff = (mine[0]["logits"] - ref_logits[key]).abs().max().item()
        seconds += max(m["seconds"] for m in mine)
        split = [m["split"] for m in mine]
        line = {"phase": "sharded", "part": part, "lm": name, "arch": arch, "overrides": over,
                "layers": layers, "mesh": st["mesh"], "compute": cfg.compute_dtype,
                "kv_cache": (None if not cfg.n_kv_heads else "heads" if cfg.n_kv_heads % 2 == 0
                             else "sequence"),
                "tokens_equal": st["tokens"] == single[key]["tokens"],
                "logits_max_abs_diff": diff, "tol": SHARDED_TOL,
                "launches_per_rank": [{n: c for n, c in m["launches"].items() if c}
                                      for m in mine],
                "launches_expected": {n: c for n, c in want.items() if c},
                "block_bytes": st["block_bytes"], "block_bytes_whole": st["block_bytes_whole"],
                "block_share": [b / st["block_bytes_whole"] for b in st["block_bytes"]],
                "vocab_bytes": st["vocab_bytes"], "vocab_bytes_whole": st["vocab_bytes_whole"],
                "replicated": st["replicated"],
                "prefill_ms": [m["stats"]["prefill_ms"] for m in mine],
                "decode_ms_per_step": [m["stats"]["decode_ms"] / m["stats"]["decode_steps"]
                                       for m in mine],
                "single_prefill_ms": single[key]["prefill_ms"],
                "single_decode_ms_per_step": (single[key]["decode_ms"]
                                              / single[key]["decode_steps"]),
                "split_per_rank": split,
                "collective_share_per_rank": [sum(x["collective_ms"].values())
                                              / x["timed_step_ms"] for x in split],
                "peak_mem_gb_per_rank": [m["stats"]["peak_mem_gb"] for m in mine],
                "seconds_per_rank": [m["seconds"] for m in mine], "note": gloo,
                "lines": mine[0]["lines"]}
        if cfg.moe:
            line.update(schedule=cfg.moe_impl, n_experts=cfg.n_experts,
                        experts_layout=fused_sharded.moe_layout(cfg, Mesh(st["mesh"])),
                        expert_bytes=st["expert_bytes"],
                        expert_bytes_whole=st["expert_bytes_whole"],
                        expert_share=[b / st["expert_bytes_whole"] for b in st["expert_bytes"]])
        emit(line)
        require(st["tokens"] == single[key]["tokens"],
                f"sharded lm {name}: tokens differ from the single-device run's")
        require(all(m["stats"]["tokens"] == st["tokens"] for m in mine),
                f"sharded lm {name}: the ranks' tokens differ")
        require(diff <= SHARDED_TOL, f"sharded lm {name}: logits differ by {diff}")
        require(all(0 < b <= SHARDED_LM_BYTES * st["block_bytes_whole"]
                    for b in st["block_bytes"]),
                f"sharded lm {name}: block bytes {st['block_bytes']} of "
                f"{st['block_bytes_whole']}")
        require(st["vocab_bytes"] == [st["vocab_bytes_whole"] // 2] * 2,
                f"sharded lm {name}: vocab bytes {st['vocab_bytes']}")
        require(not cfg.moe or all(abs(x - SHARDED_MOE_SHARE) <= SHARDED_MOE_SHARE_TOL
                                   for x in line["expert_share"]),
                f"sharded lm {name}: expert bytes {st['expert_bytes']} of "
                f"{st['expert_bytes_whole']}")
        for m in mine:
            require(m["launches"] == want,
                    f"sharded lm {name}: launches {m['launches']} != {want}")
            for n, c in m["launches"].items():
                totals[n] += c
    emit({"phase": "sharded", "part": part, "lm_seconds": seconds})
    return seconds


def _moe_setup(arch, device):
    """One full-width MoE layer of ``arch`` under the expert-parallel
    schedule: its config, params and a (4, 64, d) input, all from seeds on
    ``device``."""
    import torch

    from repro_torch.models import moe

    cfg = _run_cfg(arch, None).with_(n_layers=1, moe_impl="shard_map")
    params = moe.moe_init(torch.Generator(device=device).manual_seed(5), cfg, torch.float32,
                          device)
    x = torch.randn((4, 64, cfg.d_model), generator=torch.Generator(device=device).manual_seed(6),
                    device=device)
    return cfg, params, x


def _sharded_worker(rank, world, model_axis, init_file, plan):
    """A gloo rank on the one card: every serve run of ``plan`` through
    ``serve.serve_mesh`` (counts set to 0 just before, read just after) and
    its teacher-forced logits, then the MoE layers; its results to a pickle
    in SHARDED_DIR."""
    import pickle

    import torch
    import torch.distributed as dist

    from repro_torch.distribution import fused_sharded as fs
    from repro_torch.distribution import sharding as shd
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import GROUP_TIMEOUT, make_local_mesh
    from repro_torch.models import lm, moe
    from repro_torch.models.lm import _dtype

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=world,
                            timeout=GROUP_TIMEOUT)
    device = torch.device("cuda", 0)
    counters = _launch_counters()
    results = {}
    try:
        for arch, compute in plan["serve"]:
            args = _sharded_args(arch, model_axis)
            cfg = _sharded_cfg(args, compute)
            for mod, attr in counters.values():
                setattr(mod, attr, 0)
            with contextlib.redirect_stdout(io.StringIO()) as buf:
                stats = serve.serve_mesh(cfg, args)
            launches = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
            mesh = make_local_mesh(model_axis, device=device)
            params = lm.lm_init(torch.Generator(device=device).manual_seed(args.seed), cfg,
                                device=device, dtype=_dtype(compute))
            params, _ = serve.shard_params(cfg, params, mesh)
            toks = _logit_inputs(cfg)
            toks = shd.local_shard(toks, shd.batch_specs({"t": toks}, mesh)["t"], mesh)
            logits = _step_logits(cfg, params, mesh, device, toks) if plan["logits"] else None
            split = (_split_steps(cfg, params, mesh, device, toks)
                     if compute == "float32" and arch in plan["split"] else None)
            results[_run_key(arch, compute)] = {
                "stats": stats, "launches": launches, "logits": logits, "split": split,
                "lines": [x for x in buf.getvalue().splitlines()
                          if not x.startswith("serve-stats ")]}
            del params
            torch.cuda.empty_cache()
        for arch in plan["moe"]:
            cfg, whole, x = _moe_setup(arch, device)
            mesh = make_local_mesh(model_axis, device=device)
            specs = fs.rank_specs(cfg, shd.param_specs(whole, mesh), mesh)
            params = shd.map_with_paths(lambda p, t: shd.local_shard(t, shd._at(specs, p), mesh),
                                        whole)
            del whole
            torch.cuda.empty_cache()
            with shd.use_rules(mesh):
                y = moe.moe_apply(params, cfg, x)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(3):
                    moe.moe_apply(params, cfg, x)
                torch.cuda.synchronize()
            results[arch] = {"y": y.cpu(), "ms": (time.perf_counter() - t0) / 3 * 1e3,
                             "experts": params["e_up"].shape[0]}
            del params, x, y
            torch.cuda.empty_cache()
        for arch in plan.get("tp", ()):
            results[f"tp {arch}"] = _tp_rank(arch, model_axis, device, counters)
            torch.cuda.empty_cache()
        for _, key, _, arch, layers, over in plan.get("lm", ()):
            results[key] = _tp_rank(arch, model_axis, device, counters, layers, over)
            torch.cuda.empty_cache()
        for run in plan.get("continuous", ()):
            results[f"continuous {run}"] = _cont_rank(run, model_axis, device, counters,
                                                      run in SHARDED_CONT_SPLIT)
        for arch, engine, model_k, fsdp, over in plan.get("train", ()):
            results[f"train {arch}"] = _sharded_train_rank(arch, engine, model_k, fsdp, over,
                                                           device, counters,
                                                           keep_params=rank == 0)
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    with open(SHARDED_DIR / f"{plan['name']}-rank{rank}.pkl", "wb") as f:
        pickle.dump(results, f)


def _spawn_ranks(name, world, model_axis, plan):
    """Start ``world`` gloo ranks of ``_sharded_worker`` on the card (a
    ``file://`` rendezvous), wait for them; returns each rank's results."""
    import pickle

    import torch.multiprocessing as mp

    plan = dict(plan, name=name)
    rdv = SHARDED_DIR / f"{name}.rdv"
    mp.start_processes(_sharded_worker, args=(world, model_axis, str(rdv), plan), nprocs=world,
                       start_method="spawn")
    out = []
    for r in range(world):
        with open(SHARDED_DIR / f"{name}-rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _expected_sharded_launches(cfg, decode_steps: int) -> dict:
    """One rank's launches over a sharded serve: the barrier stack and the
    fused layer run B1 per layer per call (int8: its int8 instance); the
    ring schedule's recurrence runs B3 per layer per call (its gate GEMM is
    the ring's chunk GEMMs)."""
    want = dict.fromkeys(KERNELS, 0)
    if cfg.scan_engine == "fused_stack" and cfg.fuse_depth and cfg.ring_overlap:
        want["linear_scan"] = cfg.n_layers * (1 + decode_steps)
    else:
        q = "_int8" if cfg.weight_quant == "int8" else ""
        want["fused_rnn_layer" + q] = cfg.n_layers * (1 + decode_steps)
    return want


def _sharded_continuous(single, m2, d2m2, ref_s, totals):
    """(f): each continuous run on (1, 2) (``m2``, the ranks' results) and
    SHARDED_CONT_DATA_RUNS on (2, 2) (``d2m2``) against the single-device
    eager run (``single``): every request's tokens, the prefix hits and
    rollbacks, each rank's launches of each kernel, its pool carry's shape
    (L, B/D, H/k), the pools in place, and the ranks' admissions alike. Adds
    the launches to ``totals``; returns the part's seconds."""
    gloo = "gloo ranks sharing one card: the times are not multi-GPU speed"
    seconds = ref_s
    for ranks, runs in ((m2, SHARDED_CONT_RUNS), (d2m2, SHARDED_CONT_DATA_RUNS)):
        seconds += sum(max(r[f"continuous {run}"]["seconds"] for r in ranks) for run in runs)
        for run in runs:
            key, ref = f"continuous {run}", single[run]
            mine = [r[key] for r in ranks]
            st = mine[0]["stats"]
            D, k = st["mesh"]["data"], st["mesh"]["model"]
            what = f"sharded continuous {run} on ({D}, {k})"
            cfg = _sharded_cfg(_cont_args(run, k))
            steps = (st["prefill_chunks"] + st["decode_steps"] + st["verify_steps"]
                     + (st["prefill_chunks"] + st["draft_steps"] if SHARDED_CONT_RUNS[run][2]
                        else 0))
            want = _expected_sharded_launches(cfg, steps - 1)
            carry = [cfg.n_layers, 4 // D, cfg.rnn_hidden // k]
            same = sum(st["tokens"][rid] == ref["tokens"][rid] for rid in ref["tokens"])
            emit({"phase": "sharded", "continuous": run, "arch": cfg.name, "mesh": st["mesh"],
                  "compute": cfg.compute_dtype,
                  "schedule": "ring" if cfg.ring_overlap else "barrier",
                  "requests": st["requests"], "completed": st["completed"],
                  "tokens_equal": st["tokens"] == ref["tokens"], "streams_equal": same,
                  "prefix_hits": st["prefix_hits"], "single_prefix_hits": ref["prefix_hits"],
                  "rollbacks": st["spec_rollbacks"], "single_rollbacks": ref["spec_rollbacks"],
                  "ticks": st["ticks"], "prefill_chunks": st["prefill_chunks"],
                  "decode_steps": st["decode_steps"], "verify_steps": st["verify_steps"],
                  "draft_steps": st["draft_steps"],
                  "launches_per_rank": [{n: c for n, c in m["launches"].items() if c}
                                        for m in mine],
                  "expected_launches": {n: c for n, c in want.items() if c},
                  "pool_carry_shape_per_rank": [m["stats"]["pool_carry_shape"] for m in mine],
                  "tick_ms_per_rank": [m["stats"]["busy_s"] * 1e3 / max(m["stats"]["ticks"], 1)
                                       for m in mine],
                  "single_tick_ms": ref["busy_s"] * 1e3 / max(ref["ticks"], 1),
                  "tpot_p50_ms": st["tpot_s"]["p50"] * 1e3,
                  "single_tpot_p50_ms": ref["tpot_s"]["p50"] * 1e3,
                  "timed_per_rank": [m["timed"] for m in mine], "note": gloo,
                  "lines": mine[0]["lines"]})
            require(st["completed"] == st["requests"] == SHARDED_CONT_REQUESTS,
                    f"{what}: {st['completed']}/{st['requests']} completed")
            require(st["tokens"] == ref["tokens"],
                    f"{what}: {len(ref['tokens']) - same} streams differ from the single device's")
            require((st["prefix_hits"], st["spec_rollbacks"])
                    == (ref["prefix_hits"], ref["spec_rollbacks"]),
                    f"{what}: hits/rollbacks {st['prefix_hits']}/{st['spec_rollbacks']} != "
                    f"{ref['prefix_hits']}/{ref['spec_rollbacks']}")
            require(SHARDED_CONT_RUNS[run][1] != "prefix" or st["prefix_hits"] > 0,
                    f"{what}: no prefix hit")
            require(not SHARDED_CONT_RUNS[run][2] or (st["verify_steps"] > 0
                                                     and st["spec_rollbacks"] == 0),
                    f"{what}: the oracle draft: {st['verify_steps']} verify steps, "
                    f"{st['spec_rollbacks']} rollbacks")
            for m in mine:
                ms = m["stats"]
                require(ms["tokens"] == st["tokens"] and ms["admissions"] == st["admissions"],
                        f"{what}: the ranks' tokens or admissions differ")
                require(ms["pool_carry_shape"] == carry and ms["cache_in_place"]
                        and ms["graphs"] is False,
                        f"{what}: pool carry {ms['pool_carry_shape']} (want {carry}), in place "
                        f"{ms['cache_in_place']}, graphs {ms['graphs']}")
                require(m["launches"] == want, f"{what}: launches {m['launches']} != {want}")
                for n, c in m["launches"].items():
                    totals[n] += c
    emit({"phase": "sharded", "continuous_seconds": seconds})
    return seconds


def _sharded_train_cfg(arch, engine=None, over=None):
    """``arch`` (on ``engine``, with ``over``'s fields) as ``launch.train``
    runs it at TRAIN_BATCH, in fp32 compute."""
    return _train_cfg(arch, engine, over or {}).with_(compute_dtype="float32")


def _train_steps(cfg, step_fn, state, device, steps):
    """``steps`` train steps on the pipeline ``launch.train`` draws (seed
    0); returns the state, losses, grad norms and ms a step (synchronised)."""
    import torch

    from repro_torch.data import make_pipeline
    from repro_torch.launch.train import batch_to_device

    pipeline = make_pipeline(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    losses, gnorms, ms = [], [], []
    for step in range(steps):
        batch = batch_to_device(pipeline.batch_at(step), device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return state, losses, gnorms, ms


def _data_gathers(mesh, cfg, specs, record):
    """Record into ``record`` the largest all_gather over "data" by the
    bytes it puts out: of all (``largest``) and of the layer leaves
    (``largest_layer``: any but a non-layer leaf's shard under ``specs``);
    returns the function that stops recording."""
    from repro_torch.configs import shapes
    from repro_torch.distribution import sharding as shd
    from repro_torch.tree import flatten_with_paths, tree_leaves

    data = mesh.axis("data")
    if data.size == 1:
        return lambda: None
    outside = {shd.local_shape(x.shape, spec, mesh) for (path, x), spec in
               zip(flatten_with_paths(shapes.param_shapes(cfg)), tree_leaves(specs))
               if not path.startswith("layers/")}
    inner = data.all_gather

    def spy(x, dim=-1):
        out = x.numel() * x.element_size() * data.size
        record["largest"] = max(record.get("largest", 0), out)
        if tuple(x.shape) not in outside:
            record["largest_layer"] = max(record.get("largest_layer", 0), out)
        return inner(x, dim)

    data.all_gather = spy
    return lambda: delattr(data, "all_gather")


def _sharded_train_rank(arch, engine, model_axis, fsdp, over, device, counters, keep_params):
    """One rank's SHARDED_TRAIN_STEPS steps of ``build_train_step(cfg, mesh)``
    on the (2 / model_axis, model_axis) mesh (each rank draws the whole
    state from seed 0 and keeps its shards), every kernel's count set to 0
    just before and read just after, with the peak memory from the run's
    steps' start (the rank's shards of the state made, the whole state
    freed) and the largest all_gathers over "data" (``_data_gathers``);
    then one more step inside ``timed_collectives``, split into the
    collectives and the rest."""
    import torch

    from repro_torch.distribution import sharding as shd
    from repro_torch.launch.mesh import make_local_mesh, timed_collectives
    from repro_torch.training import steps
    from repro_torch.tree import flatten_with_paths, tree_leaves

    cfg = _sharded_train_cfg(arch, engine, over)
    mesh = make_local_mesh(model_axis, device=device)
    specs = steps.train_param_specs(cfg, mesh, fsdp=fsdp)
    sspecs = steps.train_state_specs(specs)
    state = steps.init_train_state(torch.Generator(device=device).manual_seed(0), cfg,
                                   device=device)
    state = steps.shard_train_state(state, sspecs, mesh)
    step_fn = steps.build_train_step(cfg, mesh, base_lr=3e-4, warmup=20,
                                     total_steps=SHARDED_TRAIN_STEPS, specs=specs)
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    gathers = {}
    stop = _data_gathers(mesh, cfg, specs, gathers)
    torch.cuda.reset_peak_memory_stats(device)
    state, losses, gnorms, ms = _train_steps(cfg, step_fn, state, device, SHARDED_TRAIN_STEPS)
    stop()
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    launches = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
    params = {}  # every rank takes part in the gathers; one keeps the result
    for (path, x), s in zip(flatten_with_paths(state.params), tree_leaves(specs)):
        whole = shd.gather_shard(x, s, mesh)
        if keep_params:
            params[path] = whole.cpu()
    with timed_collectives(mesh) as clock:
        _, _, _, timed = _train_steps(cfg, step_fn, state, device, 1)
    coll = {k: v * 1e3 for k, v in sorted(clock.items())}
    return {"losses": losses, "grad_norms": gnorms, "step_ms": ms, "launches": launches,
            "params": params, "mesh": mesh.shape, "fsdp": fsdp,
            "sharded_over": sorted({a for s in tree_leaves(specs) for a in shd.spec_axes(s)}),
            "split": {"timed_step_ms": timed[0], "collective_ms": coll,
                      "rest_ms": timed[0] - sum(coll.values())},
            "peak_mem_gb": peak_gb, "data_all_gather_bytes": gathers}


def _expected_sharded_train_launches(cfg, model_axis: int, steps: int) -> dict:
    """One rank's launches over ``steps`` sharded train steps: the
    single-device step's, except that on a model axis above 1 the stack runs
    the barrier schedule, B1 a layer where one device runs B2 (the backward
    recomputes on B3 either way)."""
    want = _expected_train_launches(cfg, steps)
    if model_axis > 1:
        want["fused_rnn_layer"] += want["fused_rnn_stack"]
        want["fused_rnn_stack"] = 0
    return want


def _sharded_train_kernels():
    """The kernels of the sharded train runs at their shapes, against their
    plain versions: B1 on a rank's lanes (the SRU stack on (1, 2): Hl 512 of
    1024, B = 8, T = 256, fp32), B2 on a data rank's rows (the QRNN stack on
    (2, 1): B = 4), B3 forward and backward at the recompute's F = B * Hl =
    4096. Returns the rows."""
    from repro_torch.kernels.fused_rnn import fused_rnn, stacked
    from repro_torch.kernels.linear_scan import linear_scan

    T = TRAIN_SEQ
    rows = _run_cases("fused_rnn_layer", fused_rnn.fused_rnn_layer,
                      fused_rnn.fused_rnn_layer_plain, [("float32", T) + _shard_case(
                          f"sharded train: sru_identity shard 1 Hl=512 of 1024 T={T} B=8 float32",
                          "sru_identity", T, 8, 1024, 2, 1, "float32", 650)],
                      cold=True, phase="sharded")
    rows += _run_cases("fused_rnn_stack", stacked.fused_rnn_stack, stacked.fused_rnn_stack_plain,
                       [("float32", T) + _stack_case(
                           f"sharded train: qrnn L=4 T={T} B=4 float32 (a data rank's rows)",
                           "qrnn", T, 4, 1024, 4, "float32", 651)], cold=True, phase="sharded")
    name = f"sharded train recompute: T={T} F=4096 fp32"
    scan = [("float32", T) + _scan_case(name, T, 4096, "float32", 652)]
    rows += _run_cases("linear_scan", linear_scan.linear_scan_kernel, _scan_chunked, scan,
                       cold=True, phase="sharded")
    _scan_checks(scan)
    rows.append(_scan_backward_row(f"backward {name}", T, 4096, "float32", 653))
    return rows


def _sharded_cli(counters):
    """``launch.train`` through ``torch.distributed.run``: two gloo ranks of
    SHARDED_CLI_ARCH (the config's dtypes) to step SHARDED_CLI_SAVE, saved;
    ``--resume auto`` on one rank to SHARDED_CLI_STEPS (in this process,
    counts set to 0 just before and read just after); the uninterrupted
    single-rank run. Returns the line's fields and the resumed run's
    launches."""
    import numpy as np

    from repro_torch.launch import train

    d = SHARDED_DIR / "cli"
    common = ["--arch", SHARDED_CLI_ARCH, "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
              "--log-every", "1"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "repro_torch.launch.train", *common, "--dist-backend", "gloo",
         "--steps", str(SHARDED_CLI_SAVE), "--checkpoint-dir", str(d / "ranks"),
         "--metrics-out", str(d / "ranks.json")],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=600)
    ranks_s = time.perf_counter() - t0
    require(proc.returncode == 0, f"sharded train CLI: exit {proc.returncode}: "
            f"{proc.stderr[-3000:]}")
    lines = proc.stdout.splitlines()
    require(any(x.startswith("mesh: {'data': 2, 'model': 1}") for x in lines)
            and any(x.startswith("dist: backend gloo") for x in lines),
            f"sharded train CLI: no mesh line: {lines[:4]}")
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        require(train.main(common + ["--steps", str(SHARDED_CLI_STEPS), "--checkpoint-dir",
                                     str(d / "ranks"), "--resume", "auto", "--metrics-out",
                                     str(d / "resumed.json")]) == 0, "sharded train CLI: resume")
    launches = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
    require(f"[resume] step {SHARDED_CLI_SAVE}" in buf.getvalue(),
            "sharded train CLI: the one-rank run did not resume")
    with contextlib.redirect_stdout(io.StringIO()):
        require(train.main(common + ["--steps", str(SHARDED_CLI_STEPS), "--checkpoint-dir",
                                     str(d / "single"), "--metrics-out",
                                     str(d / "single.json")]) == 0, "sharded train CLI: single")
    step = f"step_{SHARDED_CLI_STEPS}"
    diff = _max_leaf_diff(_step_leaves(d / "ranks" / step), _step_leaves(d / "single" / step))
    hist = {k: json.loads((d / f"{k}.json").read_text()) for k in ("ranks", "resumed", "single")}
    ran = hist["ranks"] + hist["resumed"]
    loss_diff = max(abs(a["loss"] - b["loss"]) for a, b in zip(ran, hist["single"]))
    require(len(ran) == SHARDED_CLI_STEPS and diff <= SHARDED_TRAIN_PARAM_TOL,
            f"sharded train CLI: params {diff} from the single-rank run's")
    return {"ranks_command_s": ranks_s, "ranks_lines": [x for x in lines if not
                                                        x.startswith("step ")][:3],
            "losses_ranks_then_resumed": [h["loss"] for h in ran],
            "losses_single": [h["loss"] for h in hist["single"]],
            "loss_max_abs_diff": loss_diff, "param_max_abs_diff": diff,
            "param_tol": SHARDED_TRAIN_PARAM_TOL,
            "compute": _run_cfg(SHARDED_CLI_ARCH, None).compute_dtype}, launches


def _sharded_train(totals):
    """The sharded training runs (SHARDED_TRAIN_RUNS) on two gloo ranks
    against the single-device fp32 run on the card, their kernels at their
    shapes, and the CLI (``_sharded_cli``). Adds the launches to ``totals``."""
    import torch

    from repro_torch.training import steps

    gloo = "gloo ranks sharing one card: the times are not multi-GPU speed"
    t_phase = time.perf_counter()
    _sharded_train_kernels()
    single = {}
    for arch, engine, _, _, over in SHARDED_TRAIN_RUNS:
        cfg = _sharded_train_cfg(arch, engine, over)
        state = steps.init_train_state(torch.Generator(device="cuda").manual_seed(0), cfg,
                                       device="cuda")
        step_fn = steps.build_train_step(cfg, base_lr=3e-4, warmup=20,
                                         total_steps=SHARDED_TRAIN_STEPS)
        torch.cuda.reset_peak_memory_stats()
        state, losses, gnorms, ms = _train_steps(cfg, step_fn, state, torch.device("cuda"),
                                                 SHARDED_TRAIN_STEPS)
        single[arch] = {"losses": losses, "grad_norms": gnorms, "step_ms": ms,
                        "params": _flat_cpu(state.params),
                        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        del state, step_fn
        _release()
    ranks = _spawn_ranks("train", 2, 2, {"serve": (), "moe": (), "logits": False, "split": (),
                                         "train": SHARDED_TRAIN_RUNS})
    for arch, engine, model_k, fsdp, over in SHARDED_TRAIN_RUNS:
        key, ref = f"train {arch}", single[arch]
        cfg = _sharded_train_cfg(arch, engine, over)
        r0 = ranks[0][key]
        want = _expected_sharded_train_launches(cfg, model_k, SHARDED_TRAIN_STEPS)
        loss_err = max(abs(a - b) for a, b in zip(r0["losses"], ref["losses"]))
        gn_err = max(abs(a - b) for a, b in zip(r0["grad_norms"], ref["grad_norms"]))
        param_err = max((r0["params"][p] - ref["params"][p]).abs().max().item()
                        for p in ref["params"])
        emit({"phase": "sharded", "train": arch, "engine": cfg.scan_engine,
              "n_layers": cfg.n_layers, "remat": cfg.remat, "mesh": r0["mesh"], "fsdp": fsdp,
              "sharded_over": r0["sharded_over"], "compute": cfg.compute_dtype,
              "steps": SHARDED_TRAIN_STEPS, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
              "losses": r0["losses"], "single_losses": ref["losses"],
              "grad_norms": r0["grad_norms"], "single_grad_norms": ref["grad_norms"],
              "loss_max_abs_diff": loss_err, "loss_tol": SHARDED_TRAIN_LOSS_TOL,
              "grad_norm_max_abs_diff": gn_err, "grad_norm_tol": SHARDED_TRAIN_GRAD_TOL,
              "param_max_abs_diff": param_err, "param_tol": SHARDED_TRAIN_PARAM_TOL,
              "launches_per_rank": [{k: n for k, n in r[key]["launches"].items() if n}
                                    for r in ranks],
              "expected_launches": {k: n for k, n in want.items() if n},
              "step_ms_per_rank": [r[key]["step_ms"] for r in ranks],
              "single_step_ms": ref["step_ms"],
              "split_per_rank": [r[key]["split"] for r in ranks], "split_note": gloo,
              "peak_mem_gb_per_rank": [r[key]["peak_mem_gb"] for r in ranks],
              "single_peak_mem_gb": ref["peak_mem_gb"],
              "data_all_gather_bytes_per_rank": [r[key]["data_all_gather_bytes"]
                                                 for r in ranks]})
        require(all(r[key]["losses"] == r0["losses"] for r in ranks),
                f"sharded train {arch}: the ranks' losses differ")
        require(loss_err <= SHARDED_TRAIN_LOSS_TOL and gn_err <= SHARDED_TRAIN_GRAD_TOL
                and param_err <= SHARDED_TRAIN_PARAM_TOL,
                f"sharded train {arch}: loss {loss_err}, grad norm {gn_err}, params {param_err}")
        for r in ranks:
            require(r[key]["launches"] == want,
                    f"sharded train {arch}: launches {r[key]['launches']} != {want}")
            for k, v in r[key]["launches"].items():
                totals[k] += v
    del single
    _release()
    counters = _launch_counters()
    cli, launches = _sharded_cli(counters)
    want = _expected_train_launches(_train_cfg(SHARDED_CLI_ARCH, None, {}),
                                    SHARDED_CLI_STEPS - SHARDED_CLI_SAVE)
    require(launches == want, f"sharded train CLI: resumed launches {launches} != {want}")
    for k, v in launches.items():
        totals[k] += v
    emit({"phase": "sharded", "train_cli": SHARDED_CLI_ARCH, "ranks": 2, "backend": "gloo",
          "saved_at": SHARDED_CLI_SAVE, "resumed_on_one_rank_to": SHARDED_CLI_STEPS, **cli,
          "resumed_launches": {k: n for k, n in launches.items() if n},
          "seconds": time.perf_counter() - t_phase})


def _flat_cpu(tree) -> dict:
    from repro_torch.tree import flatten_with_paths

    return {p: x.detach().cpu() for p, x in flatten_with_paths(tree)}


def phase_sharded():
    """Multi-GPU serving of the fused RNN path, on the one card: its ranks
    share it over gloo, so the times are not multi-GPU speed. (a) B1 at the
    shard shapes against its plain version (SHARD_CASES, the ragged int8
    shard, SHARD_MIXED_CASES), warm and cold, with bound; (b) the
    single-device run of each of SHARDED_RUNS (fp32 compute) and of
    SHARDED_BF16_RUN (bf16), B = 4, prompt 64, gen 32, eager, and its
    teacher-forced logits; (c) two gloo ranks, (data 1, model 2), each
    serving every run through ``serve.serve_mesh`` and the same logits,
    with a decode step of SHARDED_SPLIT_RUNS split into collectives and the
    rest, then one full-width layer of each SHARDED_MOE under
    ``_moe_shard_map`` held to ``sorted`` on one rank at 2e-5; (d) four
    ranks, (2, 2), serving SHARDED_DATA_RUN; (f) continuous serving on
    those two meshes (``_sharded_continuous``); (g) on the ranks of (c),
    SHARDED_TP_RUNS on their own engine (``_sharded_tp``); (h) on the same
    ranks SHARDED_LM_RUNS, the attention, MLP and Mamba leaves per rank
    (``_sharded_lm``); (i) on the same ranks SHARDED_MOE_LM_RUNS, mixtral's
    experts over "model" under its ``sorted`` schedule and its 3-expert
    stand-in for the ``ff_moe`` layout, half the expert bytes a rank
    (``_sharded_lm`` too); (e) training on two ranks (``_sharded_train``),
    the pallas run of (g) among them, and smollm-360m's FSDP gathered a
    layer at a time (each rank's peak memory and largest all_gather over
    "data"). Under fp32 the tokens must
    equal the single-device run's and the logits be within SHARDED_TOL;
    under bf16 the logits within SHARDED_BF16_TOL (the tokens are
    reported); each rank's launches the expected, each model rank's
    gate-slab and vocab bytes 1/2 of the whole. Returns the ranks'
    launches."""
    import torch

    from repro_torch.kernels.fused_rnn import fused_rnn
    from repro_torch.launch import serve
    from repro_torch.models import lm, moe
    from repro_torch.models.lm import _dtype

    if SHARDED_DIR.exists():
        shutil.rmtree(SHARDED_DIR)
    SHARDED_DIR.mkdir(parents=True)
    n = torch.cuda.device_count()
    emit({"phase": "sharded", "nccl": f"NCCL across cards: not run, {n} card"
          + ("s" if n > 1 else "") + "; the ranks share cuda:0 over gloo"})
    # (a) the shard shapes
    cases, served = shard_cases()
    for kname, kcases in cases.items():
        _run_cases(kname, fused_rnn.fused_rnn_layer, fused_rnn.fused_rnn_layer_plain, kcases,
                   cold=True, phase="sharded")
        for dtype, _, name, args, kw, _, _ in kcases:
            line = {"phase": "sharded", "kernel": kname, "case": name,
                    "served_launches_per_rank": served[name]}
            emit(dict(line, **fused_instance_info(args, kw))
                 if args[0].dtype == torch.bfloat16 else line)
    _release()
    # (b) single-device references
    single, ref_logits = {}, {}
    for arch, compute in _sharded_runs():
        args = _sharded_args(arch, 1)
        cfg = _sharded_cfg(args, compute)
        key = _run_key(arch, compute)
        params = lm.lm_init(torch.Generator(device="cuda").manual_seed(args.seed), cfg,
                            device="cuda", dtype=_dtype(compute))
        with contextlib.redirect_stdout(io.StringIO()):
            single[key] = serve.run_batch(cfg, params, args, torch.device("cuda"), graphs=False)
        ref_logits[key] = _step_logits(cfg, params, None, torch.device("cuda"),
                                       _logit_inputs(cfg))
        del params
        _release()
    tp_single, tp_logits = {}, {}
    for arch in SHARDED_TP_RUNS:
        args = _sharded_args(arch, 1, gen=SHARDED_TP_GEN)
        cfg = _sharded_cfg(args)
        params = lm.lm_init(torch.Generator(device="cuda").manual_seed(args.seed), cfg,
                            device="cuda", dtype=torch.float32)
        with contextlib.redirect_stdout(io.StringIO()):
            tp_single[arch] = serve.run_batch(cfg, params, args, torch.device("cuda"),
                                              graphs=False)
        tp_logits[arch] = _step_logits(cfg, params, None, torch.device("cuda"),
                                       _logit_inputs(cfg))
        del params
        _release()
    for _, key, _, arch, layers, over in _lm_runs():
        args, cfg = _lm_cfg(arch, 1, layers, over)
        params = lm.lm_init(torch.Generator(device="cuda").manual_seed(args.seed), cfg,
                            device="cuda", dtype=torch.float32)
        with contextlib.redirect_stdout(io.StringIO()):
            tp_single[key] = serve.run_batch(cfg, params, args, torch.device("cuda"),
                                             graphs=False)
        tp_logits[key] = _step_logits(cfg, params, None, torch.device("cuda"),
                                      _logit_inputs(cfg))
        del params
        _release()  # (i)'s ranks draw mixtral's whole 11.7 GB layer each: freed first
    t_cont = time.perf_counter()
    cont_single = {run: _cont_single(run) for run in SHARDED_CONT_RUNS}
    _release()
    cont_ref_s = time.perf_counter() - t_cont
    moe_ref = {}
    for arch in SHARDED_MOE:
        cfg, params, x = _moe_setup(arch, torch.device("cuda"))
        moe_ref[arch] = moe.moe_apply(params, cfg.with_(moe_impl="sorted"), x).cpu()
        del params, x
        _release()
    # (c) (data 1, model 2)
    totals = dict.fromkeys(KERNELS, 0)
    ranks = _spawn_ranks("m2", 2, 2, {"serve": _sharded_runs(), "moe": SHARDED_MOE,
                                      "logits": True, "split": SHARDED_SPLIT_RUNS,
                                      "tp": SHARDED_TP_RUNS, "lm": _lm_runs(),
                                      "continuous": tuple(SHARDED_CONT_RUNS)})
    cont_m2 = ranks
    for arch, compute in _sharded_runs():
        key = _run_key(arch, compute)
        cfg = _sharded_cfg(_sharded_args(arch, 2), compute)
        want = _expected_sharded_launches(cfg, 31)
        st0 = ranks[0][key]["stats"]
        diff = (ranks[0][key]["logits"].float() - ref_logits[key].float()).abs().max().item()
        tol = SHARDED_TOL if compute == "float32" else SHARDED_BF16_TOL
        same = [a == b for a, b in zip(st0["tokens"], single[key]["tokens"])]
        emit({"phase": "sharded", "mesh": st0["mesh"], "arch": arch, "compute": compute,
              "schedule": ("ring" if cfg.ring_overlap else "barrier")
              if cfg.scan_engine == "fused_stack" else "layer",
              "tokens_equal": st0["tokens"] == single[key]["tokens"],
              "rows_with_equal_tokens": sum(same),
              "logits_max_abs_diff": diff, "tol": tol,
              "launches_per_rank": [r[key]["launches"] for r in ranks],
              "slab_bytes": st0["slab_bytes"], "slab_bytes_whole": st0["slab_bytes_whole"],
              "prefill_ms": [r[key]["stats"]["prefill_ms"] for r in ranks],
              "decode_ms": [r[key]["stats"]["decode_ms"] for r in ranks],
              "single_prefill_ms": single[key]["prefill_ms"],
              "single_decode_ms": single[key]["decode_ms"],
              "split_per_rank": [r[key]["split"] for r in ranks], "lines": ranks[0][key]["lines"]})
        if compute == "float32":
            require(st0["tokens"] == single[key]["tokens"],
                    f"sharded {key}: tokens differ from the single-device run's")
        require(all(r[key]["stats"]["tokens"] == st0["tokens"] for r in ranks),
                f"sharded {key}: the ranks' tokens differ")
        require(diff <= tol, f"sharded {key}: logits differ by {diff} > {tol}")
        for r in ranks:
            require(r[key]["launches"] == want,
                    f"sharded {key}: launches {r[key]['launches']} != {want}")
            for k, v in r[key]["launches"].items():
                totals[k] += v
        require(st0["slab_bytes"] == [st0["slab_bytes_whole"] // 2] * 2,
                f"sharded {key}: slab bytes {st0['slab_bytes']} of {st0['slab_bytes_whole']}")
        require(st0["vocab_bytes"] == [st0["vocab_bytes_whole"] // 2] * 2,
                f"sharded {key}: vocab bytes {st0['vocab_bytes']} of {st0['vocab_bytes_whole']}")
    # (g) tensor parallelism of the chunked engine, the LSTM and the vocab
    _sharded_tp(tp_single, tp_logits, ranks, totals)
    # (h) tensor parallelism of the attention, dense MLP and Mamba leaves
    _sharded_lm(tp_single, tp_logits, ranks, totals, "h")
    # (i) the MoE experts under the model axis, in both layouts
    _sharded_lm(tp_single, tp_logits, ranks, totals, "i")
    for arch in SHARDED_MOE:
        err = (ranks[0][arch]["y"] - moe_ref[arch]).abs().max().item()
        emit({"phase": "sharded", "moe": arch, "mesh": {"data": 1, "model": 2},
              "experts_per_rank": ranks[0][arch]["experts"], "max_abs_err": err, "tol": 2e-5,
              "ms_per_rank": [r[arch]["ms"] for r in ranks]})
        require(all(torch.equal(r[arch]["y"], ranks[0][arch]["y"]) for r in ranks),
                f"sharded moe {arch}: the ranks disagree")
        require(err <= 2e-5, f"sharded moe {arch}: err {err} against sorted on one rank")
    # (d) (data 2, model 2)
    ranks = _spawn_ranks("d2m2", 4, 2, {"serve": [(SHARDED_DATA_RUN, "float32")], "moe": (),
                                        "logits": False, "split": (),
                                        "continuous": SHARDED_CONT_DATA_RUNS})
    st = ranks[0][SHARDED_DATA_RUN]["stats"]
    emit({"phase": "sharded", "mesh": st["mesh"], "arch": SHARDED_DATA_RUN,
          "tokens_equal": st["tokens"] == single[SHARDED_DATA_RUN]["tokens"],
          "launches_per_rank": [r[SHARDED_DATA_RUN]["launches"] for r in ranks],
          "decode_ms": [r[SHARDED_DATA_RUN]["stats"]["decode_ms"] for r in ranks]})
    require(st["tokens"] == single[SHARDED_DATA_RUN]["tokens"],
            "sharded (2, 2): tokens differ from the single-device run's")
    want = _expected_sharded_launches(_sharded_cfg(_sharded_args(SHARDED_DATA_RUN, 2)), 31)
    for r in ranks:
        require(r[SHARDED_DATA_RUN]["launches"] == want, "sharded (2, 2): launches")
        for k, v in r[SHARDED_DATA_RUN]["launches"].items():
            totals[k] += v
    # (f) continuous serving on the mesh
    _sharded_continuous(cont_single, cont_m2, ranks, cont_ref_s, totals)
    # (e) training on the mesh
    _sharded_train(totals)
    emit({"phase": "sharded", "launches": totals})
    return totals


# ---------------------------------------------------------------------------
# dryrun
# ---------------------------------------------------------------------------

def _dryrun_fill(cfg, shape, gen):
    """The card's filler of a rank's inputs (``dryrun.meta_fill``'s
    contract): params and caches small normals from ``gen``, the KV cache's
    position at the last slot, token ids in the vocab."""
    import torch

    def fill(like, role):
        if role.endswith("/pos"):
            return torch.full(like.shape, shape.seq_len - 1, dtype=like.dtype, device="cuda")
        if role in ("inputs/t", "inputs/inputs", "inputs/targets"):
            return torch.randint(0, cfg.vocab, like.shape, generator=gen, device="cuda",
                                 dtype=like.dtype)
        scale = 0.1 if role.startswith("cache/") else 0.02
        return (torch.randn(like.shape, generator=gen, device="cuda") * scale).to(like.dtype)

    return fill


def _dryrun_cell(arch, shape_name, mesh_kind, layers, counters):
    """One cell: its meta run (the prediction), then the same rank's step on
    the card (shapes, collectives, launches, finite logits, peak memory
    against the prediction, ms a step). Returns the line and the launches
    of the measured step."""
    import torch

    from repro_torch.configs import shapes
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import recorded_collectives, virtual_mesh
    from repro_torch.tree import flatten_with_paths

    cfg, shape = get_config(arch), shapes.SHAPES[shape_name]
    if layers is not None:
        cfg = cfg.with_(n_layers=layers)
    classes = dryrun.rank_classes(cfg, shape, dryrun.MESHES[mesh_kind])
    require(len(classes) == 1, f"dryrun {arch}: {len(classes)} classes of ranks")
    mesh = virtual_mesh(dryrun.MESHES[mesh_kind], classes[0][0])
    what = f"dryrun {arch} {shape_name} {mesh_kind}"
    t0 = time.perf_counter()
    meta_step = dryrun.STEPS[shape.kind](cfg, shape, mesh)
    meta = dryrun.measure(meta_step.fn, meta_step.args, mesh, arg_bytes=meta_step.arg_bytes,
                          output_bytes=meta_step.output_bytes, block=512)
    meta_s = time.perf_counter() - t0

    gen = torch.Generator(device="cuda").manual_seed(DRYRUN_SEED)
    step = dryrun.STEPS[shape.kind](cfg, shape, mesh, fill=_dryrun_fill(cfg, shape, gen))
    got = [(p, tuple(x.shape), x.dtype) for p, x in flatten_with_paths(dict(enumerate(step.args)))]
    want = [(p, tuple(x.shape), x.dtype)
            for p, x in flatten_with_paths(dict(enumerate(meta_step.args)))]
    require(got == want, f"{what}: the card's inputs are not the meta run's local shapes")
    args_bytes = sum(math.prod(s) * torch.empty((), dtype=d).element_size() for _, s, d in got)
    step.fn(*step.args)  # warm-up: cuBLAS workspaces, B5's launch words
    torch.cuda.synchronize()
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with recorded_collectives(mesh) as log:
        out = step.fn(*step.args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    launches = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
    logits = out[0]
    require(bool(torch.isfinite(logits.float()).all().item()), f"{what}: logits not finite")
    coll = {"total": dryrun._coll(log, False), "entry": dryrun._coll(log, True)}
    for k in ("total", "entry"):
        require(coll[k] == meta[f"collectives_{k}"],
                f"{what}: collectives {k} {coll[k]} != the meta run's "
                f"{meta[f'collectives_{k}']}")
    want_launches = {k: v["launches"] for k, v in meta["kernels"].items()}
    require({k: n for k, n in launches.items() if n} == want_launches,
            f"{what}: launches {launches} != the meta run's calls {want_launches}")
    temp = meta["memory"]["temp_bytes"]
    tol = DRYRUN_TEMP_RTOL * temp + DRYRUN_TEMP_ALLOWANCE
    require(abs(peak - temp) <= tol,
            f"{what}: peak {peak} B beyond the arguments, predicted {temp} B (tolerance {tol})")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(DRYRUN_STEPS):
        step.fn(*step.args)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t1) / DRYRUN_STEPS * 1e3
    line = {"phase": "dryrun", "cell": f"{arch} {shape_name} {mesh_kind}", "layers": cfg.n_layers,
            "rank": classes[0][0], "ranks_checked": classes[0][1],
            "note": "one rank, no communication: the virtual rank's collectives return its "
                    "own operand tiled or copied (shape-true, not the mesh's values)",
            "ms_per_step": ms, "meta_s": meta_s, "args_bytes": args_bytes,
            "argument_bytes": meta["memory"]["argument_bytes"],
            "peak_bytes_beyond_args": peak, "predicted_temp_bytes": temp,
            "temp_tolerance_bytes": tol, "launches": want_launches,
            "collectives": coll["total"]["counts"],
            "collective_bytes": {k: v for k, v in coll["total"].items()
                                 if k not in ("count", "counts") and v},
            "flops": meta["cost"]["flops"]}
    del step, out, logits
    _release()
    return line, launches


# ---------------------------------------------------------------------------
# contracts
# ---------------------------------------------------------------------------

def _ledger_instances(ledger):
    """The ledger's distinct kernel instances, each with where it first
    appears (config/step)."""
    seen = {}
    for arch, entry in sorted(ledger["archs"].items()):
        for step, rec in entry["steps"].items():
            for inst in rec["instances"]:
                seen.setdefault(json.dumps(inst, sort_keys=True), f"{arch}/{step}")
    return [(json.loads(k), where) for k, where in seen.items()]


def _contract_scheduler(ledger):
    """One live Scheduler of CONTRACT_SCHEDULER on the card with CUDA
    graphs, at the ledger's batch and chunk, speculative at its SPEC_K:
    the signatures of every capture (``graphs.capture`` wrapped) in warm-up
    and over CONTRACT_REQUESTS requests. Returns the line."""
    import numpy as np
    import torch

    from repro_torch.analysis import contracts
    from repro_torch.configs.registry import get_config
    from repro_torch.models import lm
    from repro_torch.serving import Request, Scheduler
    from repro_torch.training import graphs

    entry = ledger["archs"][CONTRACT_SCHEDULER]
    cfg, draft_cfg = get_config(CONTRACT_SCHEDULER), get_config("sru-paper-draft")
    params = lm.lm_init(torch.Generator(device="cuda").manual_seed(36), cfg)
    draft = lm.lm_init(torch.Generator(device="cuda").manual_seed(37), draft_cfg)
    captured, capture = [], graphs.capture

    def recording(step, *args, **kw):
        name = contracts.step_of(step)
        captured.append(contracts.step_signature(name, args) if name else
                        getattr(step, "__name__", "?"))
        return capture(step, *args, **kw)

    graphs.capture = recording
    try:
        eng = Scheduler(cfg, params, batch=entry["batch"], chunk=entry["chunk"],
                        draft_cfg=draft_cfg, draft_params=draft, spec_k=contracts.SPEC_K,
                        async_depth=2, device="cuda", graphs=True)
        eng.warmup()
        at_warmup = list(captured)
        rng = np.random.default_rng(36)
        trace = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=CONTRACT_PROMPT - i,
                                                    dtype=np.int32),
                         max_new_tokens=CONTRACT_GEN) for i in range(CONTRACT_REQUESTS)]
        done = eng.run(trace, max_ticks=2000)
    finally:
        graphs.capture = capture
    sigs = sorted(set(c for c in at_warmup if "(" in c))
    require(sorted(r.rid for r in done) == list(range(CONTRACT_REQUESTS)),
            "contracts: the live Scheduler did not finish its requests")
    require(sigs == sorted(entry["trace_set"]),
            f"contracts: the Scheduler captured {sigs}, the ledger's trace set is "
            f"{entry['trace_set']}")
    require(captured == at_warmup, f"contracts: captures after warm-up: {captured[len(at_warmup):]}")
    require(eng.metrics.verify_steps > 0, "contracts: no verify step ran")
    line = {"phase": "contracts", "scheduler": CONTRACT_SCHEDULER, "batch": entry["batch"],
            "chunk": entry["chunk"], "spec_k": contracts.SPEC_K, "captures": len(at_warmup),
            "signatures": sigs, "other_captures": sorted(set(at_warmup) - set(sigs)),
            "captures_after_warmup": len(captured) - len(at_warmup),
            "verify_steps": eng.metrics.verify_steps, "requests": len(done)}
    del eng, params, draft
    _release()
    return line


def phase_contracts():
    """``analysis/contracts.py``'s ledger held on the card: ``check_contracts``
    of CONTRACTS_TORCH.json (derived on meta) gives no violation; every
    kernel instance the ledger lists, and those at CONTRACT_SSD,
    CONTRACT_SSD_STEP4, CONTRACT_GQA and CONTRACT_SIMT, has the card's
    registers, dynamic shared memory, CTAs per SM and, where the card
    reports it, static shared memory (``smem.card_instance``) that its H100
    model gives; one live
    Scheduler captures exactly the ledger's trace set and nothing after
    warm-up. Launches no kernel of the main path's count."""
    import torch

    from repro_torch.analysis import contracts, smem
    from repro_torch.kernels.fused_rnn import fused_rnn
    from repro_torch.kernels.gqa_decode import gqa_decode as gqa_kernel
    from repro_torch.kernels.ssd import ssd as ssd_kernel

    t0 = time.perf_counter()
    ledger = json.loads((ROOT / "CONTRACTS_TORCH.json").read_text())
    violations = contracts.check_contracts(ledger)
    require(not violations, "contracts: " + "; ".join(v.format() for v in violations))
    emit({"phase": "contracts", "archs": len(ledger["archs"]), "violations": 0,
          "check_s": time.perf_counter() - t0})
    insts = _ledger_instances(ledger)
    insts += [(ssd_kernel.meta_instance(getattr(torch, x), getattr(torch, b), 4, 64, 80, 1, 64, n),
               f"ssd {x}/{b} N={n}") for x, b, n in CONTRACT_SSD]
    insts += [(ssd_kernel.meta_instance(getattr(torch, x), getattr(torch, b), 4, 1, 80, 1, 64, n),
               f"ssd step {x}/{b} N={n}") for x, b, n in CONTRACT_SSD]
    x, b, n = CONTRACT_SSD_STEP4
    insts.append((ssd_kernel.meta_instance(getattr(torch, x), getattr(torch, b), 4, 1, 8, 4, 6, n),
                  f"ssd step {x}/{b} N={n} P=6"))
    insts += [(gqa_kernel.meta_instance(getattr(torch, d), dh, g, (1, 1, 1)),
               f"gqa_decode {d} Dh={dh} G={g}") for d, dh, g in CONTRACT_GQA]
    insts += [(fused_rnn.meta_instance(T, B, d, H, io_dtype=torch.float32,
                                       w_dtype=getattr(torch, w), ng=ng, stack=stack, taps=taps),
               f"fused_rnn fp32 T={T} B={B} d={d} H={H} {w} ng={ng} stack={stack} taps={taps}")
              for T, B, d, H, w, ng, stack, taps in CONTRACT_SIMT]
    for inst, where in insts:
        card = smem.card_instance(inst)
        model = {k: inst[k] for k in card}
        require(card == model, f"contracts: {inst['kernel']} at {where}: the card reports "
                               f"{card}, the H100 model {model}")
        require(smem.fits(inst), f"contracts: {inst['kernel']} at {where} does not fit")
        emit({"phase": "contracts", "instance": inst["kernel"], "at": where, **model,
              "smem_static": inst["smem_static"], "threads": inst["threads"],
              "grid": inst["grid"], "cluster": inst["cluster"],
              "smem_ceiling": smem.SMEM_CEILING})
    emit(_contract_scheduler(ledger))
    return None


def phase_dryrun():
    """``launch/dryrun.py``'s rank held on the card: for each of
    DRYRUN_CELLS the meta run of rank (0, 0) (the only class of local
    shapes, checked from the specs), then the same rank's step on the card
    at the same local shapes under the same virtual rank, on random shards,
    eager: the inputs' shapes and dtypes equal, the collectives (op, count,
    bytes, total and entry) and each kernel's launches equal to the meta
    run's, finite logits, the peak memory beyond the arguments within
    DRYRUN_TEMP_RTOL plus DRYRUN_TEMP_ALLOWANCE of the meta run's temp
    bytes, and ms a step on the host clock (one rank, no communication).
    Every kernel's count is set to 0 just before the measured step and read
    just after. Returns the launches."""
    counters = _launch_counters()
    totals = dict.fromkeys(KERNELS, 0)
    for cell in DRYRUN_CELLS:
        line, launches = _dryrun_cell(*cell, counters)
        emit(line)
        for k, n in launches.items():
            totals[k] += n
    emit({"phase": "dryrun", "launches": totals})
    return totals


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
            continuous = results.get("continuous") or {}
            speculative = results.get("speculative") or {}
            telemetry = results.get("telemetry") or {}
            train = results.get("train") or {}
            checkpoint = results.get("checkpoint") or {}
            sharded = results.get("sharded") or {}
            dry = results.get("dryrun") or {}
            for name, s in summaries.items():
                s["launches"] = (launches[name] + continuous.get(name, 0)
                                 + speculative.get(name, 0) + telemetry.get(name, 0)
                                 + train.get(name, 0) + checkpoint.get(name, 0)
                                 + sharded.get(name, 0) + dry.get(name, 0))
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
