"""Serving driver of the port, batch mode (``repro/launch/serve.py``).

One batched prefill, then ``--gen-len`` greedy decode steps, all lanes in
lockstep. Runs on the card unless ``--device cpu`` is given:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch sru-paper-large-stacked \\
        --batch 4 --prompt-len 64 --gen-len 32

    PYTHONPATH=src python -m repro_torch.launch.serve --arch sru-paper-large-stacked \\
        --reduced --device cpu

``--engine`` overrides ``cfg.scan_engine`` with any of the six engines of
the JAX ``launch/serve.py`` (``ENGINE_MATRIX``); an unknown one exits with
the list (``validate_engine``, the engine check of the JAX
``validate_engine_mesh`` without its mesh parts). LSTM ignores the engine.
Continuous mode and the other flags of the JAX ``launch/serve.py`` wait for
later slices. Besides the two
human-readable lines, the run prints one ``serve-stats {json}`` line with
its timings and tokens.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.configs.registry import get_config
from repro_torch.models import lm
from repro_torch.models.layers import _dtype, resolve_device
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
    """Fail fast on an engine the port does not serve, naming the engines."""
    if cfg.scan_engine not in ENGINES:
        raise SystemExit(
            f"serve: unknown engine {cfg.scan_engine!r} (from --engine or the "
            f"{cfg.name!r} config)\n{_matrix_lines()}"
        )


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_batch(cfg, params, args, device: torch.device) -> dict:
    """The lockstep path: one prefill, ``gen_len - 1`` decode steps. Returns
    the timings and the generated tokens."""
    max_len = args.prompt_len + args.gen_len
    prefill = build_prefill_step(cfg, batch=args.batch, max_len=max_len, device=device)
    decode = build_decode_step(cfg)
    gen = torch.Generator().manual_seed(args.seed)
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len), generator=gen)
    inputs = {"inputs": prompt.to(device)}

    _sync(device)
    t0 = time.perf_counter()
    logits, caches = prefill(params, inputs)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    tok = torch.argmax(logits[:, -1, : cfg.vocab], dim=-1)[:, None]
    out_tokens = [tok]
    t0 = time.perf_counter()
    for _ in range(args.gen_len - 1):
        logits, caches = decode(params, caches, tok)
        tok = torch.argmax(logits[:, -1, : cfg.vocab], dim=-1)[:, None]
        out_tokens.append(tok)
    _sync(device)
    t_decode = time.perf_counter() - t0
    tokens = torch.cat(out_tokens, dim=1).cpu()
    n_dec = args.gen_len - 1
    return {
        "arch": cfg.name,
        "device": str(device),
        "prefill_ms": t_prefill * 1e3,
        "decode_ms": t_decode * 1e3,
        "prefill_tok_s": args.batch * args.prompt_len / max(t_prefill, 1e-9),
        "decode_tok_s": args.batch * n_dec / max(t_decode, 1e-9),
        "decode_steps": n_dec,
        "tokens": tokens.tolist(),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
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
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="cuda (default) runs the CUDA kernels; cpu runs their plain versions",
    )
    args = ap.parse_args(argv)
    if args.gen_len < 1 or args.prompt_len < 1 or args.batch < 1:
        ap.error("--batch, --prompt-len and --gen-len must be >= 1")

    cfg = get_config(args.arch)
    if args.engine:
        cfg = cfg.with_(scan_engine=args.engine)
    validate_engine(cfg)
    device = resolve_device(args.device)
    if args.reduced:
        cfg = cfg.reduced()
    params = lm.lm_init(torch.Generator().manual_seed(args.seed), cfg, device=device)
    # Cast the fp32 params to the compute dtype once. The JAX package casts
    # inside every step (models/lm.py::_run_layers); the values are the same,
    # and the per-step casts in the port's lm.py are then no-ops.
    params = lm._cast_params(params, _dtype(cfg.compute_dtype))

    stats = run_batch(cfg, params, args, device)
    print(f"prefill: {args.batch}x{args.prompt_len} in {stats['prefill_ms']:.1f}ms "
          f"({stats['prefill_tok_s']:.0f} tok/s)")
    print(f"decode:  {stats['decode_steps']} steps in {stats['decode_ms']:.1f}ms "
          f"({stats['decode_tok_s']:.0f} tok/s)")
    print("sample tokens:", stats["tokens"][0][:16])
    print("serve-stats " + json.dumps(stats))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
