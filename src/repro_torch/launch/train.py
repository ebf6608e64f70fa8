"""Training entry point of the port (``repro/launch/train.py``), with its
flags and log lines, plus ``--device``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch sru-paper-large-stacked \\
        --steps 100 --batch 8 --seq 256

    PYTHONPATH=src python -m repro_torch.launch.train --arch sru-paper-large-stacked \\
        --reduced --device cpu --steps 4

It runs on the card unless ``--device cpu`` is given, and raises where there
is no card. Each step is the eager train step of ``training/steps.py``
(microbatched grads, optional ``--compression bf16|int8``, clip, AdamW,
cosine schedule), wrapped in the ``StepMonitor``; atomic checkpoints every
``--save-every`` steps (``checkpoint/manager.py``, the JAX package's
format), ``--resume auto`` restart-exact with the data stream, and SIGTERM
saves a checkpoint and exits 0 (``runtime/preemption.py``). The params are
fp32 masters (``cfg.param_dtype``) drawn from a generator on the device
seeded with ``--seed``; the layers compute in ``cfg.compute_dtype``.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.registry import get_config
from repro_torch.data import make_pipeline
from repro_torch.models.layers import resolve_device
from repro_torch.runtime import PreemptionHandler, StepMonitor
from repro_torch.training.steps import build_train_step, init_train_state


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reduced", action="store_true", help="use the smoke-size config")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--resume", default=None, help="'auto' or a step number")
    ap.add_argument("--compression", default=None, choices=[None, "bf16", "int8"])
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="cuda (default) runs the CUDA kernels; cpu runs their plain versions",
    )
    return ap.parse_args(argv)


def batch_to_device(batch, device):
    """A pipeline batch (numpy) as tensors on ``device``, dtypes kept."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = cfg.with_(microbatches=min(cfg.microbatches, max(1, args.batch // 2)))

    pipeline = make_pipeline(cfg, args.batch, args.seq, seed=args.seed)
    step_fn = build_train_step(
        cfg, base_lr=args.lr, warmup=args.warmup, total_steps=args.steps,
        compression=args.compression,
    )

    ckpt = CheckpointManager(args.checkpoint_dir) if args.checkpoint_dir else None
    start_step = 0
    state = init_train_state(torch.Generator(device=device).manual_seed(args.seed), cfg,
                             args.compression, device=device)
    if ckpt and args.resume:
        step = ckpt.latest_step() if args.resume == "auto" else int(args.resume)
        if step is not None:
            state, data_state = ckpt.restore(step, state)
            start_step = step
            print(f"[resume] step {step}")

    preempt = PreemptionHandler()
    monitor = StepMonitor()
    history = []
    t_start = time.perf_counter()
    try:
        for step in range(start_step, args.steps):
            batch = batch_to_device(pipeline.batch_at(step), device)
            monitor.start()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            m = monitor.stop(step)
            history.append({"step": step, "loss": loss,
                            **{k: float(v) for k, v in metrics.items() if k != "loss"}})
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"step {step:5d} loss {loss:.4f} gnorm {float(metrics['grad_norm']):.3f} "
                      f"lr {float(metrics['lr']):.2e} dt {m['step_time']*1e3:.0f}ms")
            if ckpt and ((step + 1) % args.save_every == 0 or preempt.requested):
                ckpt.save(step + 1, state, pipeline.state())
                if preempt.requested:
                    print("[preempt] checkpoint saved; exiting cleanly")
                    return 0
    finally:
        preempt.uninstall()
    if ckpt:
        ckpt.save(args.steps, state, pipeline.state())
    wall = time.perf_counter() - t_start
    tokens = (args.steps - start_step) * args.batch * args.seq
    print(f"done: {wall:.1f}s, {tokens/max(wall,1e-9):.0f} tok/s, "
          f"straggler events: {len(monitor.events)}")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(history, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
