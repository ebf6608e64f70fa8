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

On ranks, JAX's ``make_local_mesh()`` data-parallel mesh (the model axis 1)
over the ranks that exist (``build_train_step``'s data parallelism, FSDP
where the config's ``fsdp`` is on). Inside an initialised process group, or
under ``torchrun``, it joins; on a host with several cards and no group it
starts one rank a card itself (``file://`` rendezvous, as ``serve``); one
card trains on one device, as before. The backend is NCCL on the card, one
rank a card; ranks sharing a card need ``--dist-backend gloo`` (without it
startup refuses, naming the flag), and ``--device cpu`` runs over gloo.
Each rank draws the whole state from the seeded generator and keeps its
shards, builds the global batch and takes its rows. Rank 0 prints (the
mesh and the backend first) and writes the checkpoints, each leaf gathered
whole: the single-device files. A preemption on any rank is all-reduced
each step, so every rank saves the same step and exits 0, and ``--resume
auto`` restores onto whatever mesh runs now (elastic):

    python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        -m repro_torch.launch.train --arch sru-paper-large-stacked --dist-backend gloo
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.registry import get_config
from repro_torch.data import make_pipeline
from repro_torch.launch.mesh import GROUP_TIMEOUT, make_local_mesh, torchrun_world
from repro_torch.models.layers import resolve_device
from repro_torch.runtime import PreemptionHandler, StepMonitor
from repro_torch.training.steps import (build_train_step, init_train_state, shard_train_state,
                                        train_param_specs, train_state_specs)


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
    ap.add_argument(
        "--dist-backend", choices=("nccl", "gloo"), default=None,
        help="torch.distributed backend of the ranks: nccl (default on the card, one rank "
             "per card) or gloo (--device cpu, or ranks sharing a card, only when asked for)",
    )
    return ap.parse_args(argv)


def batch_to_device(batch, device):
    """A pipeline batch (numpy) as tensors on ``device``, dtypes kept."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# Ranks
# ---------------------------------------------------------------------------

_SHARED_CARD = ("train: {world} ranks on this host and {n} card(s): NCCL takes one rank a card; "
                "ranks that share a card run over gloo, and only when asked for with "
                "--dist-backend gloo")


def _backend(args, device: torch.device) -> str:
    backend = args.dist_backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl" and device.type == "cpu":
        raise SystemExit("train: --dist-backend nccl runs on the card; --device cpu trains over "
                         "gloo")
    return backend


def _check_cards(backend: str, local_world: int) -> None:
    """Refuse more NCCL ranks on this host than it has cards."""
    n = torch.cuda.device_count()
    if backend == "nccl" and local_world > n:
        raise SystemExit(_SHARED_CARD.format(world=local_world, n=n))


def _rank_device(args, backend: str) -> torch.device:
    """This rank's device: the CPU, or its card (cards in turn when gloo
    ranks share them)."""
    if args.device == "cpu":
        return torch.device("cpu")
    resolve_device("cuda")
    _check_cards(backend, int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size())))
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    device = torch.device("cuda", local % torch.cuda.device_count())
    torch.cuda.set_device(device)
    return device


def _rank_main(rank: int, world: int, backend: str, init_method: str, argv) -> None:
    """A rank that ``main`` started, one a card: joins the group, trains
    (``main`` sees the group), leaves it."""
    torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=GROUP_TIMEOUT)
    try:
        rc = main(argv)
    finally:
        dist.destroy_process_group()
    if rc:
        raise SystemExit(rc)


def _spawn(argv, args, world: int) -> int:
    """One rank a card (``torch.multiprocessing``, a ``file://`` rendezvous
    in a temporary directory), as ``serve`` starts its ranks."""
    backend = _backend(args, torch.device("cuda"))
    rdv = tempfile.mkdtemp(prefix="train-rdv-")
    try:
        torch.multiprocessing.spawn(_rank_main, nprocs=world,
                                    args=(world, backend, f"file://{rdv}/store", argv))
    finally:
        shutil.rmtree(rdv, ignore_errors=True)
    return 0


def main(argv=None) -> int:
    """The command line (module docstring). Inside an initialised process
    group, or under ``torchrun``, every rank trains on the data-parallel
    mesh; on a host with several cards and no group it starts one rank a
    card itself; otherwise it trains on one device."""
    args = parse_args(argv)
    if dist.is_initialized():
        return _train(args, _rank_device(args, dist.get_backend()))
    if torchrun_world() > 1:
        backend = _backend(args, torch.device(args.device))
        if args.device != "cpu":
            _check_cards(backend, int(os.environ.get("LOCAL_WORLD_SIZE", torchrun_world())))
            resolve_device("cuda")
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0"))
                                  % torch.cuda.device_count())
        dist.init_process_group(backend, timeout=GROUP_TIMEOUT)  # torchrun's env:// rendezvous
        try:
            return _train(args, _rank_device(args, backend))
        finally:
            dist.destroy_process_group()
    device = resolve_device(args.device)
    if device.type == "cuda" and torch.cuda.device_count() > 1:
        return _spawn(sys.argv[1:] if argv is None else list(argv), args,
                      torch.cuda.device_count())
    return _train(args, device)


def _train(args, device: torch.device) -> int:
    """The train loop on ``device``: alone, or as one rank of the
    initialised process group on the (ranks, 1) data-parallel mesh."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = cfg.with_(microbatches=min(cfg.microbatches, max(1, args.batch // 2)))
    mesh = make_local_mesh(device=device) if dist.is_initialized() else None
    lead = mesh is None or dist.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)

    pipeline = make_pipeline(cfg, args.batch, args.seq, seed=args.seed)
    specs = state_specs = None
    if mesh is not None:
        specs = train_param_specs(cfg, mesh, fsdp=cfg.fsdp)
        state_specs = train_state_specs(specs, args.compression)
        say(f"mesh: {mesh.shape}  fsdp: {cfg.fsdp}")
        say(mesh.describe())
    step_fn = build_train_step(
        cfg, mesh=mesh, base_lr=args.lr, warmup=args.warmup, total_steps=args.steps,
        compression=args.compression, specs=specs,
    )

    ckpt = CheckpointManager(args.checkpoint_dir) if args.checkpoint_dir else None
    shardings = None if mesh is None else (mesh, state_specs)
    start_step = 0
    # Every rank draws the whole state from the one seeded generator, then
    # keeps its shards: the single-device init.
    state = init_train_state(torch.Generator(device=device).manual_seed(args.seed), cfg,
                             args.compression, device=device)
    if mesh is not None:
        state = shard_train_state(state, state_specs, mesh)
    if ckpt and args.resume:
        step = ckpt.latest_step() if args.resume == "auto" else int(args.resume)
        if step is not None:
            state, data_state = ckpt.restore(step, state, shardings=shardings)
            start_step = step
            say(f"[resume] step {step}")

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
                say(f"step {step:5d} loss {loss:.4f} gnorm {float(metrics['grad_norm']):.3f} "
                    f"lr {float(metrics['lr']):.2e} dt {m['step_time']*1e3:.0f}ms")
            # One rank's preemption stops them all at the same step.
            stop = (preempt.requested if mesh is None else
                    bool(mesh.host_all_reduce(float(preempt.requested), op="max")))
            if ckpt and ((step + 1) % args.save_every == 0 or stop):
                ckpt.save(step + 1, state, pipeline.state(), shardings=shardings)
            if stop and ckpt:
                say("[preempt] checkpoint saved; exiting cleanly")
                return 0
    finally:
        preempt.uninstall()
    if ckpt:
        ckpt.save(args.steps, state, pipeline.state(), shardings=shardings)
    wall = time.perf_counter() - t_start
    tokens = (args.steps - start_step) * args.batch * args.seq
    say(f"done: {wall:.1f}s, {tokens/max(wall,1e-9):.0f} tok/s, "
        f"straggler events: {len(monitor.events)}")
    if args.metrics_out and lead:
        with open(args.metrics_out, "w") as f:
            json.dump(history, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
