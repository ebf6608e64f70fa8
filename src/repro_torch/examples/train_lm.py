"""End-to-end LM training example (~100M-parameter model).

The port's ``examples/train_lm.py``: a llama-family model on synthetic data
with checkpointing, through the port's train entry point
(``repro_torch.launch.train``), on the card unless ``--device cpu`` is
given:

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300

Without ``--full`` it trains the ~10M model (the same code path:
microbatching, remat, checkpoint/resume, monitor); ``--full`` trains the
100M one.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import registry
from repro_torch.configs.base import ArchConfig
from repro_torch.launch.train import main as train_main


def model_100m() -> ArchConfig:
    return ArchConfig(
        name="llama-100m", family="dense", n_layers=12, d_model=640,
        n_heads=10, n_kv_heads=5, d_head=64, d_ff=1792, vocab=32768,
        mlp_type="swiglu", tie_embeddings=True, microbatches=2,
    )


def model_10m() -> ArchConfig:
    return model_100m().with_(
        name="llama-10m", n_layers=4, d_model=256, n_heads=4, n_kv_heads=2,
        d_ff=704, vocab=2048,
    )


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--full", action="store_true", help="train the 100M model")
    ap.add_argument("--checkpoint-dir", default="checkpoints/train_lm")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default) runs on the card; cpu the plain PyTorch path")
    return ap.parse_args(argv)


def train_argv(args) -> list:
    """``launch.train``'s command line for ``args`` (:func:`parse_args`)."""
    cfg = model_100m() if args.full else model_10m()
    return [
        "--arch", cfg.name, "--steps", str(args.steps),
        "--batch", str(args.batch), "--seq", str(args.seq),
        "--checkpoint-dir", args.checkpoint_dir, "--save-every", "100",
        "--resume", "auto", "--log-every", "20", "--lr", "3e-3",
        "--device", args.device,
    ]


def register(args) -> ArchConfig:
    """The config of ``args`` in the registry, where ``launch.train`` finds it."""
    cfg = model_100m() if args.full else model_10m()
    registry.REGISTRY[cfg.name] = cfg
    return cfg


def main(argv=None) -> int:
    args = parse_args(argv)
    cfg = register(args)
    print(f"training {cfg.name}: {cfg.num_params()/1e6:.1f}M params, "
          f"{args.steps} steps x {args.batch}x{args.seq} tokens")
    return train_main(train_argv(args))


if __name__ == "__main__":
    raise SystemExit(main())
