"""Quickstart: train a tiny SRU language model and generate from it.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The port's ``examples/quickstart.py``: the same config, 60 train steps and
greedy generation (a 16-token prompt through ``lm_prefill``, then 24
``lm_decode_step``s), eagerly, on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs.registry import get_config
from repro_torch.data import make_pipeline
from repro_torch.launch.train import batch_to_device
from repro_torch.models import lm
from repro_torch.models.layers import resolve_device
from repro_torch.training.steps import build_train_step, init_train_state

STEPS, BATCH, SEQ = 60, 8, 128
PROMPT, GEN = 16, 24


def make_cfg():
    """The paper's SRU cell, LM-wrapped, laptop-sized."""
    return get_config("sru-paper-small").with_(
        n_layers=2, d_model=128, rnn_hidden=128, vocab=256, mts_block_size=16
    )


def train_and_generate(cfg, state, device, steps: int = STEPS, say=print):
    """``steps`` train steps of ``state`` (base lr 1e-3 on a 60-step cosine
    schedule) on the pipeline's batches, printing JAX's lines; then greedy
    generation from ``batch_at(999)``'s first row. Returns ``(state, losses,
    prompt, tokens)``: every step's loss, the prompt's last 8 ids and the
    25 generated ids."""
    step_fn = build_train_step(cfg, None, base_lr=1e-3, total_steps=STEPS)
    pipe = make_pipeline(cfg, batch=BATCH, seq_len=SEQ)
    losses = []
    for step in range(steps):
        state, metrics = step_fn(state, batch_to_device(pipe.batch_at(step), device))
        losses.append(float(metrics["loss"]))
        if step % 10 == 0 or step == steps - 1:
            say(f"step {step:3d}  loss {losses[-1]:.4f}")

    # greedy generation through prefill + MTS decode
    prompt = torch.from_numpy(pipe.batch_at(999)["inputs"][:1, :PROMPT]).to(device)
    with torch.inference_mode():
        caches = lm.lm_init_caches(cfg, 1, max_len=48, device=device)
        logits, caches = lm.lm_prefill(state.params, cfg, {"inputs": prompt}, caches)
        tok = torch.argmax(logits[:, -1, :cfg.vocab], -1)[:, None]
        toks = [int(tok[0, 0])]
        for _ in range(GEN):
            logits, caches = lm.lm_decode_step(state.params, cfg, caches, tok)
            tok = torch.argmax(logits[:, -1, :cfg.vocab], -1)[:, None]
            toks.append(int(tok[0, 0]))
    tail = [int(t) for t in prompt[0][-8:]]
    say("prompt:", tail)
    say("generated:", toks)
    return state, losses, tail, toks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default) runs the CUDA kernels; cpu their plain versions")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = make_cfg()
    print(f"arch={cfg.name} params≈{cfg.num_params()/1e6:.2f}M "
          f"(MTS block={cfg.mts_block_size}, engine={cfg.scan_engine})")
    state = init_train_state(torch.Generator(device=device).manual_seed(0), cfg, device=device)
    train_and_generate(cfg, state, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
