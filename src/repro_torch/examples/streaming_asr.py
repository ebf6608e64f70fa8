"""The paper's deployment scenario: single-stream, real-time RNN inference.

The port's ``examples/streaming_asr.py``. An on-device ASR acoustic model
receives one feature frame at a time. Naive (SRU-1) processing does a
matrix-VECTOR product per frame: every weight byte fetched per step. The
MTS schedule buffers ``n`` frames (adding n·frame_period latency) and
processes them with matrix-MATRIX products: one weight fetch per n steps
(paper Sec. 3).

Both schedules run on a live stream through the stack-level serving API
(``models/rnn.py::rnn_stack_prefill``, the code path of ``launch/serve.py``
and the continuous-batching engine), with two engines:

  * ``sequential``: the per-step scan in plain PyTorch (the paper's
    baseline schedule);
  * ``fused``: the whole-layer kernel (B1, ``kernels/fused_rnn``): gate
    GEMM, recurrence and highway per block. On the card each block step is
    one CUDA graph replay (``training/graphs.py::capture``); on the CPU the
    kernel's plain version runs eagerly.

Each engine's SRU-n output is checked against its SRU-1 output (MTS must
not change the math): bitwise, but for the (engine, device) pairs in
``MTS_BOUNDS``, held to their measured bound; the engines are
cross-checked within 1e-4.

    PYTHONPATH=src python -m repro_torch.examples.streaming_asr [--frames 1024] \\
        [--width 256] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import rnn
from repro_torch.models.layers import resolve_device
from repro_torch.training import graphs
from repro_torch.tree import tree_map

# (engine, device type) -> the largest |SRU-n - SRU-1| allowed where the two
# are not bitwise (ROADMAP §C): the gate product of n rows is rounded
# otherwise than of one row. On the CPU B1's plain version
# (``fused_rnn_ref``): 1.91e-6 at the defaults, 3.81e-6 at width 1024 and 4
# layers. On the H100 cuBLAS's n-row products under ``sequential`` and B1
# under ``fused``: 1.91e-6 each at the defaults. ``sequential`` on the CPU
# is bitwise.
MTS_BOUNDS = {("fused", "cpu"): 1e-5, ("sequential", "cuda"): 1e-5, ("fused", "cuda"): 1e-5}
ENGINE_TOL = 1e-4


def make_cfg(width: int, layers: int, engine: str, block: int) -> ArchConfig:
    return ArchConfig(
        name="asr-demo",
        family="rnn",
        n_layers=layers,
        d_model=width,
        rnn_hidden=width,
        vocab=256,
        cell="sru",
        mts_block_size=block,
        scan_engine=engine,
        param_dtype="float32",
        compute_dtype="float32",
    )


def init_params(cfg, device, seed: int = 0):
    """The stack's params (every leaf with a leading (n_layers,) dim), drawn
    on ``device`` from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    per = [rnn.rnn_block_init(gen, cfg, torch.float32, device) for _ in range(cfg.n_layers)]
    return tree_map(lambda *xs: torch.stack(xs), *per)


def init_cache(cfg, device):
    return {k: torch.zeros((cfg.n_layers, *shape), dtype=dtype, device=device)
            for k, (shape, dtype) in rnn.rnn_cache_shapes(cfg, 1, torch.float32).items()}


def _block_step(cfg, params, x0, device):
    """One block of ``x0``'s shape through the stack: on the card a captured
    CUDA graph (warmed up first), on the CPU the eager step (run once)."""

    def step(p, x, cache):
        return rnn.rnn_stack_prefill(p, cfg, x, cache)

    if device.type != "cuda":
        with torch.inference_mode():
            step(params, x0, init_cache(cfg, device))  # the warm-up, as JAX's compile call

        def eager(p, x, cache):
            with torch.inference_mode():
                return step(p, x, cache)

        return eager
    graphs.warm_up(step, params, x0.clone(), init_cache(cfg, device))
    return graphs.capture(step, params, x0.clone(), init_cache(cfg, device))


def run(params, stream, *, layers: int, blocks, engines, device, frame_ms: float = 10.0,
        say=print):
    """Every (engine, n) of the stream (1, frames, width) through
    ``rnn_stack_prefill`` n frames at a time, printing JAX's lines. Returns
    ``{(engine, n): (seconds, output as numpy)}``."""
    frames, width = stream.shape[1], stream.shape[2]
    results = {}
    for engine in engines:
        for n in blocks:
            cfg = make_cfg(width, layers, engine, n)
            process_block = _block_step(cfg, params, stream[:, :n], device)
            cache = init_cache(cfg, device)
            outs = []
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            for i in range(0, frames, n):
                h, cache = process_block(params, stream[:, i:i + n], cache)
                outs.append(h.clone())  # a replay overwrites its outputs
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            out = torch.cat(outs, 1).cpu().numpy()
            results[(engine, n)] = (dt, out)
            rt_factor = (frames * frame_ms / 1e3) / dt
            say(
                f"{engine:>10} SRU-{n:<3d}: {dt*1e3:8.1f} ms for {frames} "
                f"frames ({frames/dt:7.0f} frames/s, {rt_factor:6.1f}x "
                f"realtime, buffering latency {n*frame_ms:.0f} ms)"
            )
    return results


def check(results, blocks, engines, device, say=print):
    """MTS must not change the math: SRU-n against SRU-1 per engine,
    bitwise (``MTS_BOUNDS``: within the pair's bound); the engines within
    ``ENGINE_TOL`` of each other. Returns the errors ``{(engine, n): max
    |err|}``."""
    errs = {}
    for engine in engines:
        base = results[(engine, blocks[0])][1]
        bound = MTS_BOUNDS.get((engine, device.type))
        for n in blocks[1:]:
            same = np.array_equal(results[(engine, n)][1], base)
            err = float(np.max(np.abs(results[(engine, n)][1] - base)))
            errs[(engine, n)] = err
            say(f"{engine}: SRU-{n} vs SRU-{blocks[0]}: "
                f"{'bitwise' if same else f'max |err| = {err:.2e}'}")
            if not (same if bound is None else err <= bound):
                raise AssertionError(f"{engine}: MTS changed the math!"
                                     + ("" if bound is None else f" (beyond {bound:.1e})"))

    # Engines agree on the function (fp32 reassociation tolerance only).
    if len(engines) > 1:
        ref = results[(engines[0], blocks[0])][1]
        for engine in engines[1:]:
            err = float(np.max(np.abs(results[(engine, blocks[0])][1] - ref)))
            say(f"{engine} vs {engines[0]}: max |err| = {err:.2e}")
            if not err < ENGINE_TOL:
                raise AssertionError("engines disagree!")
    return errs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=1024)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--blocks", type=int, nargs="+", default=[1, 8, 32])
    ap.add_argument("--engines", nargs="+", default=["sequential", "fused"])
    ap.add_argument("--frame-ms", type=float, default=10.0, help="frame period")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default) runs B1 and CUDA graphs; cpu the plain versions")
    args = ap.parse_args(argv)
    for n in args.blocks:
        if args.frames % n:
            ap.error(f"--frames must be a multiple of block {n}")
    device = resolve_device(args.device)

    cfg0 = make_cfg(args.width, args.layers, "sequential", 1)
    params = init_params(cfg0, device)
    gen = torch.Generator(device=device).manual_seed(1)
    stream = torch.randn((1, args.frames, args.width), generator=gen, device=device)

    results = run(params, stream, layers=args.layers, blocks=args.blocks, engines=args.engines,
                  device=device, frame_ms=args.frame_ms)
    check(results, args.blocks, args.engines, device)
    t1 = results[(args.engines[0], args.blocks[0])][0]
    tn = results[(args.engines[0], args.blocks[-1])][0]
    print(f"speedup SRU-{args.blocks[-1]} vs SRU-{args.blocks[0]} "
          f"({args.engines[0]}): {t1/tn*100:.0f}%")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
