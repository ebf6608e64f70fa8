#!/usr/bin/env python3
"""Sequence parallelism on the card: the dry run's ``nemotron-4-340b``
``train_4k`` rank of the pod at 2 layers, its step run eagerly on the card.

    python3 bench_sp.py [--layers 2] [--out build/bench_sp]

The rank is (0, 0) of the (16, 16) pod mesh (``launch/dryrun.py``; every
rank holds its local shapes), under ``launch/mesh.py::virtual_mesh``: no
collective communicates, each returns the rank's own operand tiled or
copied. First the meta run: the cell's record with its probes (``--out``
/record.json) and the full step measured with each storage rounded to the
caching allocator's 512-byte blocks (the prediction). Then the same step on
the card, from random shards (seed ``chip_smoke.DRYRUN_SEED``; moments and
step zero, masks one): a warm-up step, then the measured one. Checks: the
card's inputs are the meta run's local shapes and dtypes; the collectives
(op, count, bytes; total and entry) are the meta run's; no kernel of ours
launches (training runs ``chunked_attention``); the loss is finite; the
peak beyond the arguments is within ``DRYRUN_TEMP_RTOL`` plus
``DRYRUN_TEMP_ALLOWANCE`` of the meta run's temp bytes. Then ms a step (the
host clock over ``chip_smoke.DRYRUN_STEPS`` steps) and the card's name and
power limit. One JSON line on stdout (and ``--out``/bench_sp.jsonl); a
failed check exits 1.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import subprocess
import sys
import time

import chip_smoke as cs

ARCH, SHAPE, MESH = "nemotron-4-340b", "train_4k", "pod"


def _fill(cfg, gen):
    """The card's filler of the train rank's inputs (``dryrun.meta_fill``'s
    contract): params small normals from ``gen``, moments and the step
    zero, token ids in the vocab, masks one."""
    import torch

    def fill(like, role):
        if role == "step" or role.startswith("moment/"):
            return torch.zeros(like.shape, dtype=like.dtype, device="cuda")
        if role in ("inputs/inputs", "inputs/targets"):
            return torch.randint(0, cfg.vocab, like.shape, generator=gen, device="cuda",
                                 dtype=like.dtype)
        if role == "inputs/mask":
            return torch.ones(like.shape, dtype=like.dtype, device="cuda")
        return (torch.randn(like.shape, generator=gen, device="cuda") * 0.02).to(like.dtype)

    return fill


def run(layers: int, out_dir: pathlib.Path) -> dict:
    import torch

    from repro_torch.configs import shapes
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import recorded_collectives, virtual_mesh
    from repro_torch.tree import flatten_with_paths

    cfg, shape = get_config(ARCH).with_(n_layers=layers), shapes.SHAPES[SHAPE]
    classes = dryrun.rank_classes(cfg, shape, dryrun.MESHES[MESH])
    cs.require(len(classes) == 1, f"bench_sp: {len(classes)} classes of ranks")
    mesh = virtual_mesh(dryrun.MESHES[MESH], classes[0][0])
    what = f"bench_sp {ARCH} {SHAPE} {MESH} at {layers} layers"

    t0 = time.perf_counter()
    record = dryrun.run_train_cell(cfg, shape, mesh, True)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "record.json").write_text(json.dumps(record, indent=1))
    meta_step = dryrun.STEPS["train"](cfg, shape, mesh)
    meta = dryrun.measure(meta_step.fn, meta_step.args, mesh, arg_bytes=meta_step.arg_bytes,
                          output_bytes=meta_step.output_bytes, block=512)
    meta_s = time.perf_counter() - t0

    gen = torch.Generator(device="cuda").manual_seed(cs.DRYRUN_SEED)
    step = dryrun.STEPS["train"](cfg, shape, mesh, fill=_fill(cfg, gen))
    got = [(p, tuple(x.shape), x.dtype) for p, x in flatten_with_paths(dict(enumerate(step.args)))]
    want = [(p, tuple(x.shape), x.dtype)
            for p, x in flatten_with_paths(dict(enumerate(meta_step.args)))]
    cs.require(got == want, f"{what}: the card's inputs are not the meta run's local shapes")
    args_bytes = sum(math.prod(s) * torch.empty((), dtype=d).element_size() for _, s, d in got)
    counters = cs._launch_counters()
    step.fn(*step.args)  # warm-up: cuBLAS workspaces
    torch.cuda.synchronize()
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    with recorded_collectives(mesh) as log:
        _, loss = step.fn(*step.args)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t1) * 1e3
    peak = torch.cuda.max_memory_allocated() - base
    launches = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
    loss = float(loss)
    cs.require(math.isfinite(loss), f"{what}: loss {loss} not finite")
    coll = {"total": dryrun._coll(log, False), "entry": dryrun._coll(log, True)}
    for k in ("total", "entry"):
        cs.require(coll[k] == meta[f"collectives_{k}"],
                   f"{what}: collectives {k} {coll[k]} != the meta run's "
                   f"{meta[f'collectives_{k}']}")
    cs.require(not any(launches.values()) and not meta["kernels"],
               f"{what}: launches {launches} / meta calls {meta['kernels']}: none expected")
    temp = meta["memory"]["temp_bytes"]
    tol = cs.DRYRUN_TEMP_RTOL * temp + cs.DRYRUN_TEMP_ALLOWANCE
    cs.require(abs(peak - temp) <= tol,
               f"{what}: peak {peak} B beyond the arguments, predicted {temp} B (tolerance {tol})")
    t2 = time.perf_counter()
    for _ in range(cs.DRYRUN_STEPS):
        step.fn(*step.args)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t2) / cs.DRYRUN_STEPS * 1e3
    block_mem = record["probes"]["block_mem"]["memory"]
    return {"bench": "sp", "cell": f"{ARCH} {SHAPE} {MESH}", "layers": layers,
            "rank": classes[0][0], "ranks_checked": classes[0][1],
            "note": "one rank, no communication: the virtual rank's collectives return its "
                    "own operand tiled or copied (shape-true, not the mesh's values)",
            "loss": loss, "ms_per_step": ms, "measured_step_ms": first_ms, "meta_s": meta_s,
            "args_bytes": args_bytes, "argument_bytes": meta["memory"]["argument_bytes"],
            "peak_bytes_beyond_args": peak, "predicted_temp_bytes": temp,
            "temp_tolerance_bytes": tol, "peak_tensors": meta["memory"]["peak_tensors"],
            "launches": launches, "collectives": coll["total"]["counts"],
            "collective_bytes": {k: v for k, v in coll["total"].items()
                                 if k not in ("count", "counts") and v},
            "block_mem_probe_temp_bytes": block_mem["temp_bytes"],
            "flops": meta["cost"]["flops"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--out", default="build/bench_sp",
                    help="directory of the record (record.json) and the line (bench_sp.jsonl)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("bench_sp: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    out_dir = pathlib.Path(args.out)
    try:
        line = run(args.layers, out_dir)
    except cs.SmokeFailure as e:
        print(f"bench_sp: FAILED: {e}", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(json.dumps(line), flush=True)
    print(card, flush=True)
    with open(out_dir / "bench_sp.jsonl", "a") as f:
        f.write(json.dumps({**line, "card": card}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
