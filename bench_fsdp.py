#!/usr/bin/env python3
"""Measure one source tree's FSDP train step on the card: each rank's peak
memory and its largest all_gather over "data".

    python3 bench_fsdp.py                        # this tree
    python3 bench_fsdp.py --tree build/parent --out build/fsdp_parent.jsonl

It runs the FSDP run of ``chip_smoke.SHARDED_TRAIN_RUNS`` (smollm-360m at
full width cut to 8 layers, on (data 2, model 1), fp32, TF32 off,
``TRAIN_BATCH`` x ``TRAIN_SEQ`` tokens a step) through
``chip_smoke._sharded_train_rank`` on two gloo ranks sharing the card,
importing ``repro_torch`` from the tree's ``src/``: ``SHARDED_TRAIN_STEPS``
steps from seed 0, the peak of ``torch.cuda.max_memory_allocated`` over the
steps in each rank's process (the state already sharded), the largest
all_gather over "data" (of all and of the layer leaves, by the bytes it
puts out), the losses and ms a step. To compare two trees, run them in turns on one card (A, B, B, A): one
JSON line per tree and run, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import pickle
import subprocess
import sys
import tempfile

import chip_smoke as cs

RUN = next(r for r in cs.SHARDED_TRAIN_RUNS if r[0] == "smollm-360m")


def _rank(rank, world, init_file, out_dir, src):
    sys.path.insert(0, src)  # ahead of the checkout's own, which chip_smoke's import put first
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import GROUP_TIMEOUT

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=world,
                            timeout=GROUP_TIMEOUT)
    try:
        res = cs._sharded_train_rank(*RUN, torch.device("cuda", 0), cs._launch_counters(),
                                     keep_params=False)
    finally:
        dist.destroy_process_group()
    import repro_torch

    assert pathlib.Path(repro_torch.__file__).is_relative_to(src), repro_torch.__file__
    res.pop("params")
    with open(pathlib.Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(cs.ROOT), help="root of the tree whose src/ to run")
    ap.add_argument("--out", default=None, help="also write the line to this file")
    args = ap.parse_args(argv)
    tree = pathlib.Path(args.tree).resolve()
    sys.path.insert(0, str(tree / "src"))

    import torch
    import torch.multiprocessing as mp

    if not torch.cuda.is_available():
        print("bench_fsdp: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch

    assert pathlib.Path(repro_torch.__file__).is_relative_to(tree), repro_torch.__file__
    with tempfile.TemporaryDirectory(prefix="bench-fsdp-") as d:
        mp.start_processes(_rank, args=(2, f"{d}/rdv", d, str(tree / "src")), nprocs=2,
                           start_method="spawn")
        ranks = [pickle.load(open(pathlib.Path(d) / f"rank{r}.pkl", "rb")) for r in range(2)]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    arch, engine, model_axis, fsdp, over = RUN
    row = {"tree": str(tree), "arch": arch, "overrides": over, "mesh": ranks[0]["mesh"],
           "fsdp": fsdp, "steps": cs.SHARDED_TRAIN_STEPS, "batch": cs.TRAIN_BATCH,
           "seq": cs.TRAIN_SEQ, "losses": ranks[0]["losses"],
           "peak_mem_gb_per_rank": [r["peak_mem_gb"] for r in ranks],
           "data_all_gather_bytes_per_rank": [r["data_all_gather_bytes"] for r in ranks],
           "step_ms_per_rank": [r["step_ms"] for r in ranks],
           "note": "gloo ranks sharing one card: the times are not multi-GPU speed"}
    print(json.dumps(row), flush=True)
    print(card, flush=True)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(json.dumps({**row, "card": card}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
