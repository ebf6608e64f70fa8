#!/usr/bin/env python3
"""Time the chunked SSD kernel (B4) of one source tree on the card.

    python3 bench_b4.py                          # this tree
    python3 bench_b4.py --tree build/parent --out build/b4_parent.jsonl

For each case of ``chip_smoke.SSD_CASES`` (same shapes, same seeds) it runs
the tree's ``repro_torch.kernels.ssd.ops.ssd``, holds it to the plain
version at ``chip_smoke``'s B4 tolerance, and times it L2-warm (``ms``) and
with the L2 flushed before each call (``cold_ms``), beside the bound and
the bound at the fp32 CUDA-core rate (``simt_bound_ms``). To compare two
trees, run them in turns in one process chain on one card (A, B, B, A): one
JSON line per case, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

import chip_smoke as cs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(cs.ROOT), help="root of the tree whose src/ to time")
    ap.add_argument("--out", default=None, help="also write the lines to this file")
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    tree = pathlib.Path(args.tree).resolve()
    sys.path.insert(0, str(tree / "src"))

    import torch

    if not torch.cuda.is_available():
        print("bench_b4: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    l2 = torch.empty(cs.L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    lines = []
    for name, shape, kw in cs.SSD_CASES:
        _, args_, call_kw, rw, ops = cs._ssd_case(name, *shape, **kw)
        dtype = shape[6]
        ref = cs._ssd_plain_call(*args_, **call_kw)
        out = cs._ssd_kernel_call(*args_, **call_kw)
        torch.cuda.synchronize()
        err, tol, finite = cs.compare(out, ref, 0.0, cs.B4_RTOL)
        row = {"tree": str(tree), "case": name, "dtype": dtype, "max_abs_err": err, "tol": tol,
               "ok": bool(finite and err <= tol)}
        row["ms"] = cs.time_ms(lambda: cs._ssd_kernel_call(*args_, **call_kw), iters=args.iters)
        row["cold_ms"] = cs.time_ms(lambda: cs._ssd_kernel_call(*args_, **call_kw),
                                    iters=args.iters, flush=l2.zero_)
        row["bound_ms"], row["bound_by"] = cs.bound(rw, ops, dtype)
        row["simt_bound_ms"] = cs.bound(rw, ops, "float32")[0]
        lines.append(row)
        print(json.dumps(row), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            for row in lines:
                f.write(json.dumps({**row, "card": card.strip()}) + "\n")
    return 0 if all(r["ok"] for r in lines) else 1


if __name__ == "__main__":
    sys.exit(main())
