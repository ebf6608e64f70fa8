#!/usr/bin/env python3
"""Time the decode-attention kernel (B5) of one source tree on the card.

    python3 bench_b5.py                          # this tree
    python3 bench_b5.py --tree build/parent --out build/b5_parent.jsonl

For each case of ``chip_smoke.GQA_CASES`` (same shapes, same seeds) it runs
the tree's ``repro_torch.kernels.gqa_decode.ops.gqa_decode``, holds it to
the plain version at ``chip_smoke``'s B5 tolerance, and times it L2-warm
(``ms``) and with the L2 flushed before each call (``cold_ms``), beside one
``scaled_dot_product_attention`` call on the same data (``sdpa_ms``) and the
bytes bound. A case the tree refuses is reported as refused. To compare two
trees, run them in turns in one process chain on one card (A, B, B, A): one
JSON line per case, then the card's name and power limit. With ``--sweep``
each case is also timed at forced split counts (the wrapper's ``plan``
replaced), to read how the time moves with the number of splits.
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
    ap.add_argument("--sweep", default="", help="comma-separated split counts to force")
    args = ap.parse_args(argv)
    tree = pathlib.Path(args.tree).resolve()
    sys.path.insert(0, str(tree / "src"))

    import torch

    if not torch.cuda.is_available():
        print("bench_b5: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.gqa_decode.ops import gqa_decode
    from repro_torch.kernels.gqa_decode.ref import gqa_decode_ref

    l2 = torch.empty(cs.L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    lines = []
    for i, (name, shape, dtype) in enumerate(cs.GQA_CASES):
        _, args_, _, rw, ops = cs._gqa_case(name, *shape, dtype, 400 + i)
        row = {"tree": str(tree), "case": name, "dtype": dtype}
        try:
            out = gqa_decode(*args_)
        except ValueError as e:
            row["refused"] = str(e)
            lines.append(row)
            print(json.dumps(row), flush=True)
            continue
        ref = gqa_decode_ref(*args_)
        torch.cuda.synchronize()
        err, tol, finite = cs.compare((out,), (ref,), cs.B5_ATOL)
        row.update(max_abs_err=err, tol=tol, ok=bool(finite and err <= tol))
        row["ms"] = cs.time_ms(lambda: gqa_decode(*args_), iters=args.iters)
        row["cold_ms"] = cs.time_ms(lambda: gqa_decode(*args_), iters=args.iters,
                                    flush=l2.zero_)
        row["sdpa_ms"] = cs.time_ms(cs._sdpa(*args_), iters=args.iters)
        row["bound_ms"], row["bound_by"] = cs.bound(rw, ops, dtype)
        lines.append(row)
        print(json.dumps(row), flush=True)
        for n in (int(x) for x in args.sweep.split(",") if x):
            lines.append(_forced(name, args_, n, args.iters))
            print(json.dumps(lines[-1]), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            for row in lines:
                f.write(json.dumps({**row, "card": card.strip()}) + "\n")
    return 0 if all(r.get("ok", True) for r in lines) else 1


def _forced(name, args_, n_split, iters):
    """One case timed with ``n_split`` splits (whole tiles), the tree's
    own plan otherwise, held to the plain version as above."""
    from repro_torch.kernels.gqa_decode import gqa_decode as gk
    from repro_torch.kernels.gqa_decode.ops import gqa_decode
    from repro_torch.kernels.gqa_decode.ref import gqa_decode_ref

    own = gk.plan

    def forced(dtype, batch, n_kv, seq, head_dim, group, device_index=0):
        tile = gk.instance_info(dtype, head_dim, group)["tile_rows"]
        rows = -(-(-(-seq // n_split)) // tile) * tile
        return -(-seq // rows), rows, own(dtype, batch, n_kv, seq, head_dim, group)[2]

    gk.plan = forced
    try:
        out = gqa_decode(*args_)
        err, tol, finite = cs.compare((out,), (gqa_decode_ref(*args_),), cs.B5_ATOL)
        ms = cs.time_ms(lambda: gqa_decode(*args_), iters=iters)
        q, k = args_[0], args_[1]
        got = forced(q.dtype, q.shape[0], k.shape[2], k.shape[1], q.shape[2],
                     q.shape[1] // k.shape[2])[0]
    finally:
        gk.plan = own
    return {"case": name, "forced_splits": got, "ms": ms, "max_abs_err": err,
            "ok": bool(finite and err <= tol)}


if __name__ == "__main__":
    sys.exit(main())
