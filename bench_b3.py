#!/usr/bin/env python3
"""Time the linear-scan kernel (B3) of one source tree on the card.

    python3 bench_b3.py                          # this tree
    python3 bench_b3.py --tree build/parent --out build/b3_parent.jsonl

For each case of ``chip_smoke.SCAN_CASES`` (same shapes, same seeds) it runs
the tree's ``linear_scan_kernel``, holds it to the sequential walk at
``chip_smoke``'s tolerance, and times it L2-warm (``ms``) and with the L2
flushed before each call (``cold_ms``), beside the bound. For each case of
``chip_smoke.SCAN_BWD_CASES`` it times the backward: the tree's one
backward launch where it has ``linear_scan_bwd``, else its reverse-time
kernel call on operands flipped beforehand (``bwd_kernel_ms``, warm and
cold), the forward and that call together (``fwd_bwd_kernels_ms``), and the
whole autograd forward + backward of ``ops.linear_scan`` (``op_ms``). To
compare two trees, run them in turns on one card (A, B, B, A): one JSON line
per case, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

import chip_smoke as cs


def _backward(ls, ops, name, T, F, dtype, seed, l2, iters):
    import torch

    _, (a, b, c0), _, _, _ = cs._scan_case(name, T, F, dtype, seed)
    g = torch.randn((T, F), generator=torch.Generator(device="cuda").manual_seed(seed + 1),
                    device="cuda").to(a.dtype)
    c = ls.linear_scan_kernel(a, b, c0)
    if hasattr(ls, "linear_scan_bwd"):
        what = "fused backward launch"
        bwd = lambda: ls.linear_scan_bwd(a, c, c0, g)
    else:
        what = "reverse-time kernel call (flips outside)"
        a_rev = torch.cat([a[1:], torch.zeros_like(a[:1])]).flip(0).contiguous()
        g_rev, z0 = g.flip(0).contiguous(), torch.zeros_like(c0)
        bwd = lambda: ls.linear_scan_kernel(a_rev, g_rev, z0)

    def both():
        ls.linear_scan_kernel(a, b, c0)
        bwd()

    def op():
        x, y, z = (t.clone().requires_grad_(True) for t in (a, b, c0))
        (ops.linear_scan(x, y, z) * g).sum().backward()

    rw = (5 * T * F + 2 * F) * a.element_size()  # a, c, g, c0 read; da, db, dc0 written
    row = {"case": name, "dtype": dtype, "timed": what,
           "bwd_kernel_ms": cs.time_ms(bwd, iters=iters),
           "bwd_kernel_cold_ms": cs.time_ms(bwd, iters=iters, flush=l2.zero_),
           "fwd_bwd_kernels_ms": cs.time_ms(both, iters=iters),
           "op_ms": cs.time_ms(op, iters=20), "ok": True}
    row["bound_ms"], row["bound_by"] = cs.bound(rw, 3.0 * T * F, dtype)
    return row


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
        print("bench_b3: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.linear_scan import linear_scan as ls
    from repro_torch.kernels.linear_scan import ops
    from repro_torch.kernels.linear_scan.ref import linear_scan_ref

    l2 = torch.empty(cs.L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    lines = []
    for name, T, F, dtype, seed in cs.SCAN_CASES:
        _, (a, b, c0), _, rw, ops_n = cs._scan_case(name, T, F, dtype, seed)
        out = ls.linear_scan_kernel(a, b, c0)
        err, tol, finite = cs.compare([out], [linear_scan_ref(a, b, c0)])
        row = {"tree": str(tree), "case": name, "dtype": dtype, "max_abs_err": err, "tol": tol,
               "ok": bool(finite and err <= tol)}
        row["ms"] = cs.time_ms(lambda: ls.linear_scan_kernel(a, b, c0), iters=args.iters)
        row["cold_ms"] = cs.time_ms(lambda: ls.linear_scan_kernel(a, b, c0), iters=args.iters,
                                    flush=l2.zero_)
        row["bound_ms"], row["bound_by"] = cs.bound(rw, ops_n, dtype)
        lines.append(row)
        print(json.dumps(row), flush=True)
    for case in cs.SCAN_BWD_CASES:
        row = {"tree": str(tree), **_backward(ls, ops, *case, l2, args.iters)}
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
