#!/usr/bin/env python3
"""Time the fused SRU/QRNN kernel (B1 layer, B2 stack) of one source tree on the card.

    python3 bench_b12.py                          # this tree
    python3 bench_b12.py --tree build/parent --out build/b12_parent.jsonl

For each bf16 case of ``chip_smoke.fused_rnn_cases()`` (same shapes, same
seeds: the main path's B = 4, width 1024 at T = 64 and T = 1, fp and int8
slabs, and the ragged ones) it runs the tree's wrapper
(``fused_rnn.fused_rnn_layer`` or ``stacked.fused_rnn_stack``), holds it to
the plain version at ``chip_smoke``'s tolerance, and times it L2-warm
(``ms``) and with the L2 flushed before each call (``cold_ms``), beside the
bound. As information only, ``matmul_ms`` is the time of ``torch.matmul``
on the same gate GEMM operands in bf16 (the slab widened, QRNN's shifted
input and taps concatenated, one product per layer of a stack, all made
before the timed calls): part of the function, not a yardstick of it. To
compare two trees, run them in turns in one process chain on one card (A, B,
B, A): one JSON line per case, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

import chip_smoke as cs


def _gemm_operands(args, kw):
    """The gate GEMM of a case as bf16 matmuls: [(rows x K input, K x 3H
    slab)], one pair per layer."""
    import torch

    bf = torch.bfloat16
    x, taps = args[0], args[1]
    T, B, d = x.shape
    if "mode" in kw:  # one layer
        u = x.reshape(T * B, d)
        if kw["mode"] == "qrnn":
            shifted = torch.cat([kw["tail"], x[:-1]], dim=0).reshape(T * B, d)
            u = torch.cat([u, shifted], dim=-1)
        w = torch.cat([t.to(bf) for t in taps], dim=0)
        return [(u.contiguous(), w.reshape(w.shape[0], -1).contiguous())]
    L = taps[0].shape[0]
    u = x.reshape(T * B, d)
    if len(taps) == 2:
        u = torch.cat([u, u], dim=-1)
    out = []
    for layer in range(L):
        w = torch.cat([t[layer].to(bf) for t in taps], dim=0)
        out.append((u.contiguous(), w.reshape(w.shape[0], -1).contiguous()))
    return out


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
        print("bench_b12: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.fused_rnn import fused_rnn, stacked

    torch.backends.cuda.matmul.allow_tf32 = False
    calls = {"fused_rnn_layer": (fused_rnn.fused_rnn_layer, fused_rnn.fused_rnn_layer_plain),
             "fused_rnn_stack": (stacked.fused_rnn_stack, stacked.fused_rnn_stack_plain)}
    l2 = torch.empty(cs.L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    lines = []
    for family, cases in cs.fused_rnn_cases().items():
        wrapper, plain = calls[family.replace("_int8", "")]
        for dtype, T, name, args_, kw, rw, ops in cases:
            if dtype != "bfloat16":
                continue
            ref = plain(*args_, **kw)
            out = wrapper(*args_, **kw)
            torch.cuda.synchronize()
            err, tol, finite = cs.compare(out, ref)
            row = {"tree": str(tree), "kernel": family, "case": name, "T": T,
                   "max_abs_err": err, "tol": tol, "ok": bool(finite and err <= tol)}
            row["ms"] = cs.time_ms(lambda: wrapper(*args_, **kw), iters=args.iters)
            row["cold_ms"] = cs.time_ms(lambda: wrapper(*args_, **kw), iters=args.iters,
                                        flush=l2.zero_)
            row["bound_ms"], row["bound_by"] = cs.bound(rw, ops, dtype)
            pairs = _gemm_operands(args_, kw)
            row["matmul_ms"] = cs.time_ms(lambda: [torch.matmul(u, w) for u, w in pairs],
                                          iters=args.iters)
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
