"""Rewrite a checkpoint directory: layout migration and/or int8 quantization
(the port's form of the JAX package's ``tools/migrate_checkpoint.py``, with
its flags and printed lines, plus ``--device``):

    PYTHONPATH=src python -m repro_torch.launch.migrate_checkpoint CKPT_DIR [--step N] [--dry-run]
    PYTHONPATH=src python -m repro_torch.launch.migrate_checkpoint CKPT_DIR --quantize int8
    PYTHONPATH=src python -m repro_torch.launch.migrate_checkpoint CKPT_DIR --device cpu

``checkpoint/manager.py`` already migrates gate-major checkpoints on restore
(the manifest's ``cell_layout`` gates it), so this tool is for operators who
want the migration persisted: it rewrites each ``step_*`` directory in place
with the same converter (``kernels/fused_rnn/layout.py::migrate_flat_leaves``,
a bitwise reshape of the RNN gate slabs and biases; every other leaf keeps
its bytes). Already lane-major steps are skipped, so it is idempotent.

``--quantize int8`` rewrites the SRU/QRNN gate slabs as weight-only int8
(``layout.quantize_flat_leaves``: the arrays ``models/lm.py::lm_init`` makes
under ``weight_quant="int8"``, so the result restores into an ``*-int8``
config); gate-major steps are migrated in the same pass. The quantization
runs on ``--device`` (default ``cuda``; without a card it raises unless
``--device cpu`` is given, and never falls back). The manifest records
``weight_quant: "int8"``, and an already quantized step is skipped, never
quantized twice.

Leaves are read and written as the manager reads and writes them
(``_load_leaf`` / ``_save_leaf``), so a bf16 leaf keeps its bytes and its
manifest dtype ``"bfloat16"``. The rewrite follows the manager's atomicity:
the converted step is written to ``step_N.tmp``; once every leaf and the
manifest are flushed, the original is parked at ``step_N.old``, the new copy
renamed into place, and only then is the original removed, so an interrupted
run always leaves a restorable directory.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import sys

from repro_torch.checkpoint.manager import _load_leaf, _save_leaf
from repro_torch.kernels.fused_rnn import layout
from repro_torch.models.layers import resolve_device


def _manifest(step_dir: str) -> dict:
    with open(os.path.join(step_dir, "MANIFEST.json")) as f:
        return json.load(f)


def _leaves(step_dir: str, manifest: dict) -> dict:
    """The step's ``{path: tensor}`` mapping, in the manifest's order."""
    return {e["path"]: _load_leaf(os.path.join(step_dir, e["file"]), e["dtype"])
            for e in manifest["leaves"]}


def _publish(step_dir: str, manifest: dict, arrays: dict) -> None:
    """Write ``arrays`` (``manifest["leaves"]`` names their files, in order)
    and ``manifest`` to ``step_N.tmp``, then swap it in without a window in
    which the step's only copy is mid-write: park the original as
    ``step_N.old`` (invisible to the manager, whose ``steps()`` matches
    ``step_N`` exactly), rename the new copy into place, then remove the
    original."""
    tmp = step_dir + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    for entry in manifest["leaves"]:
        arr = arrays[entry["path"]]
        entry["dtype"] = _save_leaf(os.path.join(tmp, entry["file"]), arr)
        entry["shape"] = list(arr.shape)
    manifest["cell_layout"] = layout.LANE_MAJOR
    with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    old = step_dir + ".old"
    if os.path.exists(old):
        shutil.rmtree(old)
    os.rename(step_dir, old)
    os.rename(tmp, step_dir)
    shutil.rmtree(old)


def migrate_step_dir(step_dir: str, *, dry_run: bool = False) -> bool:
    """Migrate one ``step_N`` directory in place. Returns True if rewritten."""
    manifest = _manifest(step_dir)
    if manifest.get("cell_layout") == layout.LANE_MAJOR:
        print(f"{step_dir}: already {layout.LANE_MAJOR}, skipping")
        return False
    arrays = _leaves(step_dir, manifest)
    migrated = layout.migrate_flat_leaves(arrays)
    changed = [p for p in arrays if migrated[p].shape != arrays[p].shape]
    if dry_run:
        print(f"{step_dir}: would migrate {len(changed)} leaves: {changed}")
        return False
    _publish(step_dir, manifest, migrated)
    print(f"{step_dir}: migrated {len(changed)} leaves to {layout.LANE_MAJOR}")
    return True


def quantize_step_dir(step_dir: str, *, device="cuda", dry_run: bool = False) -> bool:
    """Quantize one ``step_N`` directory's gate slabs to int8 in place, on
    ``device``. Returns True if rewritten. An already quantized step (its
    manifest's ``weight_quant``, or int8 leaf names) is refused, never
    quantized twice; a gate-major step is migrated in the same pass."""
    manifest = _manifest(step_dir)
    if manifest.get("weight_quant") == "int8":
        print(f"{step_dir}: already weight_quant=int8, skipping")
        return False
    arrays = _leaves(step_dir, manifest)
    if manifest.get("cell_layout") != layout.LANE_MAJOR:
        arrays = layout.migrate_flat_leaves(arrays)
    try:
        qarrays = layout.quantize_flat_leaves(arrays, device=device)
    except ValueError as e:
        # int8 leaves despite the manifest: refuse rather than compound the
        # rounding error with a second quantization.
        print(f"{step_dir}: {e}", file=sys.stderr)
        return False
    converted = sorted(set(arrays) - set(qarrays))
    if dry_run:
        print(f"{step_dir}: would quantize {len(converted)} slab leaves: {converted}")
        return False
    # The new leaves are numbered in the mapping's order, as the JAX tool
    # numbers them: the kept leaves first, then each cell's int8 entries.
    manifest["leaves"] = [{"path": path, "file": f"leaf_{i}.npy"}
                          for i, path in enumerate(qarrays)]
    manifest["weight_quant"] = "int8"
    _publish(step_dir, manifest, qarrays)
    print(f"{step_dir}: quantized {len(converted)} slab leaves to int8")
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("directory", help="checkpoint directory (contains step_N/)")
    ap.add_argument("--step", type=int, default=None,
                    help="migrate only this step (default: every step)")
    ap.add_argument("--dry-run", action="store_true",
                    help="report what would change without writing")
    ap.add_argument("--quantize", choices=("int8",), default=None,
                    help="quantize the SRU/QRNN gate slabs to weight-only "
                         "int8 instead of (just) migrating the layout")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where --quantize computes: cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    steps = []
    for name in sorted(os.listdir(args.directory)):
        if not re.fullmatch(r"step_\d+", name):  # skips .tmp/.old debris
            continue
        if not os.path.exists(os.path.join(args.directory, name, "MANIFEST.json")):
            continue
        if args.step is not None and name != f"step_{args.step}":
            continue
        steps.append(os.path.join(args.directory, name))
    if not steps:
        print(f"no matching checkpoints under {args.directory}", file=sys.stderr)
        return 1
    for step_dir in steps:
        if args.quantize:
            quantize_step_dir(step_dir, device=device, dry_run=args.dry_run)
        else:
            migrate_step_dir(step_dir, dry_run=args.dry_run)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
