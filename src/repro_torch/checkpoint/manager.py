"""Fault-tolerant checkpointing, from ``repro/checkpoint/manager.py``, in the
same on-disk format, so a checkpoint crosses between the JAX package and the
port both ways.

Guarantees, as in JAX:
  * **atomicity** — writes go to ``step_N.tmp`` and are renamed to ``step_N``
    only after every leaf and the manifest are flushed;
  * **resume discovery** — ``latest_step()`` scans the directory, ignoring
    ``.tmp`` debris from interrupted saves (which is removed);
  * **bounded disk** — keep-last-k garbage collection;
  * **iterator state** — the data pipeline's state dict rides in the
    manifest, so restart is sample-exact.

Storage is one ``.npy`` per leaf and a ``MANIFEST.json`` with each leaf's
path (``params/layers/cell/w``, ``opt/step``, ``opt/m/...``; a ``None``
subtree adds no leaf), dtype and shape, the step, ``data_state``,
``cell_layout`` (always lane-major here) and ``weight_quant``. Leaves are
stored unsharded; the port runs on one device, so ``restore`` places each
leaf on the device of the target's leaf.

A bfloat16 leaf (the bf16 Adam moments of ``qwen3-moe-235b-a22b`` and
``nemotron-4-340b``) is written as the JAX package writes it, ``np.save`` of
an ``ml_dtypes`` array: a ``.npy`` whose header reads ``'<V2'`` and whose
payload is the raw 2-byte words, its manifest dtype ``"bfloat16"``. The
port writes those bytes without ``ml_dtypes`` and restores by the manifest's
dtype, reinterpreting the words as ``torch.bfloat16``.

Left for later (ROADMAP.md §A5.1): restoring a legacy gate-major manifest
(the JAX package migrates it on restore). It raises here.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.tree import flatten_with_paths, unflatten_like

LANE_MAJOR = "lane_major"  # ``repro/kernels/fused_rnn/layout.py::LANE_MAJOR``
_QUANT_LEAVES = ("wq", "w0q", "w1q")
_LATER = "ROADMAP.md §A5.1: legacy gate-major checkpoints"
# ``np.save``'s header descr of an ``ml_dtypes.bfloat16`` array.
_BF16_DESCR = "<V2"


def _weight_quant(flat) -> str:
    return "int8" if any(path.rsplit("/", 1)[-1] in _QUANT_LEAVES for path, _ in flat) else "none"


def _save_leaf(path: str, leaf: torch.Tensor) -> str:
    """Write ``leaf`` to the ``.npy`` file ``path`` as the JAX package
    writes it; returns the manifest's dtype."""
    t = leaf.detach().cpu().contiguous()
    if t.dtype != torch.bfloat16:
        arr = t.numpy()
        np.save(path, arr)
        return str(arr.dtype)
    words = t.view(torch.int16).numpy()
    header = np.lib.format.header_data_from_array_1_0(words)
    header["descr"] = _BF16_DESCR
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, header)
        f.write(words.tobytes())
    return "bfloat16"


def _load_leaf(path: str, dtype: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype == "bfloat16":  # numpy reads the 2-byte words as void
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str, keep_last_k: int = 3):
        self.dir = directory
        self.keep = keep_last_k
        os.makedirs(directory, exist_ok=True)
        self._gc_tmp()

    # -- discovery ---------------------------------------------------------
    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.dir, name, "MANIFEST.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree, data_state: Optional[Dict] = None) -> str:
        final = os.path.join(self.dir, f"step_{step}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        flat = flatten_with_paths(tree)
        manifest = {
            "step": step,
            "leaves": [],
            "data_state": data_state or {},
            "cell_layout": LANE_MAJOR,
            "weight_quant": _weight_quant(flat),
        }
        for i, (path, leaf) in enumerate(flat):
            fname = f"leaf_{i}.npy"
            dtype = _save_leaf(os.path.join(tmp, fname), leaf)
            manifest["leaves"].append(
                {"path": path, "file": fname, "dtype": dtype, "shape": list(leaf.shape)}
            )
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()
        return final

    # -- restore --------------------------------------------------------------
    def restore(self, step: int, target_tree):
        """Restore into the structure of ``target_tree``; each leaf lands on
        the device of the target's leaf, in the dtype it was saved in.
        Returns (tree, data_state)."""
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "MANIFEST.json")) as f:
            manifest = json.load(f)
        if manifest.get("cell_layout") != LANE_MAJOR:
            raise NotImplementedError(
                f"checkpoint step_{step} has cell_layout="
                f"{manifest.get('cell_layout', 'gate_major (no field)')!r}; the port does not "
                f"migrate gate-major checkpoints yet ({_LATER}); the JAX package's "
                "tools/migrate_checkpoint.py rewrites it as lane-major"
            )
        by_path = {e["path"]: e for e in manifest["leaves"]}
        flat_t = flatten_with_paths(target_tree)
        saved_q, target_q = manifest.get("weight_quant", "none"), _weight_quant(flat_t)
        if saved_q != target_q:
            raise ValueError(
                f"checkpoint step_{step} has weight_quant={saved_q!r} but the restore target "
                f"expects {target_q!r}; restore into a matching config (ArchConfig.weight_quant)"
            )
        leaves = []
        for path, ref in flat_t:
            entry = by_path[path]
            leaf = _load_leaf(os.path.join(d, entry["file"]), entry["dtype"])
            leaves.append(leaf.to(ref.device))
        return unflatten_like(target_tree, leaves), manifest["data_state"]

    # -- gc -------------------------------------------------------------------
    def _gc(self):
        steps = self.steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)

    def _gc_tmp(self):
        for name in os.listdir(self.dir):
            if name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.dir, name), ignore_errors=True)
