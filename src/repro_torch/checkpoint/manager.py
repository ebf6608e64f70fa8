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
    manifest, so restart is sample-exact;
  * **layout versioning** — the manifest records the RNN cell-parameter
    layout (``cell_layout``; ``kernels/fused_rnn/layout.py``). Checkpoints
    from the flat gate-major era (no field, or ``"gate_major"``) are
    migrated to the lane-major layout on restore, a bitwise reshape of the
    gate slabs and biases (Adam moments included), as JAX migrates them;
    ``launch/migrate_checkpoint.py`` rewrites a checkpoint directory with
    the same converter, for operators who want the migration persisted.

Storage is one ``.npy`` per leaf and a ``MANIFEST.json`` with each leaf's
path (``params/layers/cell/w``, ``opt/step``, ``opt/m/...``; a ``None``
subtree adds no leaf), dtype and shape, the step, ``data_state``,
``cell_layout`` (always lane-major when written) and ``weight_quant``. Leaves are
stored unsharded. ``restore`` places each leaf on the device of the
target's leaf.

On a mesh of ranks (``shardings``: the port's ``(mesh, specs)``, a
``launch/mesh.py`` mesh and a spec tree matching the state) ``save``
gathers each leaf whole over the axes it is sharded on, and rank 0 alone
writes the files, byte-equal to a single-device save of the same state;
a barrier follows the rename, so no rank goes on before the step is
published. ``restore`` with ``shardings`` is the elastic re-mesh restore:
each rank reads the whole leaf and keeps its ``local_shard`` under the
current mesh, whatever mesh the step was saved from.

A bfloat16 leaf (the bf16 Adam moments of ``qwen3-moe-235b-a22b`` and
``nemotron-4-340b``) is written as the JAX package writes it, ``np.save`` of
an ``ml_dtypes`` array: a ``.npy`` whose header reads ``'<V2'`` and whose
payload is the raw 2-byte words, its manifest dtype ``"bfloat16"``. The
port writes those bytes without ``ml_dtypes`` and restores by the manifest's
dtype, reinterpreting the words as ``torch.bfloat16``.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distribution import sharding
from repro_torch.kernels.fused_rnn import layout
from repro_torch.tree import flatten_with_paths, tree_leaves, unflatten_like

_QUANT_LEAVES = ("wq", "w0q", "w1q")
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
    def save(self, step: int, tree, data_state: Optional[Dict] = None, shardings=None) -> str:
        """Write ``tree`` as ``step_N``; ``shardings``: ``(mesh, specs)``
        when ``tree`` holds this rank's shards (module docstring)."""
        final = os.path.join(self.dir, f"step_{step}")
        flat = flatten_with_paths(tree)
        if shardings is not None:
            mesh, specs = shardings
            flat = [(path, sharding.gather_shard(leaf, spec, mesh))
                    for (path, leaf), spec in zip(flat, tree_leaves(specs))]
            if dist.is_initialized() and dist.get_rank() != 0:
                dist.barrier()  # rank 0 writes and publishes
                return final
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {
            "step": step,
            "leaves": [],
            "data_state": data_state or {},
            "cell_layout": layout.LANE_MAJOR,
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
        if shardings is not None and dist.is_initialized():
            dist.barrier()
        return final

    # -- restore --------------------------------------------------------------
    def restore(self, step: int, target_tree, shardings=None):
        """Restore into the structure of ``target_tree``; each leaf lands on
        the device of the target's leaf, in the dtype it was saved in. A
        gate-major checkpoint is migrated to lane-major on the way.
        ``shardings``: ``(mesh, specs)``, this rank keeps its shard of each
        leaf (the elastic re-mesh restore). Returns (tree, data_state)."""
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "MANIFEST.json")) as f:
            manifest = json.load(f)
        by_path = {e["path"]: e for e in manifest["leaves"]}
        flat_t = flatten_with_paths(target_tree)
        saved_q, target_q = manifest.get("weight_quant", "none"), _weight_quant(flat_t)
        if saved_q != target_q:
            raise ValueError(
                f"checkpoint step_{step} has weight_quant={saved_q!r} but the restore target "
                f"expects {target_q!r}; run `python -m repro_torch.launch.migrate_checkpoint "
                "DIR --quantize int8` to quantize a checkpoint in place, or restore into a "
                "matching config (ArchConfig.weight_quant)"
            )

        def load(path):
            entry = by_path[path]
            return _load_leaf(os.path.join(d, entry["file"]), entry["dtype"])

        migrated = None
        if manifest.get("cell_layout", layout.GATE_MAJOR) != layout.LANE_MAJOR:
            # Legacy gate-major checkpoint: a bias's gate count resolves from
            # its sibling leaves, so only this path loads the whole mapping
            # at once; a current checkpoint streams one leaf at a time.
            migrated = layout.migrate_flat_leaves({path: load(path) for path, _ in flat_t})
        specs = [()] * len(flat_t) if shardings is None else tree_leaves(shardings[1])
        leaves = []
        for (path, ref), spec in zip(flat_t, specs):
            leaf = load(path) if migrated is None else migrated[path]
            if shardings is not None:
                leaf = sharding.local_shard(leaf, spec, shardings[0])
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
