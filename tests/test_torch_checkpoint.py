"""The port's checkpoints (``repro_torch.checkpoint``) against the JAX
package's (``repro.checkpoint``): one on-disk format, crossing both ways.

A train state from one JAX ``init_train_state`` (bridged into the port) is
saved by one framework and restored by the other, leaf for leaf bit for
bit, with the manifests' paths, dtypes, shapes, ``cell_layout``,
``weight_quant`` and ``data_state`` equal; for an SRU stack (a ``None``
``w_skip``), the same with gradient-compression residuals, an int8 config
and Mamba-2. Also keep-last-k, the ``.tmp`` clean-up, and what the port
refuses for now: a gate-major manifest, a bf16 leaf, and a quantization
mismatch.
"""
from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxManager
from repro.configs.registry import get_config as jax_get_config
from repro.training import steps as jsteps
from repro_torch import bridge
from repro_torch.checkpoint import CheckpointManager
from repro_torch.tree import flatten_with_paths

CASES = {
    "sru_stack": ("sru-paper-large-stacked", None),
    "qrnn_compressed": ("qrnn-paper-large-fused", "int8"),
    "int8": ("qrnn-paper-large-stacked-int8", None),
    "mamba": ("mamba2-2.7b", None),
}
DATA_STATE = {"kind": "synthetic", "seed": 7}


def _jax_state(arch, compression, seed=0):
    jcfg = jax_get_config(arch).reduced()
    state = jsteps.init_train_state(jax.random.PRNGKey(seed), jcfg, compression)
    # Distinct moments and a nonzero step, so a swapped leaf would show.
    rng = np.random.default_rng(seed)
    noise = lambda a: jnp.asarray(rng.normal(size=a.shape).astype(np.float32))
    opt = state.opt._replace(step=jnp.asarray(5, jnp.int32),
                             m=jax.tree_util.tree_map(noise, state.opt.m),
                             v=jax.tree_util.tree_map(noise, state.opt.v))
    return state._replace(opt=opt)


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step}", "MANIFEST.json")) as f:
        return json.load(f)


def _assert_bitwise(port_state, jax_state):
    port = flatten_with_paths(port_state)
    want = jax.tree_util.tree_leaves(jax_state)
    assert len(port) == len(want)
    for (path, got), w in zip(port, want):
        w = np.array(w)
        assert got.dtype == torch.from_numpy(w).dtype, path
        assert np.array_equal(got.numpy(), w), path


@pytest.mark.parametrize("case", sorted(CASES))
def test_jax_checkpoint_restores_in_the_port(case, tmp_path):
    arch, compression = CASES[case]
    jstate = _jax_state(arch, compression)
    JaxManager(str(tmp_path)).save(3, jstate, DATA_STATE)
    target = bridge.train_state_from_numpy(jax.tree_util.tree_map(np.asarray, _jax_state(
        arch, compression, seed=1)), device="cpu")
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 3
    restored, data_state = mgr.restore(3, target)
    assert data_state == DATA_STATE
    _assert_bitwise(restored, jstate)
    assert [p for p, _ in flatten_with_paths(restored)] == [
        e["path"] for e in _manifest(tmp_path, 3)["leaves"]]


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_checkpoint_restores_in_jax(case, tmp_path):
    arch, compression = CASES[case]
    jstate = _jax_state(arch, compression)
    port_state = bridge.train_state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate),
                                               device="cpu")
    CheckpointManager(str(tmp_path / "port")).save(3, port_state, DATA_STATE)
    JaxManager(str(tmp_path / "jax")).save(3, jstate, DATA_STATE)
    mine, theirs = _manifest(tmp_path / "port", 3), _manifest(tmp_path / "jax", 3)
    assert mine == theirs  # paths, files, dtypes, shapes, layout, quant, data state
    restored, data_state = JaxManager(str(tmp_path / "port")).restore(
        3, jax.eval_shape(lambda: jstate))
    assert data_state == DATA_STATE
    for a, b in zip(jax.tree_util.tree_leaves(restored), jax.tree_util.tree_leaves(jstate)):
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a), np.asarray(b))
    # the train state's paths, as the JAX package writes them
    paths = [e["path"] for e in mine["leaves"]]
    assert "opt/step" in paths and any(p.startswith("params/layers/") for p in paths)
    assert any(p.startswith("ef/") for p in paths) == (compression is not None)


def test_keep_last_k_and_tmp_cleanup(tmp_path):
    state = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    os.makedirs(tmp_path / "step_9.tmp")  # debris of an interrupted save
    mgr = CheckpointManager(str(tmp_path), keep_last_k=2)
    assert not (tmp_path / "step_9.tmp").exists()
    for s in (1, 2, 3):
        mgr.save(s, state)
    assert mgr.steps() == [2, 3] and mgr.latest_step() == 3
    got, data_state = mgr.restore(3, state)
    assert torch.equal(got["w"], state["w"]) and data_state == {}


def test_port_refuses_what_it_cannot_restore_yet(tmp_path):
    """A gate-major manifest and a bf16 leaf name the ROADMAP item; a
    quantization mismatch is refused as in JAX."""
    jstate = _jax_state("sru-paper-large-stacked", None)
    target = bridge.train_state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate),
                                           device="cpu")
    JaxManager(str(tmp_path / "legacy")).save(1, jstate)
    mpath = tmp_path / "legacy" / "step_1" / "MANIFEST.json"
    manifest = json.loads(mpath.read_text())
    del manifest["cell_layout"]
    mpath.write_text(json.dumps(manifest))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        CheckpointManager(str(tmp_path / "legacy")).restore(1, target)

    jcfg = jax_get_config("sru-paper-large-stacked").reduced().with_(moment_dtype="bfloat16")
    bf16_state = jsteps.init_train_state(jax.random.PRNGKey(0), jcfg)
    JaxManager(str(tmp_path / "bf16")).save(1, bf16_state)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        CheckpointManager(str(tmp_path / "bf16")).restore(1, target)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        CheckpointManager(str(tmp_path / "save")).save(1, {"m": torch.zeros(2, dtype=torch.bfloat16)})

    int8 = _jax_state("sru-paper-large-stacked-int8", None)
    JaxManager(str(tmp_path / "int8")).save(1, int8)
    with pytest.raises(ValueError, match="weight_quant"):
        CheckpointManager(str(tmp_path / "int8")).restore(1, target)
