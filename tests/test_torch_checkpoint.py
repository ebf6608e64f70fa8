"""The port's checkpoints (``repro_torch.checkpoint``) against the JAX
package's (``repro.checkpoint``): one on-disk format, crossing both ways.

A train state from one JAX ``init_train_state`` (bridged into the port) is
saved by one framework and restored by the other, leaf for leaf bit for
bit, with the manifests' paths, dtypes, shapes, ``cell_layout``,
``weight_quant`` and ``data_state`` equal; for an SRU stack (a ``None``
``w_skip``), the same with gradient-compression residuals, an int8 config
and Mamba-2. bf16 leaves (``qwen3-moe-235b-a22b``'s bf16 Adam moments): a
JAX-written state restores in the port bit for bit, the port's files equal
JAX's byte for byte (JAX's own restore cannot read them: ROADMAP.md §C), and
the port's save restores in the port exactly. Also keep-last-k, the ``.tmp``
clean-up, and what the port refuses: a gate-major manifest for now, and a
quantization mismatch.
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
from repro_torch.tree import flatten_with_paths, tree_leaves

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
    noise = lambda a: jnp.asarray(rng.normal(size=a.shape).astype(np.float32)).astype(a.dtype)
    opt = state.opt._replace(step=jnp.asarray(5, jnp.int32),
                             m=jax.tree_util.tree_map(noise, state.opt.m),
                             v=jax.tree_util.tree_map(noise, state.opt.v))
    return state._replace(opt=opt)


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step}", "MANIFEST.json")) as f:
        return json.load(f)


def _bits(a):
    """A leaf's bits as numpy: a bf16 leaf (torch, or numpy through
    ml_dtypes) as its 2-byte words, any other as it is."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _assert_bitwise(port_state, jax_state):
    port = flatten_with_paths(port_state)
    want = jax.tree_util.tree_leaves(jax_state)
    assert len(port) == len(want)
    for (path, got), w in zip(port, want):
        w = np.asarray(w)
        assert str(got.dtype).split(".")[-1] == w.dtype.name, path
        assert np.array_equal(_bits(got), _bits(w)), path


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
    """A gate-major manifest names the ROADMAP item; a quantization mismatch
    is refused as in JAX. (bf16 leaves are restored: the tests below.)"""
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


    int8 = _jax_state("sru-paper-large-stacked-int8", None)
    JaxManager(str(tmp_path / "int8")).save(1, int8)
    with pytest.raises(ValueError, match="weight_quant"):
        CheckpointManager(str(tmp_path / "int8")).restore(1, target)


# ---------------------------------------------------------------------------
# bf16 leaves (qwen3-moe-235b-a22b's bf16 Adam moments)
# ---------------------------------------------------------------------------

BF16_ARCH = "qwen3-moe-235b-a22b"


def _bf16_paths(state):
    return [p for p, t in flatten_with_paths(state) if t.dtype == torch.bfloat16]


def test_jax_bf16_checkpoint_restores_bitwise_in_the_port(tmp_path):
    """A JAX-saved reduced qwen3 train state (bf16 moments, the ``moe/*``
    leaves among them) restores in the port into the port's own
    ``init_train_state``: every leaf's dtype and bits."""
    from repro_torch.configs.registry import get_config
    from repro_torch.training import steps

    jstate = _jax_state(BF16_ARCH, None)
    JaxManager(str(tmp_path)).save(3, jstate, DATA_STATE)
    assert any(e["dtype"] == "bfloat16" for e in _manifest(tmp_path, 3)["leaves"])
    target = steps.init_train_state(torch.Generator().manual_seed(1),
                                    get_config(BF16_ARCH).reduced(), device="cpu")
    restored, data_state = CheckpointManager(str(tmp_path)).restore(3, target)
    assert data_state == DATA_STATE
    _assert_bitwise(restored, jstate)
    bf16 = _bf16_paths(restored)
    assert bf16 and all(p.startswith(("opt/m/", "opt/v/")) for p in bf16)
    assert "opt/m/layers/moe/e_up" in bf16


def test_port_bf16_files_equal_jax_bytes(tmp_path):
    """The port's save of the same state writes JAX's manifest and, leaf by
    leaf, JAX's files byte for byte: the bf16 ones with the ``'<V2'`` header
    and the raw words."""
    jstate = _jax_state(BF16_ARCH, None)
    port_state = bridge.train_state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate),
                                               device="cpu")
    assert _bf16_paths(port_state)
    CheckpointManager(str(tmp_path / "port")).save(3, port_state, DATA_STATE)
    JaxManager(str(tmp_path / "jax")).save(3, jstate, DATA_STATE)
    mine, theirs = _manifest(tmp_path / "port", 3), _manifest(tmp_path / "jax", 3)
    assert mine == theirs
    for e in mine["leaves"]:
        got = (tmp_path / "port" / "step_3" / e["file"]).read_bytes()
        want = (tmp_path / "jax" / "step_3" / e["file"]).read_bytes()
        assert got == want, e["path"]
        if e["dtype"] == "bfloat16":
            assert b"'descr': '<V2'" in got[:128]


def test_port_bf16_round_trip_is_exact(tmp_path):
    """Port save -> port restore: every leaf's dtype and bits, bf16 leaves of
    every rank (a scalar among them) and the state's."""
    from repro_torch.configs.registry import get_config
    from repro_torch.training import steps

    g = torch.Generator().manual_seed(2)
    tree = {"scalar": torch.randn((), generator=g).to(torch.bfloat16),
            "odd": torch.randn((3, 5, 7), generator=g).to(torch.bfloat16),
            "special": torch.tensor([0.0, -0.0, float("inf"), -float("inf"), float("nan"),
                                     1e-40, 3.0e38], dtype=torch.bfloat16),
            "fp32": torch.randn((4,), generator=g)}
    state = steps.init_train_state(g, get_config(BF16_ARCH).reduced(), device="cpu")
    for x in tree_leaves(state.opt.m) + tree_leaves(state.opt.v):  # bf16 noise, not zeros
        x.copy_(torch.randn(x.shape, generator=g))
    for what, obj in (("tree", tree), ("state", state)):
        mgr = CheckpointManager(str(tmp_path / what))
        mgr.save(1, obj)
        back, _ = mgr.restore(1, obj)
        pairs = list(zip(flatten_with_paths(back), flatten_with_paths(obj), strict=True))
        assert any(a.dtype == torch.bfloat16 for (_, a), _ in pairs)
        for (path, a), (_, b) in pairs:
            assert a.dtype == b.dtype and a.shape == b.shape, path
            assert np.array_equal(_bits(a), _bits(b)), path
