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
clean-up, and the refusal of a quantization mismatch.

Legacy gate-major checkpoints: one written by JAX (``tree_to_gate_major``,
``cell_layout`` deleted or ``"gate_major"``) restores bitwise in the port and
in JAX, for SRU, QRNN and LSTM params and the stacked SRU and QRNN train
states (Adam moments included), and so does one the port writes. The
migration tool: JAX's ``tools/migrate_checkpoint.py`` and the port's
``repro_torch.launch.migrate_checkpoint`` run on two copies of one
checkpoint, as a migration and as ``--quantize int8``, write byte-equal leaf
files, manifests equal as JSON and the same lines; a second run skips,
``--dry-run`` writes nothing, ``--step`` selects, no match gives rc 1, and a
bf16 leaf keeps its bytes and its manifest dtype through the port's tool.
"""
from __future__ import annotations

import importlib.util
import json
import os
import pathlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxManager
from repro.configs.registry import get_config as jax_get_config
from repro.kernels.fused_rnn import layout as jlayout
from repro.models import lm as jlm
from repro.training import steps as jsteps
from repro_torch import bridge
from repro_torch.checkpoint import CheckpointManager
from repro_torch.kernels.fused_rnn import layout
from repro_torch.launch import migrate_checkpoint
from repro_torch.tree import flatten_with_paths, tree_leaves

REPO = pathlib.Path(__file__).resolve().parents[1]

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
    """A quantization mismatch is refused as in JAX, naming the port's tool.
    (Gate-major manifests and bf16 leaves are restored: the tests below.)"""
    jstate = _jax_state("sru-paper-large-stacked", None)
    target = bridge.train_state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate),
                                           device="cpu")
    int8 = _jax_state("sru-paper-large-stacked-int8", None)
    JaxManager(str(tmp_path / "int8")).save(1, int8)
    with pytest.raises(ValueError, match="weight_quant.*repro_torch.launch.migrate_checkpoint"):
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


# ---------------------------------------------------------------------------
# Legacy gate-major checkpoints, restored with the migration
# ---------------------------------------------------------------------------

# case -> (arch, a whole train state?, the manifest's cell_layout: None drops it)
LEGACY = {
    "sru": ("sru-paper-large", False, None),
    "qrnn": ("qrnn-paper-large", False, None),
    "lstm": ("lstm-paper-large", False, None),
    "sru_state": ("sru-paper-large-stacked", True, "gate_major"),
    "qrnn_state": ("qrnn-paper-large-stacked", True, None),
}


def _jax_params(arch, seed=0):
    return jlm.lm_init(jax.random.PRNGKey(seed), jax_get_config(arch).reduced())


def _jax_tree(arch, state, seed=0):
    return _jax_state(arch, None, seed) if state else _jax_params(arch, seed)


def _port_tree(tree):
    np_tree = jax.tree_util.tree_map(np.asarray, tree)
    if isinstance(tree, jsteps.TrainState):
        return bridge.train_state_from_numpy(np_tree, device="cpu")
    return bridge.params_from_numpy(np_tree, device="cpu")


def _jax_gate_major(tree):
    """What an old binary wrote: JAX's converter over the params, and over
    each field of a train state (it passes a NamedTuple through)."""
    g = jlayout.tree_to_gate_major
    if isinstance(tree, jsteps.TrainState):
        return tree._replace(params=g(tree.params),
                             opt=tree.opt._replace(m=g(tree.opt.m), v=g(tree.opt.v)))
    return g(tree)


def _mark_legacy(d, step, tag=None):
    """Drop the manifest's ``cell_layout`` (``tag`` None), or set it."""
    mpath = pathlib.Path(d) / f"step_{step}" / "MANIFEST.json"
    manifest = json.loads(mpath.read_text())
    if tag is None:
        del manifest["cell_layout"]
    else:
        manifest["cell_layout"] = tag
    mpath.write_text(json.dumps(manifest))


def _assert_restores_in_both(d, step, jtree, port_target):
    restored, data_state = CheckpointManager(str(d)).restore(step, port_target)
    assert data_state == DATA_STATE
    _assert_bitwise(restored, jtree)
    back, _ = JaxManager(str(d)).restore(step, jax.eval_shape(lambda: jtree))
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                            jax.tree_util.tree_leaves(jtree), strict=True):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        assert np.array_equal(np.asarray(a), np.asarray(b)), path


@pytest.mark.parametrize("case", sorted(LEGACY))
def test_jax_gate_major_checkpoint_restores_in_the_port(case, tmp_path):
    """A checkpoint an old JAX binary wrote restores bitwise in the port and
    in JAX: the slabs, biases and (train states) both Adam moments migrate,
    LSTM and every other leaf pass through."""
    arch, state, tag = LEGACY[case]
    jtree = _jax_tree(arch, state)
    JaxManager(str(tmp_path)).save(3, _jax_gate_major(jtree), DATA_STATE)
    _mark_legacy(tmp_path, 3, tag)
    shapes = {e["path"]: e["shape"] for e in _manifest(tmp_path, 3)["leaves"]}
    if arch.startswith("sru"):
        prefix = "params/" if state else ""
        assert len(shapes[f"{prefix}layers/cell/w"]) == 3  # (L, d, 3H): gate-major
        if state:
            assert len(shapes["opt/m/layers/cell/w"]) == 3
    _assert_restores_in_both(tmp_path, 3, jtree, _port_tree(_jax_tree(arch, state, seed=1)))


def test_port_written_gate_major_state_restores_in_both(tmp_path):
    """The port's ``tree_to_gate_major`` over a whole train state, saved by
    the port's manager without ``cell_layout`` (how chip_smoke makes its
    legacy checkpoint), restores bitwise in the port and in JAX."""
    jstate = _jax_state("qrnn-paper-large-stacked", None)
    port_state = _port_tree(jstate)
    CheckpointManager(str(tmp_path)).save(2, layout.tree_to_gate_major(port_state), DATA_STATE)
    _mark_legacy(tmp_path, 2)
    assert len(_manifest(tmp_path, 2)["leaves"]) == len(tree_leaves(port_state))
    _assert_restores_in_both(tmp_path, 2, jstate,
                             _port_tree(_jax_state("qrnn-paper-large-stacked", None, seed=1)))


# ---------------------------------------------------------------------------
# The migration tool: the port's against JAX's tools/migrate_checkpoint.py
# ---------------------------------------------------------------------------

def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_migrate_checkpoint", REPO / "tools" / "migrate_checkpoint.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _snapshot(d):
    d = pathlib.Path(d)
    return {str(p.relative_to(d)): p.read_bytes() for p in sorted(d.rglob("*")) if p.is_file()}


def _run_both(tmp_path, capsys, *flags):
    """JAX's tool on ``tmp_path/jax`` and the port's (``--device cpu``) on
    ``tmp_path/port``; returns their return codes and printed lines with the
    directory names taken out."""
    out = {}
    for who, main in (("jax", _jax_tool().main),
                      ("port", lambda argv: migrate_checkpoint.main(argv + ["--device", "cpu"]))):
        rc = main([str(tmp_path / who), *flags])
        captured = capsys.readouterr()
        text = (captured.out + captured.err).replace(str(tmp_path / who), "DIR")
        out[who] = (rc, text.splitlines())
    return out


def _two_copies(tmp_path, jtree, gate_major, steps=(1,)):
    for step in steps:
        JaxManager(str(tmp_path / "jax")).save(
            step, _jax_gate_major(jtree) if gate_major else jtree, DATA_STATE)
        if gate_major:
            _mark_legacy(tmp_path / "jax", step)
    shutil.copytree(tmp_path / "jax", tmp_path / "port")


def _assert_same_files(mine, theirs):
    """Every leaf file byte for byte, the manifests equal as JSON."""
    theirs, mine = _snapshot(theirs), _snapshot(mine)
    assert sorted(mine) == sorted(theirs)
    for name, data in theirs.items():
        if name.endswith("MANIFEST.json"):
            assert json.loads(mine[name]) == json.loads(data), name
        else:
            assert mine[name] == data, name


@pytest.mark.parametrize("arch", ["sru-paper-large", "qrnn-paper-large-stacked",
                                  "lstm-paper-large"])
def test_migrate_tool_matches_jax(arch, tmp_path, capsys):
    """A JAX-written gate-major checkpoint through both tools: the same
    files byte for byte, manifests equal, the same lines; restores bitwise;
    a second run skips and writes nothing."""
    jtree = _jax_params(arch)
    _two_copies(tmp_path, jtree, gate_major=True)
    out = _run_both(tmp_path, capsys)
    assert out["port"] == out["jax"]
    assert out["port"][0] == 0
    n = 0 if arch.startswith("lstm") else (2 if arch.startswith("sru") else 3)
    assert out["port"][1] == [f"DIR/step_1: migrated {n} leaves to lane_major"]
    _assert_same_files(tmp_path / "port", tmp_path / "jax")
    assert _manifest(tmp_path / "port", 1)["cell_layout"] == "lane_major"
    restored, data_state = CheckpointManager(str(tmp_path / "port")).restore(
        1, _port_tree(_jax_params(arch, seed=1)))
    assert data_state == DATA_STATE
    _assert_bitwise(restored, jtree)
    before = _snapshot(tmp_path / "port")
    again = _run_both(tmp_path, capsys)
    assert again["port"] == again["jax"] == (0, ["DIR/step_1: already lane_major, skipping"])
    assert _snapshot(tmp_path / "port") == before


# (arch, gate-major?) of the fp checkpoint that --quantize int8 rewrites
QUANTIZE = [("sru-paper-large-int8", False), ("sru-paper-large-int8", True),
            ("qrnn-paper-large-stacked-int8", False), ("qrnn-paper-large-stacked-int8", True),
            ("lstm-paper-large", True)]


@pytest.mark.parametrize("arch,gate_major", QUANTIZE)
def test_quantize_tool_matches_jax(arch, gate_major, tmp_path, capsys):
    """``--quantize int8`` of an fp checkpoint (lane- or gate-major) through
    both tools: the same files byte for byte (``leaf_{i}.npy`` in JAX's
    order), manifests equal, the same lines; the result restores into the
    int8 config's tree bitwise equal to JAX's ``lm_init`` of that config;
    a second run skips."""
    fp_arch = jax_get_config(arch).reduced().with_(weight_quant="none")
    jtree = jlm.lm_init(jax.random.PRNGKey(0), fp_arch)
    _two_copies(tmp_path, jtree, gate_major)
    out = _run_both(tmp_path, capsys, "--quantize", "int8")
    assert out["port"] == out["jax"]
    n = 0 if arch.startswith("lstm") else (1 if arch.startswith("sru") else 2)
    assert out["port"] == (0, [f"DIR/step_1: quantized {n} slab leaves to int8"])
    _assert_same_files(tmp_path / "port", tmp_path / "jax")
    manifest = _manifest(tmp_path / "port", 1)
    assert manifest["weight_quant"] == "int8" and manifest["cell_layout"] == "lane_major"
    assert [e["file"] for e in manifest["leaves"]] == [
        f"leaf_{i}.npy" for i in range(len(manifest["leaves"]))]
    if not arch.startswith("lstm"):  # an LSTM has no int8 leaf for a target to expect
        want = jlm.lm_init(jax.random.PRNGKey(0), jax_get_config(arch).reduced())
        target = _port_tree(jlm.lm_init(jax.random.PRNGKey(1), jax_get_config(arch).reduced()))
        restored, _ = CheckpointManager(str(tmp_path / "port")).restore(1, target)
        _assert_bitwise(restored, want)
    before = _snapshot(tmp_path / "port")
    again = _run_both(tmp_path, capsys, "--quantize", "int8")
    assert again["port"] == again["jax"] == (
        0, ["DIR/step_1: already weight_quant=int8, skipping"])
    assert _snapshot(tmp_path / "port") == before


@pytest.mark.parametrize("flags", [[], ["--quantize", "int8"]], ids=["migrate", "quantize"])
def test_tools_dry_run_step_and_no_match(flags, tmp_path, capsys):
    """``--dry-run`` prints JAX's lines and changes no byte; ``--step``
    rewrites that step alone; no matching step gives rc 1 in both tools."""
    jtree = _jax_params("qrnn-paper-large")
    _two_copies(tmp_path, jtree, gate_major=True, steps=(1, 2))
    before = _snapshot(tmp_path / "port")
    dry = _run_both(tmp_path, capsys, *flags, "--dry-run")
    assert dry["port"] == dry["jax"] and dry["port"][0] == 0
    assert [line.split(":")[0] for line in dry["port"][1]] == ["DIR/step_1", "DIR/step_2"]
    assert all(": would " in line for line in dry["port"][1])
    assert _snapshot(tmp_path / "port") == before

    picked = _run_both(tmp_path, capsys, *flags, "--step", "2")
    assert picked["port"] == picked["jax"] and picked["port"][0] == 0
    assert [line.split(":")[0] for line in picked["port"][1]] == ["DIR/step_2"]
    _assert_same_files(tmp_path / "port", tmp_path / "jax")
    assert "cell_layout" not in _manifest(tmp_path / "port", 1)
    assert _manifest(tmp_path / "port", 2)["cell_layout"] == "lane_major"

    none = _run_both(tmp_path, capsys, *flags, "--step", "7")
    assert none["port"] == none["jax"] == (1, ["no matching checkpoints under DIR"])
    for who in ("jax", "port"):
        shutil.rmtree(tmp_path / who)
        os.makedirs(tmp_path / who)
    empty = _run_both(tmp_path, capsys, *flags)
    assert empty["port"] == empty["jax"] == (1, ["no matching checkpoints under DIR"])


def test_migrate_tool_keeps_bf16_leaves(tmp_path, capsys):
    """A gate-major train state with bf16 Adam moments: the port's tool
    writes every leaf as the port's manager writes the lane-major state (the
    bf16 ones with the ``'<V2'`` header and manifest dtype ``"bfloat16"``),
    and it restores bitwise. JAX's tool reads such a leaf as numpy's void
    words and writes its manifest dtype as ``"|V2"`` (ROADMAP.md §C)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.training import steps

    cfg = get_config("sru-paper-large-stacked").reduced().with_(moment_dtype="bfloat16")
    g = torch.Generator().manual_seed(4)
    state = steps.init_train_state(g, cfg, device="cpu")
    for x in tree_leaves(state.opt.m) + tree_leaves(state.opt.v):  # bf16 noise, not zeros
        x.copy_(torch.randn(x.shape, generator=g))
    CheckpointManager(str(tmp_path / "port")).save(1, layout.tree_to_gate_major(state), DATA_STATE)
    _mark_legacy(tmp_path / "port", 1)
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    CheckpointManager(str(tmp_path / "lane")).save(1, state, DATA_STATE)
    out = _run_both(tmp_path, capsys)
    assert out["port"] == out["jax"] == (0, ["DIR/step_1: migrated 6 leaves to lane_major"])
    _assert_same_files(tmp_path / "port", tmp_path / "lane")
    dtypes = {e["path"]: e["dtype"] for e in _manifest(tmp_path / "port", 1)["leaves"]}
    assert dtypes["opt/m/layers/cell/w"] == "bfloat16"
    theirs = {e["path"]: e["dtype"] for e in _manifest(tmp_path / "jax", 1)["leaves"]}
    assert theirs["opt/m/layers/cell/w"] == "|V2"  # the reference's rewrite, not copied
    back, data_state = CheckpointManager(str(tmp_path / "port")).restore(1, state)
    assert data_state == DATA_STATE
    for (path, a), (_, b) in zip(flatten_with_paths(back), flatten_with_paths(state), strict=True):
        assert a.dtype == b.dtype and np.array_equal(_bits(a), _bits(b)), path


def test_migrate_tool_defaults_to_the_card(tmp_path):
    """Without ``--device cpu`` the tool runs on the card and raises where
    there is none; it never falls back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        migrate_checkpoint.main([str(tmp_path), "--quantize", "int8"])
