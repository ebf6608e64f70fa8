"""The port's checkpoint converters (``repro_torch/kernels/fused_rnn/layout.py``)
against the JAX package's, on the same numpy inputs.

The gate-major <-> lane-major conversion is a pure reshape, so the port's
result must equal JAX's bit for bit, for every dtype (fp32, bf16, fp16,
int8), gate count and padding-unfriendly shape, on numpy arrays and torch
tensors alike (a bf16 leaf as a torch tensor and as numpy's 2-byte void
words). The tree converters, ``migrate_flat_leaves`` (a bias's gate count
from its siblings, LSTM left flat, the Adam moments' paths) and
``quantize_flat_leaves`` (same keys in the same order, every leaf bitwise,
int8 leaves refused) are held the same way. Property tests run through the
offline hypothesis shim (``tests/_hypothesis_compat.py``), as
``tests/test_cell_layout.py`` does.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, strategies as st

from repro.kernels.fused_rnn import layout as jlayout
from repro_torch.kernels.fused_rnn import layout
from repro_torch.optim.adamw import AdamWState
from repro_torch.training.steps import TrainState
from repro_torch.tree import tree_map

DTYPES = ["float32", "bfloat16", "float16", "int8"]


def _payload(shape, dtype, seed):
    """Deterministic per-position values (numpy; bf16 through ml_dtypes), so
    any lane reordering or dtype round trip shows as a bit mismatch."""
    rng = np.random.default_rng(seed)
    if dtype == "int8":
        return rng.integers(-128, 128, size=shape, dtype=np.int8)
    vals = rng.standard_normal(shape).astype(np.float32)
    if dtype == "bfloat16":
        return np.asarray(jnp.asarray(vals).astype(jnp.bfloat16))
    return vals.astype(dtype)


def _tensor(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(a) -> np.ndarray:
    """Any leaf's bits as numpy: 2-byte floats as int16 words."""
    if isinstance(a, torch.Tensor):
        two_byte_float = a.is_floating_point() and a.element_size() == 2
        return a.view(torch.int16).numpy() if two_byte_float else a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.itemsize == 2 and a.dtype.kind not in "iu" else a


def _same(got, want, what=""):
    assert tuple(got.shape) == tuple(want.shape), what
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=str(what))


@given(
    st.integers(min_value=1, max_value=37),   # d (not tile-aligned)
    st.integers(min_value=1, max_value=33),   # H (odd / prime)
    st.sampled_from([2, 3, 4]),               # gate count
    st.sampled_from(DTYPES),
    st.integers(min_value=0, max_value=10_000),
)
def test_gate_lane_round_trip_matches_jax(d, H, G, dtype, seed):
    w = _payload((d, G * H), dtype, seed)
    want = jlayout.to_lane_major(w, G)
    inputs = [w, _tensor(w)]
    if dtype == "bfloat16":
        inputs.append(w.view("V2"))  # what np.load gives for a bf16 leaf
    for x in inputs:
        lane = layout.to_lane_major(x, G)
        assert tuple(lane.shape) == (d, G, H)
        _same(lane, want, type(x))
        _same(layout.to_gate_major(lane), jlayout.to_gate_major(want), type(x))
        _same(layout.to_gate_major(lane), w, type(x))


def _cell_tree(cell, L, d, H, dtype, seed):
    """A stacked ``(L, ...)`` cell dict of ``dtype`` payloads, lane-major, as
    numpy (SRU's ``w_skip`` is None at d == H, as ``sru_init`` leaves it)."""
    if cell == "sru":
        tree = {"w": _payload((L, d, 3, H), dtype, seed), "b": _payload((L, 2, H), dtype, seed + 1),
                "w_skip": None if d == H else _payload((L, d, H), dtype, seed + 2)}
    else:
        tree = {"w0": _payload((L, d, 3, H), dtype, seed),
                "w1": _payload((L, d, 3, H), dtype, seed + 1),
                "b": _payload((L, 3, H), dtype, seed + 2)}
    return {"layers": {"cell": tree, "ln": _payload((L, d), dtype, seed + 3)},
            "embed": {"embed": _payload((5, d), dtype, seed + 4)}}


def _pairs(a, b, path=""):
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            yield from _pairs(a[k], b[k], f"{path}/{k}")
    else:
        assert (a is None) == (b is None), path
        if a is not None:
            yield path, a, b


@given(
    st.sampled_from(["sru", "qrnn"]),
    st.integers(min_value=1, max_value=4),    # stacked depth
    st.integers(min_value=1, max_value=24),   # width
    st.sampled_from(DTYPES),
    st.integers(min_value=0, max_value=10_000),
)
def test_tree_converters_match_jax(cell, L, H, dtype, seed):
    d = H if seed % 2 else H + 3
    params = _cell_tree(cell, L, d, H, dtype, seed)
    mine = tree_map(_tensor, params)
    flat = layout.tree_to_gate_major(mine)
    want = jlayout.tree_to_gate_major(params)
    for path, got, w in _pairs(flat, want):
        _same(got, w, path)
    assert tuple(flat["layers"]["cell"]["b"].shape) == (L, (2 if cell == "sru" else 3) * H)
    for path, got, w in _pairs(layout.tree_to_lane_major(flat), params):
        _same(got, w, path)


def test_tree_converters_skip_lstm_and_non_cells():
    """LSTM cells (gate-major ``wx``/``uh``) and leaves outside a cell come
    back as the same objects, as JAX leaves them."""
    params = {"layers": {"cell": {"wx": torch.zeros(8, 32), "uh": torch.zeros(8, 32),
                                  "b": torch.zeros(32)},
                         "ln1": torch.ones(8)},
              "embed": {"embed": torch.zeros(16, 8)}}
    want = jlayout.tree_to_lane_major(tree_map(torch.Tensor.numpy, params))
    for fn in (layout.tree_to_lane_major, layout.tree_to_gate_major):
        for path, got, orig in _pairs(fn(params), params):
            assert got is orig, path
    for path, got, w in _pairs(layout.tree_to_lane_major(params), want):
        _same(got, w, path)


def test_tree_converters_enter_named_tuples():
    """A ``TrainState`` converts whole: params and both Adam moments (JAX's
    converter passes a NamedTuple through, so JAX converts its fields)."""
    params = tree_map(_tensor, _cell_tree("qrnn", 2, 6, 5, "float32", 3))
    state = TrainState(params=params, opt=AdamWState(step=torch.tensor(4, dtype=torch.int32),
                                                     m=params, v=params), ef=None)
    flat = layout.tree_to_gate_major(state)
    assert isinstance(flat, TrainState) and flat.ef is None and flat.opt.step is state.opt.step
    for tree in (flat.params, flat.opt.m, flat.opt.v):
        assert tuple(tree["layers"]["cell"]["w0"].shape) == (2, 6, 15)
        assert tuple(tree["layers"]["cell"]["b"].shape) == (2, 15)
    back = layout.tree_to_lane_major(flat)
    for path, got, w in _pairs(back.opt.v, params):
        _same(got, w, path)


def _legacy_leaves(H=5):
    """JAX's sibling-resolution case, plus an Adam moment's paths."""
    return {
        "a/cell/w": np.arange(4 * 3 * H, dtype=np.float32).reshape(4, 3 * H),
        "a/cell/b": np.arange(2 * H, dtype=np.float32),
        "q/cell/w0": np.arange(4 * 3 * H, dtype=np.float32).reshape(4, 3 * H) + 1,
        "q/cell/w1": np.zeros((4, 3 * H), np.float32),
        "q/cell/b": np.arange(3 * H, dtype=np.float32),
        "l/cell/wx": np.zeros((4, 4 * H), np.float32),
        "l/cell/uh": np.zeros((H, 4 * H), np.float32),
        "l/cell/b": np.zeros((4 * H,), np.float32),
        "opt/m/layers/cell/w": np.ones((2, 4, 3 * H), np.float32),
        "opt/m/layers/cell/b": np.ones((2, 2 * H), np.float32),
        "other/w": np.zeros((3, 6), np.float32),  # no cell/ component: untouched
        "cell": np.zeros((6,), np.float32),       # a path of one component
    }


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_migrate_flat_leaves_matches_jax_leaf_for_leaf(kind):
    H = 5
    leaves = _legacy_leaves(H)
    want = jlayout.migrate_flat_leaves(leaves)
    given_ = leaves if kind == "numpy" else {p: _tensor(a) for p, a in leaves.items()}
    got = layout.migrate_flat_leaves(given_)
    assert list(got) == list(want) == list(leaves)
    for path in want:
        _same(got[path], want[path], path)
    assert tuple(got["a/cell/b"].shape) == (2, H) and tuple(got["q/cell/b"].shape) == (3, H)
    assert tuple(got["opt/m/layers/cell/w"].shape) == (2, 4, 3, H)
    assert tuple(got["l/cell/b"].shape) == (4 * H,)    # LSTM untouched
    for path in ("l/cell/wx", "other/w", "cell"):
        assert got[path] is given_[path]


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_indivisible_gate_dim_raises(kind):
    bad = np.zeros((4, 7), np.float32)
    bad = bad if kind == "numpy" else torch.from_numpy(bad)
    with pytest.raises(ValueError, match="not divisible"):
        layout.to_lane_major(bad, 3)
    with pytest.raises(ValueError, match="not divisible"):
        layout.migrate_flat_leaves({"layers/cell/w": bad, "layers/cell/b": bad[0]})
    with pytest.raises(ValueError, match=r"\(G, H\) tail"):
        layout.to_gate_major(bad[0])


def _flat_params(H, dtype, seed):
    """A flat checkpoint mapping with an SRU, a QRNN and an LSTM cell, an
    Adam moment of the SRU slab, and leaves outside any cell."""
    d = 12
    return {
        "embed/embed": _payload((7, d), dtype, seed),
        "layers/cell/b": _payload((2, 2, H), dtype, seed + 1),
        "layers/cell/w": _payload((2, d, 3, H), dtype, seed + 2),
        "layers/ln": _payload((2, d), dtype, seed + 3),
        "lstm/cell/b": _payload((4 * H,), dtype, seed + 4),
        "lstm/cell/uh": _payload((H, 4 * H), dtype, seed + 5),
        "lstm/cell/wx": _payload((d, 4 * H), dtype, seed + 6),
        "opt/m/layers/cell/w": _payload((2, d, 3, H), dtype, seed + 7),
        "q/cell/b": _payload((3, H), dtype, seed + 8),
        "q/cell/w0": _payload((d, 3, H), dtype, seed + 9),
        "q/cell/w1": _payload((d, 3, H), dtype, seed + 10),
    }


@pytest.mark.parametrize("H,dtype", [(8, "float32"), (200, "float32"), (130, "bfloat16")])
def test_quantize_flat_leaves_matches_jax(H, dtype):
    """Same keys in the same order (removed paths deleted, ``wq, wq_scale``
    or ``w0q, w1q, wq_scale`` appended), every leaf bitwise; H = 200 and 130
    span two scale blocks with a ragged one."""
    leaves = _flat_params(H, dtype, seed=H)
    want = jlayout.quantize_flat_leaves(leaves)
    got = layout.quantize_flat_leaves({p: _tensor(a) for p, a in leaves.items()})
    assert list(got) == list(want) == [
        "embed/embed", "layers/cell/b", "layers/ln", "lstm/cell/b", "lstm/cell/uh",
        "lstm/cell/wx", "q/cell/b", "layers/cell/wq", "layers/cell/wq_scale",
        "opt/m/layers/cell/wq", "opt/m/layers/cell/wq_scale", "q/cell/w0q", "q/cell/w1q",
        "q/cell/wq_scale"]
    for path in want:
        w = np.asarray(want[path])
        assert str(got[path].dtype).split(".")[-1] == w.dtype.name, path
        _same(got[path], w, path)
    assert got["layers/cell/wq"].dtype == torch.int8
    assert got["q/cell/wq_scale"].dtype == torch.float32


@pytest.mark.parametrize("name", ["wq", "w0q", "w1q", "wq_scale"])
def test_quantize_flat_leaves_refuses_int8_leaves(name):
    leaves = {"layers/cell/b": np.zeros((2, 4), np.float32),
              f"layers/cell/{name}": np.zeros((3, 3, 4), np.int8)}
    with pytest.raises(ValueError, match="already int8-quantized"):
        jlayout.quantize_flat_leaves(leaves)
    with pytest.raises(ValueError, match="already int8-quantized"):
        layout.quantize_flat_leaves({p: torch.from_numpy(a) for p, a in leaves.items()})
