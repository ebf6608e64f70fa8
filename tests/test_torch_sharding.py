"""The port's sharding rules, meshes, ring matmuls and B1's shard operands
(``distribution/sharding.py``, ``distribution/fused_sharded.py``'s at-rest
layout, ``launch/mesh.py``, ``core/overlap.py``, ``launch/serve.py::
validate_engine_mesh``, ``kernels/fused_rnn``'s ``skip`` / ``scale_lane0``)
against JAX's.

JAX's side runs in one subprocess with 8 virtual CPU devices: every
registry config's ``param_specs`` (with and without ``fsdp``),
``serving_param_specs``, ``cache_specs`` (the ``decode_32k`` caches),
``batch_specs`` (the ``prefill_32k`` inputs) and ``describe_replications``
on (data 2, model 4), the 16 x 16 production shape and the multi-pod
(2, 16, 16) shape (the spec functions read only the mesh's shape), and the
four ring matmuls under ``shard_map`` on a 4-device Auto mesh. The port's
ring matmuls run in two spawns of gloo ranks, (1, 4) and (2, 2), at once.
The full shapes come from ``configs/shapes.py``'s meta tensors.
"""
from __future__ import annotations

import functools
import json
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.configs.registry import get_config as jax_get_config
from repro.kernels.fused_rnn import layout as jlayout
from repro.kernels.fused_rnn.ref import fused_rnn_ref as jax_fused_rnn_ref
from repro.kernels.fused_rnn.ref import fused_rnn_ref_q as jax_fused_rnn_ref_q
from repro.launch import serve as jserve
from repro_torch.configs import shapes
from repro_torch.configs.registry import REGISTRY, get_config
from repro_torch.core import overlap
from repro_torch.distribution import fused_sharded as fs
from repro_torch.distribution import sharding as shd
from repro_torch.kernels.fused_rnn import fused_rnn, layout
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.tree import flatten_with_paths

REPO = Path(__file__).resolve().parents[1]
MESH_SHAPES = {"2x4": {"data": 2, "model": 4}, "prod": {"data": 16, "model": 16},
               "pod": {"pod": 2, "data": 16, "model": 16}}
RING_MESHES = ((1, 4), (2, 2))
TOL = 2e-5

JAX_SCRIPT = r"""
import json, pickle, sys, types
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType, PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.configs import shapes
from repro.configs.registry import REGISTRY
from repro.core import overlap
from repro.distribution import sharding as shd
from repro.distribution.fused_sharded import serving_param_specs
from repro.models import lm

MESHES = json.loads(sys.argv[1])
def js(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]
def flat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {shd._path_str(p): js(s) for p, s in leaves}
specs = {}
for name, cfg in REGISTRY.items():
    params = jax.eval_shape(lambda: lm.lm_init(jax.random.PRNGKey(0), cfg))
    caches = shapes.cache_specs(cfg, shapes.SHAPES["decode_32k"])
    batch = shapes.prefill_input_specs(cfg, shapes.SHAPES["prefill_32k"])
    for mname, shape in MESHES.items():
        mesh = types.SimpleNamespace(shape=shape)
        plain = shd.param_specs(params, mesh)
        specs[f"{name}/{mname}"] = {
            "param": flat(plain), "param_fsdp": flat(shd.param_specs(params, mesh, fsdp=True)),
            "serving": flat(serving_param_specs(params, mesh)),
            "cache": flat(shd.cache_specs(caches, mesh)), "batch": flat(shd.batch_specs(batch, mesh)),
            "repl": shd.describe_replications(params, plain)}
ring = pickle.load(open(sys.argv[2], "rb"))
mesh = jax.make_mesh((4,), ("model",), axis_types=(AxisType.Auto,), devices=jax.devices()[:4])
def run(fn, x, w, specs, out):
    return np.asarray(shard_map(lambda xs, ws: fn(xs, ws, "model"), mesh=mesh, in_specs=specs,
                                out_specs=out, check_rep=False)(x, w))
rows = (P(None, "model"), P("model", None))
res = {"rs": run(overlap.ring_rs_matmul, ring["x"], ring["w"], rows, P(None, "model")),
       "plain_rs": run(overlap.plain_rs_matmul, ring["x"], ring["w"], rows, P(None, "model")),
       "ar": run(overlap.ring_ar_matmul, ring["x"], ring["w"], rows, P(None, None)),
       "ag": run(overlap.ring_ag_matmul, ring["xa"], ring["wa"],
                 (P(None, None, "model"), P(None, None)), P(None, None, None))}
pickle.dump({"specs": specs, "ring": res}, open(sys.argv[3], "wb"))
print("JAX-OK")
"""


def _ring_worker(rank, world, model_axis, init_file, ring_path, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world, timeout=mesh_lib.GROUP_TIMEOUT)
    try:
        mesh = mesh_lib.make_local_mesh(model_axis, device=torch.device("cpu"))
        g = mesh.axis("model")
        with open(ring_path, "rb") as f:
            r = {k: torch.tensor(v) for k, v in pickle.load(f).items()}
        k, j = g.size, g.index
        c, ca = r["x"].shape[-1] // k, r["xa"].shape[-1] // k
        x, w = r["x"][:, j * c:(j + 1) * c], r["w"][j * c:(j + 1) * c]
        xa = r["xa"][..., j * ca:(j + 1) * ca]
        out = {"rs": overlap.ring_rs_matmul(x, w, g), "plain_rs": overlap.plain_rs_matmul(x, w, g),
               "ar": overlap.ring_ar_matmul(x, w, g), "ag": overlap.ring_ag_matmul(xa, r["wa"], g),
               "ones_sum": g.all_reduce(torch.ones(1)).item()}
        with mesh_lib.timed_collectives(mesh) as clock:
            out["ag_timed"] = overlap.ring_ag_matmul(xa, r["wa"], g)
            g.all_gather(g.all_reduce(torch.ones(1)))
        out["clock"] = dict(clock)
        out["clock_off"] = all(a.clock is None for a in mesh.groups.values())
        out = {k_: (v.numpy() if torch.is_tensor(v) else v) for k_, v in out.items()}
        out["coords"] = mesh.coords
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharding")
    rng = np.random.default_rng(3)
    ring = {"x": rng.standard_normal((16, 64)).astype(np.float32),
            "w": rng.standard_normal((64, 32)).astype(np.float32),
            "xa": rng.standard_normal((4, 3, 64)).astype(np.float32),
            "wa": rng.standard_normal((64, 24)).astype(np.float32)}
    with open(tmp / "ring.pkl", "wb") as f:
        pickle.dump(ring, f)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO / "src"))
    (tmp / "ref.py").write_text(textwrap.dedent(JAX_SCRIPT))
    jax_proc = subprocess.Popen(
        [sys.executable, str(tmp / "ref.py"), json.dumps(MESH_SHAPES), str(tmp / "ring.pkl"),
         str(tmp / "jax.pkl")], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    spawns = {}
    for shape in RING_MESHES:
        out = tmp / f"{shape[0]}x{shape[1]}"
        out.mkdir()
        spawns[shape] = (out, mp.start_processes(
            _ring_worker, args=(shape[0] * shape[1], shape[1], str(out / "rdv"),
                                str(tmp / "ring.pkl"), str(out)),
            nprocs=shape[0] * shape[1], join=False, start_method="spawn"))
    ranks = {}
    for shape, (out, procs) in spawns.items():
        while not procs.join(timeout=120):
            pass
        ranks[shape] = [pickle.load(open(out / f"rank{r}.pkl", "rb"))
                        for r in range(shape[0] * shape[1])]
    stdout, stderr = jax_proc.communicate(timeout=420)
    assert jax_proc.returncode == 0 and "JAX-OK" in stdout, stderr[-3000:]
    with open(tmp / "jax.pkl", "rb") as f:
        ref = pickle.load(f)
    return {"ring_in": ring, "ring": ref["ring"], "ranks": ranks, "specs": ref["specs"]}


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

def _flat(tree) -> dict:
    out = {}

    def one(path, spec):
        out[path] = json.loads(json.dumps(spec))

    shd.map_with_paths(one, tree)
    return out


@functools.lru_cache(maxsize=None)
def _full_shapes(name: str):
    """A registry config's params, ``decode_32k`` caches and ``prefill_32k``
    inputs as meta tensors."""
    cfg = get_config(name)
    return (shapes.param_shapes(cfg), shapes.cache_specs(cfg, shapes.SHAPES["decode_32k"]),
            shapes.prefill_input_specs(cfg, shapes.SHAPES["prefill_32k"]))


@pytest.mark.parametrize("mname", sorted(MESH_SHAPES))
@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_specs_equal_jax(runs, name, mname):
    """Every spec function on every registry config's full shapes (meta
    tensors) equals JAX's on the same mesh shape; ``describe_replications``
    gives JAX's lines in JAX's order."""
    want = runs["specs"][f"{name}/{mname}"]
    mesh = mesh_lib.Mesh(MESH_SHAPES[mname])
    if mname == "prod":
        mesh = mesh_lib.make_production_mesh()
    elif mname == "pod":
        mesh = mesh_lib.make_production_mesh(multi_pod=True)
    params, caches, batch = _full_shapes(name)
    plain = shd.param_specs(params, mesh)
    assert _flat(plain) == want["param"]
    assert _flat(shd.param_specs(params, mesh, fsdp=True)) == want["param_fsdp"]
    assert _flat(fs.serving_param_specs(params, mesh)) == want["serving"]
    assert _flat(shd.cache_specs(caches, mesh)) == want["cache"]
    assert _flat(shd.batch_specs(batch, mesh)) == want["batch"]
    assert shd.describe_replications(params, plain) == want["repl"]


def test_meshes_have_jax_shapes():
    assert mesh_lib.make_production_mesh().shape == {"data": 16, "model": 16}
    pod = mesh_lib.make_production_mesh(multi_pod=True)
    assert pod.axis_names == ("pod", "data", "model") and pod.size == 512
    assert mesh_lib.dp_axes(pod) == ("pod", "data")
    assert mesh_lib.dp_axes(mesh_lib.make_production_mesh()) == ("data",)
    one = mesh_lib.make_local_mesh()  # no process group: one rank
    assert one.shape == {"data": 1, "model": 1} and one.coords == {"data": 0, "model": 0}
    x = torch.arange(6.0).reshape(2, 3)
    assert one.axis("model").all_gather(x) is x and one.axis("model").all_reduce(x) is x


def _reassemble(whole: torch.Tensor, spec, shape) -> torch.Tensor:
    """Every rank's ``local_shard`` put back at its block: must cover the
    leaf exactly, replicated pieces agreeing."""
    out = torch.full_like(whole, float("nan")) if whole.is_floating_point() else \
        torch.full_like(whole, -1)
    names = list(shape)
    for flat in range(int(np.prod(list(shape.values())))):
        coords, rest = {}, flat
        for a in reversed(names):
            coords[a] = rest % shape[a]
            rest //= shape[a]
        mesh = mesh_lib.Mesh(shape, coords)
        piece = shd.local_shard(whole, spec, mesh)
        assert tuple(piece.shape) == shd.local_shape(whole.shape, spec, mesh)
        idx = []
        for dim, s in enumerate(spec):
            i, k = shd.shard_index(s, mesh)
            n = whole.shape[dim] // k
            idx.append(slice(i * n, (i + 1) * n))
        block = out[tuple(idx)]
        seen = ~torch.isnan(block) if whole.is_floating_point() else block != -1
        assert torch.equal(block[seen], piece[seen])
        out[tuple(idx)] = piece
    return out


@pytest.mark.parametrize("shape", [(1, 2), (1, 4), (2, 2)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", ["sru-paper-large-stacked", "qrnn-paper-large-stacked-int8",
                                  "sru-paper-large-int8", "llama3-8b", "mixtral-8x22b"])
def test_local_shard_reassembles_every_leaf(name, shape):
    """``local_shard`` under JAX's serving specs and under the port's
    at-rest specs puts every leaf back exactly from its ranks' pieces."""
    cfg = get_config(name).reduced()
    if cfg.moe:
        cfg = cfg.with_(moe_impl="shard_map")
    params = lm.lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    mshape = {"data": shape[0], "model": shape[1]}
    specs = fs.serving_param_specs(params, mesh_lib.Mesh(mshape))
    for spec_tree in (specs, fs.rank_specs(cfg, specs, mesh_lib.Mesh(mshape))):
        for path, leaf in flatten_with_paths(params):
            assert torch.equal(_reassemble(leaf, shd._at(spec_tree, path), mshape), leaf), path


@pytest.mark.parametrize("shape", [(1, 2), (1, 4), (2, 2)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", ["sru-paper-large-stacked", "qrnn-paper-large-fused",
                                  "qrnn-paper-large-stacked-int8", "sru-paper-large-int8"])
def test_each_rank_holds_its_share_of_the_gate_slabs(name, shape):
    """At rest each model rank holds 1/k of the gate slab bytes (fp or
    int8), as JAX's ``test_sharded_at_rest_slab_bytes_and_decode_hlo``
    intends; the data axis holds its copies; the int8 scales stay whole."""
    cfg = get_config(name).reduced()
    params = lm.lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    whole = serve.slab_bytes(params)
    k = shape[1]
    for d in range(shape[0]):
        for m in range(k):
            mesh = mesh_lib.Mesh({"data": shape[0], "model": k}, {"data": d, "model": m})
            local, _ = serve.shard_params(cfg, params, mesh)
            assert serve.slab_bytes(local) * k == whole
            if cfg.weight_quant == "int8":  # the compact scales are held whole
                assert torch.equal(local["layers"]["cell"]["wq_scale"],
                                   params["layers"]["cell"]["wq_scale"])


@pytest.mark.parametrize("name", ["sru-paper-large-stacked", "qrnn-paper-large-stacked-int8"])
def test_startup_lists_the_dims_a_rank_replicates(name):
    """``serve.shard_params``'s startup lines are ``describe_replications``
    of the rank's at-rest specs at full shape, which are JAX's: neither the
    vocab leaves nor a gate slab the rank holds its lanes of is listed."""
    cfg = get_config(name)
    params = shapes.param_shapes(cfg)
    mesh = mesh_lib.Mesh({"data": 1, "model": 2}, {"data": 0, "model": 1})
    _, lines = serve.shard_params(cfg, params, mesh)
    specs = fs.serving_param_specs(params, mesh)
    assert lines == shd.describe_replications(params, fs.rank_specs(cfg, specs, mesh))
    assert not any("embed/" in line or "/cell/" in line for line in lines)
    assert lines == shd.describe_replications(params, specs)


def test_rank_specs_keep_the_model_axis_only_where_the_port_shards():
    mesh = mesh_lib.Mesh({"data": 2, "model": 4})
    cfg = get_config("sru-paper-large-stacked")
    params = shapes.param_shapes(cfg)
    rank = fs.rank_specs(cfg, fs.serving_param_specs(params, mesh), mesh)
    assert rank["layers"]["cell"]["w"] == (None, None, None, "model")
    assert rank["layers"]["cell"]["b"] == (None, None, "model")
    assert rank["embed"]["embed"] == ("model", None)
    assert rank["embed"]["unembed"] == (None, "model")
    xla = cfg.with_(scan_engine="chunked")
    assert fs.rank_specs(xla, fs.serving_param_specs(params, mesh), mesh)["layers"]["cell"][
        "w"] == (None, None, None, "model")
    odd = cfg.with_(rnn_hidden=1000, d_model=1000)
    p_odd = shapes.param_shapes(odd)
    mesh3 = mesh_lib.Mesh({"data": 1, "model": 3})
    r_odd = fs.rank_specs(odd, fs.serving_param_specs(p_odd, mesh3), mesh3)
    assert r_odd["layers"]["cell"]["w"] == (None, None, None, None)
    assert r_odd["embed"]["embed"] == (None, None)  # 8192 does not divide by 3
    lstm = get_config("lstm-paper-large")
    r_lstm = fs.rank_specs(lstm, fs.serving_param_specs(shapes.param_shapes(lstm), mesh), mesh)
    assert r_lstm["layers"]["cell"]["wx"] == (None, None, "model")
    assert r_lstm["layers"]["cell"]["b"] == (None, "model")
    moe = get_config("qwen3-moe-235b-a22b")
    p_moe = shapes.param_shapes(moe)
    r = fs.rank_specs(moe, fs.serving_param_specs(p_moe, mesh), mesh)
    assert r["layers"]["moe"]["e_up"] == (None, "model", None, None)  # 128 experts over 4
    assert r["layers"]["attn"]["w_q"] == (None, None, "model")  # He Dh = 8192 over 4
    assert r["layers"]["attn"]["w_o"] == (None, "model", None)
    assert r["layers"]["ln1"] == (None, None)
    llama = get_config("llama3-8b")
    r_llama = fs.rank_specs(llama, fs.serving_param_specs(shapes.param_shapes(llama), mesh),
                            mesh)
    assert r_llama["layers"]["mlp"]["w_down"] == (None, "model", None)
    assert r_llama["layers"]["attn"]["w_kv"] == (None, None, "model")
    assert fs.rank_specs(moe.with_(moe_impl="sorted"), fs.serving_param_specs(p_moe, mesh),
                         mesh)["layers"]["moe"]["e_up"] == (None, "model", None, None)
    one = mesh_lib.Mesh({"data": 2, "model": 1})  # a model axis of one rank shards nothing
    assert fs.rank_specs(cfg, fs.serving_param_specs(params, one), one)["embed"]["embed"] == (
        None, None)
    caches = lm.lm_init_caches(cfg, 8, 1, device="meta")
    cs = fs.rank_cache_specs(cfg, caches, mesh)
    assert cs["layers"]["c"] == (None, "data", "model")
    assert fs.rank_cache_specs(xla, caches, mesh)["layers"]["c"] == (None, "data", "model")
    assert fs.rank_cache_specs(cfg, caches, one)["layers"]["c"] == (None, "data", None)
    kv = fs.rank_cache_specs(llama, lm.lm_init_caches(llama, 8, 64, device="meta"), mesh)
    assert kv["layers"]["k"] == (None, "data", None, "model", None)  # 8 KV heads over 4


PAPER = sorted(n for n in REGISTRY if get_config(n).cell is not None)


def _without_wq_scale(flat: dict) -> dict:
    return {k: v for k, v in flat.items() if not k.endswith("wq_scale")}


@pytest.mark.parametrize("mname", ["2x4", "prod"])
@pytest.mark.parametrize("name", PAPER)
def test_paper_configs_rest_as_jax_places_them(runs, name, mname):
    """For every paper config on (2, 4) and the 16 x 16 production shape the
    port's at-rest specs are JAX's ``param_specs`` leaf for leaf (but for
    ``wq_scale``, held whole: ROADMAP §C) and JAX's ``cache_specs``."""
    want = runs["specs"][f"{name}/{mname}"]
    mesh = mesh_lib.make_production_mesh() if mname == "prod" else mesh_lib.Mesh(
        MESH_SHAPES[mname])
    cfg = get_config(name)
    params, caches, _ = _full_shapes(name)
    rank = _flat(fs.rank_specs(cfg, shd.param_specs(params, mesh), mesh))
    assert _without_wq_scale(rank) == _without_wq_scale(want["param"])
    assert _flat(fs.rank_cache_specs(cfg, caches, mesh)) == want["cache"]
    scales = [k for k in rank if k.endswith("wq_scale")]
    assert all(rank[k] == [None] * len(rank[k]) for k in scales)


# ---------------------------------------------------------------------------
# Ring matmuls
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", RING_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("op", ["rs", "plain_rs", "ar", "ag"])
def test_ring_matmuls_match_plain_and_jax(runs, op, shape):
    """``ring_rs/ag/ar_matmul`` and ``plain_rs_matmul`` on each rank against
    the plain product and, on the 4-wide model axis, against JAX's under
    ``shard_map``, at 2e-5."""
    r = runs["ring_in"]
    full = r["xa"] @ r["wa"] if op == "ag" else r["x"] @ r["w"]
    for rk in runs["ranks"][shape]:
        k, j = shape[1], rk["coords"]["model"]
        got = rk[op]
        assert rk["ones_sum"] == k
        if op in ("rs", "plain_rs"):
            n = full.shape[-1] // k
            want = full[..., j * n:(j + 1) * n]
            jax_want = runs["ring"][op][..., j * n:(j + 1) * n] if k == 4 else None
        else:
            want, jax_want = full, (runs["ring"][op] if k == 4 else None)
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(full).max())
        if jax_want is not None:
            np.testing.assert_allclose(got, jax_want, rtol=0, atol=TOL * np.abs(full).max())


@pytest.mark.parametrize("shape", RING_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_timed_collectives_time_each_collective(runs, shape):
    """Inside ``timed_collectives`` every collective of the mesh adds its
    host seconds under its name (the ring shift's start and its wait apart)
    and the results are unchanged; outside, nothing is timed."""
    for rk in runs["ranks"][shape]:
        assert sorted(rk["clock"]) == ["all_gather", "all_reduce", "shift", "shift_wait"]
        assert all(t >= 0.0 for t in rk["clock"].values())
        np.testing.assert_array_equal(rk["ag_timed"], rk["ag"])
        assert rk["clock_off"]


# ---------------------------------------------------------------------------
# Startup refusals: JAX's messages
# ---------------------------------------------------------------------------

REFUSALS = {
    "pallas": ("sru-paper-large", {"scan_engine": "pallas"}, 2, False, None, None),
    "indivisible": ("sru-paper-large-fused", {}, 3, False, None, None),
    "ring_without_stack": ("sru-paper-large-fused", {}, 2, True, None, None),
    "ring_one_shard": ("sru-paper-large-stacked", {}, 1, True, None, None),
    "batch": ("sru-paper-large-stacked", {}, 2, False, 3, 2),
    "unknown_engine": ("sru-paper-large", {"scan_engine": "bogus"}, 1, False, None, None),
    "int8_lstm": ("lstm-paper-large", {"weight_quant": "int8"}, 1, False, None, None),
    "int8_xla": ("sru-paper-large-int8", {"scan_engine": "chunked"}, 2, False, None, None),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_validate_engine_mesh_gives_jax_messages(case):
    """Each refusal of ``validate_engine_mesh`` has JAX's message (the
    engine matrix after it is each package's own)."""
    name, over, k, ring, batch, data = REFUSALS[case]
    msgs = []
    for get, validate in ((jax_get_config, jserve.validate_engine_mesh),
                          (get_config, serve.validate_engine_mesh)):
        cfg = get(name).with_(**over).reduced()
        with pytest.raises(SystemExit) as exc:
            validate(cfg, k, ring, batch=batch, data_shards=data)
        msgs.append(str(exc.value).split("\nsupported engines")[0])
    assert msgs[0] == msgs[1]


def test_validate_engine_mesh_passes_what_jax_passes():
    for name, k, ring in (("sru-paper-large-stacked", 2, True), ("qrnn-paper-large-fused", 4, False),
                          ("sru-paper-large", 2, False), ("llama3-8b", 2, False)):
        cfg = get_config(name).reduced()
        serve.validate_engine_mesh(cfg, k, ring, batch=4, data_shards=2)
        jserve.validate_engine_mesh(jax_get_config(name).reduced(), k, ring, batch=4,
                                    data_shards=2)


# ---------------------------------------------------------------------------
# B1's shard operands on the plain path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,i", [(2, 0), (2, 1), (4, 0), (4, 3)])
def test_explicit_skip_gives_the_layer_lane_slice(k, i):
    """A shard of an ``sru_identity`` layer (d = 64 > Hl) with its own lane
    slice of the input as ``skip`` gives JAX's whole-layer reference's lanes."""
    rng = np.random.default_rng(11)
    T, B, d = 9, 3, 64
    u = rng.standard_normal((T, B, d)).astype(np.float32)
    w = (rng.standard_normal((d, 3, d)) * d ** -.5).astype(np.float32)
    b3 = (rng.standard_normal((3, d)) * .1).astype(np.float32)
    c0 = rng.standard_normal((B, d)).astype(np.float32)
    h_j, c_j = jax_fused_rnn_ref(u, w, b3, None, c0, mode="sru_identity")
    Hl = d // k
    lanes = slice(i * Hl, (i + 1) * Hl)
    ut = torch.tensor(u)
    h, c = fused_rnn.fused_rnn_layer(
        ut, (torch.tensor(w[..., lanes]),), torch.tensor(b3[:, lanes]), torch.tensor(c0[:, lanes]),
        mode="sru_identity", skip=ut[..., lanes].contiguous())
    np.testing.assert_allclose(h.numpy(), np.asarray(h_j)[..., lanes], rtol=0, atol=TOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_j)[:, lanes], rtol=0, atol=TOL)


@pytest.mark.parametrize("mode", ["sru_identity", "qrnn"])
def test_bf16_slabs_under_fp32_io_give_jax_layer(mode):
    """The sharded barrier stack's B1 call under bf16 compute: fp32 input,
    bias, carry and skip with a shard's bf16 slabs, against JAX's layer
    reference on the same fp32 input and bf16 slab (widened exactly)."""
    rng = np.random.default_rng(13)
    T, B, d, Hl, lane0 = 7, 3, 64, 32, 32
    lanes = slice(lane0, lane0 + Hl)
    u = rng.standard_normal((T, B, d)).astype(np.float32)
    ws = [jnp.asarray(rng.standard_normal((d, 3, d)) * d ** -.5, dtype=jnp.bfloat16)
          for _ in range(2 if mode == "qrnn" else 1)]
    b3 = (rng.standard_normal((3, d)) * .1).astype(np.float32)
    c0 = rng.standard_normal((B, d)).astype(np.float32)
    ut = torch.tensor(u)
    taps = tuple(torch.tensor(np.asarray(w[..., lanes]).astype(np.float32)).to(torch.bfloat16)
                 for w in ws)
    if mode == "qrnn":
        tail = rng.standard_normal((1, B, d)).astype(np.float32)
        uu = np.concatenate([u, np.concatenate([tail, u[:-1]], 0)], -1)
        h_j, c_j = jax_fused_rnn_ref(uu, jnp.concatenate(ws, 0), b3, None, c0, mode="qrnn")
        kw = {"tail": torch.tensor(tail)}
    else:
        h_j, c_j = jax_fused_rnn_ref(u, ws[0], b3, None, c0, mode="sru_identity")
        kw = {"skip": ut[..., lanes].contiguous()}
    assert fused_rnn.slab_dtype(ut, taps, None) == torch.bfloat16
    h, c = fused_rnn.fused_rnn_layer(ut, taps, torch.tensor(b3[:, lanes]).contiguous(),
                                     torch.tensor(c0[:, lanes]).contiguous(), mode=mode, **kw)
    assert h.dtype == c.dtype == torch.float32
    np.testing.assert_allclose(h.numpy(), np.asarray(h_j)[..., lanes], rtol=0, atol=TOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_j)[:, lanes], rtol=0, atol=TOL)


@pytest.mark.parametrize("mode", ["sru_identity", "qrnn"])
@pytest.mark.parametrize("i", range(8))
def test_int8_shard_inside_a_scale_block(i, mode):
    """H = 1000 over 8 shards: Hl = 125, so shards 1-7 start inside a
    128-lane scale block and some cross into the next. The shard's blocks
    with ``scale_lane0`` give JAX's whole int8 reference's lanes."""
    rng = np.random.default_rng(12)
    T, B, H = 5, 2, 1000
    u = rng.standard_normal((T, B, H)).astype(np.float32)
    w = (rng.standard_normal((H, 3, H)) * H ** -.5).astype(np.float32)
    b3 = (rng.standard_normal((3, H)) * .1).astype(np.float32)
    c0 = rng.standard_normal((B, H)).astype(np.float32)
    wq, scale = jlayout.quantize_slabs(jnp.asarray(w))
    wq, scale = np.asarray(wq), np.asarray(scale)
    s3 = np.asarray(jlayout.expand_scales(jnp.asarray(scale), H))
    Hl, lanes = 125, slice(i * 125, (i + 1) * 125)
    ut = torch.tensor(u)
    if mode == "qrnn":
        w1 = (rng.standard_normal((H, 3, H)) * H ** -.5).astype(np.float32)
        w0q, w1q, scale = (np.asarray(a) for a in jlayout.quantize_qrnn_slabs(
            jnp.asarray(w), jnp.asarray(w1)))
        s3 = np.asarray(jlayout.expand_scales(jnp.asarray(scale), H))
        tail = rng.standard_normal((1, B, H)).astype(np.float32)
        uu = np.concatenate([u, np.concatenate([tail, u[:-1]], 0)], -1)
        h_j, c_j = jax_fused_rnn_ref_q(uu, np.concatenate([w0q, w1q], 0), s3, b3, None, c0,
                                       mode="qrnn")
        taps = (torch.tensor(w0q[..., lanes]).contiguous(), torch.tensor(w1q[..., lanes]).contiguous())
        kw = {"tail": torch.tensor(tail)}
    else:
        h_j, c_j = jax_fused_rnn_ref_q(u, wq, s3, b3, None, c0, mode="sru_identity")
        taps = (torch.tensor(wq[..., lanes]).contiguous(),)
        kw = {"skip": ut[..., lanes].contiguous()}
    blocks, off = fs._scale_shard(torch.tensor(scale), i * Hl, Hl)
    assert off == (i * Hl) % 128 and blocks.shape[-1] == layout.n_scale_blocks(off + Hl)
    h, c = fused_rnn.fused_rnn_layer(ut, taps, torch.tensor(b3[:, lanes]).contiguous(),
                                     torch.tensor(c0[:, lanes]).contiguous(), mode=mode,
                                     scale=blocks, scale_lane0=off, **kw)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_j)[..., lanes], rtol=0, atol=TOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_j)[:, lanes], rtol=0, atol=TOL)
