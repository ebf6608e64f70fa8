"""The port's multi-rank serving path (``distribution/fused_sharded.py``,
``models/moe.py::_moe_shard_map``, the mesh step builders, ``serve
--model-shards``) against JAX's sharded functions on the same inputs.

The inputs (cell slabs, stacks, MoE experts, whole LM params from the
port's ``lm_init``) are made once here from a seed and written to a pickle.
Two sides then run at once on them:

* JAX, in one subprocess with 8 virtual CPU devices
  (``XLA_FLAGS=--xla_force_host_platform_device_count=8``), on meshes built
  with ``axis_types=(AxisType.Auto,) * 2``: under jax 0.9 ``jax.make_mesh``
  builds Explicit axes, which the reference's ``with_sharding_constraint``
  in ``build_prefill_step`` refuses; on Auto axes it runs unchanged.
  (JAX's own ``serve --model-shards`` builds its mesh with
  ``make_local_mesh`` and so cannot run on jax 0.9; its sharded steps are
  called here directly.)
* the port, in ``torch.multiprocessing`` spawns of gloo ranks (a ``file://``
  rendezvous, one thread a rank), one spawn per (data, model) mesh in {(1, 2),
  (1, 4), (2, 2)}, each running every case on its rank's shards.

Tolerances are the reference's: 2e-5 for a layer and MoE, 3e-5 for a stack
and for logits; under bf16 compute (the ``-bf16`` stack and serving cases)
one bf16 ulp of each value (``_close``). The CLI runs ``serve --model-shards 2`` as subprocesses and
holds their greedy tokens to the single-device serve's.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import bridge
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import get_config
from repro_torch.distribution import fused_sharded as fs
from repro_torch.distribution import sharding as shd
from repro_torch.kernels.fused_rnn import layout, ops, stacked
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import serve
from repro_torch.models import lm, moe
from repro_torch.training.steps import build_decode_step, build_prefill_step

REPO = Path(__file__).resolve().parents[1]
MESHES = ((1, 2), (1, 4), (2, 2))
LAYER_MODES = (("sru_identity", 64, 64), ("sru_proj", 48, 64), ("qrnn", 64, 64))
T, B, L = 12, 4, 2
MOE_CFS = (8.0, 0.5)
SERVE_CASES = (("sru-paper-large-stacked", False), ("sru-paper-large-stacked", True),
               ("qrnn-paper-large-fused", False), ("qrnn-paper-large-stacked-int8", False))
# Under bf16 compute, the configs' default: the SRU and QRNN stacks in the
# barrier schedule, the SRU stack in the ring and the int8 QRNN stack (its
# config carries ring_overlap); the int8 barrier under bf16 is a stack case.
SERVE_BF16_CASES = (("sru-paper-large-stacked", False), ("sru-paper-large-stacked", True),
                    ("qrnn-paper-large-stacked", False),
                    ("qrnn-paper-large-stacked-int8", False))
STACK_VARIANTS = ("fp", "int8", "fp-bf16", "int8-bf16")
S0, S_END = 16, 20
JOIN_CASE = ("qrnn-paper-large-stacked", False)
LAYER_TOL, STACK_TOL = 2e-5, 3e-5


def _close(got, ref, bf16: bool, each: bool = True) -> None:
    """Within STACK_TOL; under bf16 compute, each element within one bf16
    ulp of its own magnitude: the two packages compute the same fp32 values
    to ~1e-6 and round them to bf16, so an element near a rounding boundary
    may land one ulp apart (the readings at this size: 0 or exactly one ulp,
    never more). ``each=False``, for what is computed in bf16 from such
    rounded values (the logits, the head's GEMM over a stream that may hold
    such a flip): one ulp of the largest magnitude."""
    if not bf16:
        np.testing.assert_allclose(got, ref, rtol=0, atol=STACK_TOL)
        return
    mag = np.maximum(np.maximum(np.abs(got), np.abs(ref)), np.finfo(np.float32).tiny)
    mag = mag if each else mag.max()
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    err = np.abs(got - ref)
    assert np.all(err <= ulp), f"max {float((err / ulp).max())} bf16 ulps apart"


def _moe_cfg(cf: float) -> ArchConfig:
    return ArchConfig(name="t", family="moe", n_layers=1, d_model=32, vocab=64, d_ff=48,
                      mlp_type="swiglu", moe=True, n_experts=8, top_k=2, moe_impl="shard_map",
                      capacity_factor=cf, renorm_topk=True)


def _serve_cfg(name: str, ring: bool, bf16: bool = False):
    """``name`` reduced; ``ring``: with ring_overlap (False keeps the
    config's own); ``bf16``: bf16 compute."""
    cfg = get_config(name).reduced()
    cfg = cfg.with_(ring_overlap=True) if ring else cfg
    return cfg.with_(compute_dtype="bfloat16") if bf16 else cfg


def _serve_key(key):
    """``serve/<name>/<ring>[-bf16]`` -> (name, ring, bf16)."""
    _, name, var = key.split("/")
    return name, var.startswith("True"), var.endswith("-bf16")


def _make_inputs() -> dict:
    rng = np.random.default_rng(0)

    def normal(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def quant(p):
        return bridge.params_to_numpy(layout.quantize_cell(bridge.params_from_numpy(p, device="cpu")))

    cases = {}
    for mode, d, H in LAYER_MODES:
        if mode == "qrnn":
            p = {"w0": normal(d, 3, H, scale=d ** -.5), "w1": normal(d, 3, H, scale=d ** -.5),
                 "b": normal(3, H, scale=.1)}
        else:
            p = {"w": normal(d, 3, H, scale=d ** -.5), "b": normal(2, H, scale=.1),
                 "w_skip": None if mode == "sru_identity" else normal(d, H, scale=d ** -.5)}
        io = {"x": normal(T, B, d), "c0": normal(B, H), "tail": normal(1, B, d)}
        cases[f"layer/{mode}/fp"] = {"params": p, **io}
        cases[f"layer/{mode}/int8"] = {"params": quant(p), **io}
    d = 64
    for cell in ("sru", "qrnn"):
        if cell == "qrnn":
            p = {"w0": normal(L, d, 3, d, scale=d ** -.5), "w1": normal(L, d, 3, d, scale=d ** -.5),
                 "b": normal(L, 3, d, scale=.1)}
        else:
            p = {"w": normal(L, d, 3, d, scale=d ** -.5), "b": normal(L, 2, d, scale=.1),
                 "w_skip": None}
        io = {"ln": 1.0 + normal(L, d, scale=.1), "x": normal(T, B, d), "c0": normal(L, B, d),
              "tails": normal(L, B, d)}
        cases[f"stack/{cell}/fp"] = cases[f"stack/{cell}/fp-bf16"] = {"params": p, **io}
        cases[f"stack/{cell}/int8"] = cases[f"stack/{cell}/int8-bf16"] = {"params": quant(p),
                                                                          **io}
    for cf in MOE_CFS:
        gen = torch.Generator().manual_seed(7)
        cases[f"moe/{cf}/-"] = {"params": bridge.params_to_numpy(moe.moe_init(gen, _moe_cfg(cf),
                                                                           torch.float32, "cpu")),
                              "x": normal(4, 16, 32)}
    for var, serve_cases in (("", SERVE_CASES), ("-bf16", SERVE_BF16_CASES)):
        for name, ring in serve_cases:
            cfg = _serve_cfg(name, ring)
            params = lm.lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
            cases[f"serve/{name}/{ring}{var}"] = {
                "params": bridge.params_to_numpy(params),
                "tokens": rng.integers(0, cfg.vocab, (B, S_END)).astype(np.int32)}
    return cases


JAX_SCRIPT = r"""
import pickle, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs.base import ArchConfig
from repro.configs.registry import get_config
from repro.distribution import fused_sharded as fs
from repro.distribution import sharding as shd
from repro.distribution.sharding import use_rules
from repro.models import moe
from repro.models.lm import _cast_params
from repro.training.steps import build_decode_step, build_prefill_step

cases = pickle.load(open(sys.argv[1], "rb"))
def mesh(shape):
    n = shape[0] * shape[1]
    return jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:n])
M22, M14, M12 = mesh((2, 2)), mesh((1, 4)), mesh((1, 2))
tree = lambda p: jax.tree_util.tree_map(jnp.asarray, p)
f32 = lambda a: np.asarray(a).astype(np.float32)
out = {}
for key, c in cases.items():
    kind, name, var = key.split("/")
    bf16 = var.endswith("-bf16")
    if kind == "layer":
        if name == "qrnn":
            h, cl = fs.sharded_fused_qrnn(tree(c["params"]), c["x"], c["tail"], c["c0"], mesh=M22)
        else:
            h, cl = fs.sharded_fused_sru(tree(c["params"]), c["x"], c["c0"], mesh=M22)
        out[key] = {"h": np.asarray(h), "c": np.asarray(cl)}
    elif kind == "stack":
        dt = jnp.bfloat16 if bf16 else jnp.float32
        p = _cast_params(tree(c["params"]), dt)
        a = {k: jnp.asarray(c[k], dt) for k in ("ln", "x", "c0", "tails")}
        for mname, m in (("2x2", M22), ("1x4", M14), ("1x2", M12)):
            for sched in ("barrier", "ring"):
                if name == "qrnn":
                    y, cl, tl = fs.sharded_fused_qrnn_stack(
                        p, a["ln"], a["x"], a["tails"], a["c0"], mesh=m, schedule=sched)
                    r = {"y": y, "c": cl, "tails": tl}
                else:
                    y, cl = fs.sharded_fused_sru_stack(p, a["ln"], a["x"], a["c0"], mesh=m,
                                                       schedule=sched)
                    r = {"y": y, "c": cl}
                out[f"{key}/{mname}/{sched}"] = {k: f32(v) for k, v in r.items()}
    elif kind == "moe":
        cfg = ArchConfig(name="t", family="moe", n_layers=1, d_model=32, vocab=64, d_ff=48,
                         mlp_type="swiglu", moe=True, n_experts=8, top_k=2,
                         moe_impl="shard_map", capacity_factor=float(name), renorm_topk=True)
        with use_rules(M22):
            y = jax.jit(lambda p, x: moe.moe_apply(p, cfg, x))(tree(c["params"]), c["x"])
        out[key] = {"y": np.asarray(y)}
    else:
        cfg = get_config(name).reduced()
        if var.startswith("True"):
            cfg = cfg.with_(ring_overlap=True)
        if bf16:
            cfg = cfg.with_(compute_dtype="bfloat16")
        params = tree(c["params"])
        psh = jax.device_put(params, shd.named_shardings(fs.serving_param_specs(params, M22), M22))
        prefill = jax.jit(build_prefill_step(cfg, M22, batch=c["tokens"].shape[0], max_len=%(S_END)d))
        decode = jax.jit(build_decode_step(cfg, M22))
        toks = c["tokens"]
        lg, caches = prefill(psh, {"inputs": toks[:, :%(S0)d]})
        logits = [f32(lg)]
        for t in range(%(S0)d, %(S_END)d):
            lg, caches = decode(psh, caches, toks[:, t:t + 1])
            logits.append(f32(lg))
        out[key] = {"logits": np.stack(logits), "c": f32(caches["layers"]["c"])}
pickle.dump(out, open(sys.argv[2], "wb"))
print("JAX-OK")
""" % {"S0": S0, "S_END": S_END}


def _np_torch(p):
    return bridge.params_from_numpy(p, device="cpu")


def _shards(tree_np, specs, mesh):
    return shd.map_with_paths(lambda path, x: shd.local_shard(x, shd._at(specs, path), mesh),
                              _np_torch(tree_np))


def _cell_specs(params, mesh, stacked_dim: bool):
    """The at-rest specs of a bare cell dict: serving specs of it under a
    ``layers/cell`` (stacked) or ``cell`` prefix, wq_scale held whole."""
    tree = {"layers": {"cell": params}} if stacked_dim else {"cell": params}
    cfg = get_config("sru-paper-large-fused").with_(rnn_hidden=64)
    specs = fs.rank_specs(cfg, fs.serving_param_specs(_np_torch(tree), mesh), mesh)
    return specs["layers"]["cell"] if stacked_dim else specs["cell"]


def _rank_cases(mesh, cases) -> dict:
    """Every case on this rank's shards; returns this rank's outputs."""
    torch.manual_seed(0)
    dev = torch.device("cpu")
    bspec = (fs._batch_spec(mesh, B),)
    res = {}
    for key, c in cases.items():
        kind, name, var = key.split("/")
        if kind == "layer":
            p = _shards(c["params"], _cell_specs(c["params"], mesh, False), mesh)
            x = shd.local_shard(torch.tensor(c["x"]), (None,) + bspec, mesh)
            c0 = shd.local_shard(torch.tensor(c["c0"]), bspec + ("model",), mesh)
            if name == "qrnn":
                tail = shd.local_shard(torch.tensor(c["tail"]), (None,) + bspec, mesh)
                h, cl = fs.sharded_fused_qrnn(p, x, tail, c0, mesh=mesh)
            else:
                h, cl = fs.sharded_fused_sru(p, x, c0, mesh=mesh)
            res[key] = {"h": h.numpy(), "c": cl.numpy()}
        elif kind == "stack":
            dt = torch.bfloat16 if var.endswith("-bf16") else torch.float32
            p = layout.cast_params(_shards(c["params"], _cell_specs(c["params"], mesh, True),
                                           mesh), dt)
            x = shd.local_shard(torch.tensor(c["x"]), (None,) + bspec, mesh).to(dt)
            c0 = shd.local_shard(torch.tensor(c["c0"]), (None,) + bspec + ("model",), mesh).to(dt)
            tails = shd.local_shard(torch.tensor(c["tails"]), (None,) + bspec, mesh).to(dt)
            ln = torch.tensor(c["ln"]).to(dt)
            for sched in ("barrier", "ring"):
                if name == "qrnn":
                    y, cl, tl = fs.sharded_fused_qrnn_stack(p, ln, x, tails, c0, mesh=mesh,
                                                            schedule=sched)
                    r = {"y": y, "c": cl, "tails": tl}
                else:
                    y, cl = fs.sharded_fused_sru_stack(p, ln, x, c0, mesh=mesh, schedule=sched)
                    r = {"y": y, "c": cl}
                res[f"{key}/{sched}"] = {k: v.float().numpy() for k, v in r.items()}
        elif kind == "moe":
            cfg = _moe_cfg(float(name))
            whole = _np_torch(c["params"])
            specs = fs.rank_specs(cfg, shd.param_specs(whole, mesh), mesh)
            p = _shards(c["params"], specs, mesh)
            x = shd.local_shard(torch.tensor(c["x"]), bspec + (None, None), mesh)
            with shd.use_rules(mesh):
                res[key] = {"y": moe.moe_apply(p, cfg, x).numpy(), "E_loc": p["e_up"].shape[0]}
        else:
            cfg = _serve_cfg(*_serve_key(key))
            p, _ = serve.shard_params(cfg, _np_torch(c["params"]), mesh)
            toks = shd.local_shard(torch.tensor(c["tokens"], dtype=torch.int64), bspec + (None,),
                                   mesh)
            prefill = build_prefill_step(cfg, mesh, batch=B, max_len=S_END, device=dev)
            decode = build_decode_step(cfg, mesh)
            lg, caches = prefill(p, {"inputs": toks[:, :S0]})
            logits = [lg.float().numpy()]
            for t in range(S0, S_END):
                lg, caches = decode(p, caches, toks[:, t:t + 1])
                logits.append(lg.float().numpy())
            res[key] = {"logits": np.stack(logits), "c": caches["layers"]["c"].float().numpy(),
                        "slab_bytes": serve.slab_bytes(p)}
    return res


def _worker(rank, world, model_axis, init_file, cases_path, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world, timeout=mesh_lib.GROUP_TIMEOUT)
    try:
        mesh = mesh_lib.make_local_mesh(model_axis, device=torch.device("cpu"))
        with open(cases_path, "rb") as f:
            cases = pickle.load(f)
        res = _rank_cases(mesh, cases)
        res["coords"] = mesh.coords
        # serve's command line inside an initialised group (as under
        # torchrun): it joins, with the ranks beyond one model group on "data"
        with contextlib.redirect_stdout(io.StringIO()) as out:
            assert serve.main(_serve_argv(*JOIN_CASE) + ["--model-shards", str(model_axis)]) == 0
        res["joined"] = out.getvalue()
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def _serve_argv(name, ring):
    argv = ["--arch", name, "--reduced", "--device", "cpu", "--batch", "4", "--prompt-len", "12",
            "--gen-len", "6"]
    return argv + (["--ring-overlap"] if ring else [])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the JAX reference, the serve subprocesses and one spawn of gloo
    ranks per mesh, all at once; wait for all; return their results."""
    tmp = tmp_path_factory.mktemp("dist")
    cases = _make_inputs()
    cases_path = tmp / "cases.pkl"
    with open(cases_path, "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO / "src"))
    (tmp / "ref.py").write_text(textwrap.dedent(JAX_SCRIPT))
    jax_proc = subprocess.Popen([sys.executable, str(tmp / "ref.py"), str(cases_path),
                                 str(tmp / "jax.pkl")], env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    cli = {}
    for name, ring in SERVE_CASES:
        cli[(name, ring)] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.serve", *_serve_argv(name, ring),
             "--model-shards", "2"], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
    spawns = {}
    for shape in MESHES:
        out = tmp / f"{shape[0]}x{shape[1]}"
        out.mkdir()
        spawns[shape] = (out, mp.start_processes(
            _worker, args=(shape[0] * shape[1], shape[1], str(out / "rdv"), str(cases_path),
                           str(out)), nprocs=shape[0] * shape[1], join=False,
            start_method="spawn"))
    ranks = {}
    for shape, (out, procs) in spawns.items():
        while not procs.join(timeout=240):
            pass
        ranks[shape] = [pickle.load(open(out / f"rank{r}.pkl", "rb"))
                        for r in range(shape[0] * shape[1])]
    served = {}
    for key, proc in cli.items():
        stdout, stderr = proc.communicate(timeout=300)
        assert proc.returncode == 0, stderr[-3000:]
        served[key] = stdout
    stdout, stderr = jax_proc.communicate(timeout=420)
    assert jax_proc.returncode == 0 and "JAX-OK" in stdout, stderr[-3000:]
    with open(tmp / "jax.pkl", "rb") as f:
        ref = pickle.load(f)
    return {"cases": cases, "ref": ref, "ranks": ranks, "served": served}


def _assemble(ranks, key, field, batch_dim, lane_dim=None):
    """The whole array from the ranks' pieces: batch rows by data index,
    lanes by model index (replicated pieces must agree bit for bit)."""
    data = max(r["coords"]["data"] for r in ranks) + 1
    model = max(r["coords"]["model"] for r in ranks) + 1
    rows = []
    for i in range(data):
        pieces = [r[key][field] for r in sorted(ranks, key=lambda r: r["coords"]["model"])
                  if r["coords"]["data"] == i]
        if lane_dim is None:
            for p in pieces[1:]:
                np.testing.assert_array_equal(p, pieces[0])
            rows.append(pieces[0])
        else:
            assert len(pieces) == model
            rows.append(np.concatenate(pieces, axis=lane_dim))
    return np.concatenate(rows, axis=batch_dim) if batch_dim is not None else rows[0]


def _mesh_id(shape):
    return f"{shape[0]}x{shape[1]}"


@pytest.mark.parametrize("shape", MESHES, ids=_mesh_id)
@pytest.mark.parametrize("quant", ("fp", "int8"))
@pytest.mark.parametrize("mode", [m for m, _, _ in LAYER_MODES])
def test_sharded_layer_matches_jax_and_single_device(runs, mode, quant, shape):
    """One fused layer, per rank on its lane shard (B1's plain version on the
    CPU), against JAX's ``sharded_fused_sru/qrnn`` on a (2, 2) mesh and the
    port's single-device layer; the carry shard by shard."""
    key = f"layer/{mode}/{quant}"
    ranks, ref, c = runs["ranks"][shape], runs["ref"][key], runs["cases"][key]
    h = _assemble(ranks, key, "h", 1)
    np.testing.assert_allclose(h, ref["h"], rtol=0, atol=LAYER_TOL)
    k = shape[1]
    Hl = ref["c"].shape[-1] // k
    for r in ranks:
        i, j = r["coords"]["data"], r["coords"]["model"]
        rows = slice(i * B // shape[0], (i + 1) * B // shape[0])
        np.testing.assert_allclose(r[key]["c"], ref["c"][rows, j * Hl:(j + 1) * Hl], rtol=0,
                                   atol=LAYER_TOL)
    p = _np_torch(c["params"])
    x, c0 = torch.tensor(c["x"]), torch.tensor(c["c0"])
    if mode == "qrnn":
        h1, c1 = ops.fused_qrnn(p, x, torch.tensor(c["tail"]), c0)
    else:
        h1, c1 = ops.fused_sru(p, x, c0)
    np.testing.assert_allclose(h, h1.numpy(), rtol=0, atol=LAYER_TOL)
    np.testing.assert_allclose(_assemble(ranks, key, "c", 0, 1), c1.numpy(), rtol=0,
                               atol=LAYER_TOL)


@pytest.mark.parametrize("shape", MESHES, ids=_mesh_id)
@pytest.mark.parametrize("sched", ("barrier", "ring"))
@pytest.mark.parametrize("quant", STACK_VARIANTS)
@pytest.mark.parametrize("cell", ("sru", "qrnn"))
def test_sharded_stack_matches_jax(runs, cell, quant, sched, shape):
    """The sharded depth-fused stack, both schedules, against JAX's on the
    same mesh and schedule, barrier against ring, and against the port's
    single-device stack. Under bf16 (``-bf16``: params cast as the LM casts
    them, bf16 inputs) both packages keep the stream in fp32 and round the
    outputs to bf16 once."""
    key = f"stack/{cell}/{quant}"
    ranks, c = runs["ranks"][shape], runs["cases"][key]
    ref = runs["ref"][f"{key}/{_mesh_id(shape)}/{sched}"]
    mine = f"{key}/{sched}"
    bf16 = quant.endswith("-bf16")
    y = _assemble(ranks, mine, "y", 1)
    cl = _assemble(ranks, mine, "c", 1, 2)
    _close(y, ref["y"], bf16)
    _close(cl, ref["c"], bf16)
    if cell == "qrnn":
        _close(_assemble(ranks, mine, "tails", 1), ref["tails"], bf16)
    other = f"{key}/{'ring' if sched == 'barrier' else 'barrier'}"
    _close(y, _assemble(ranks, other, "y", 1), bf16)
    dt = torch.bfloat16 if bf16 else torch.float32
    p = layout.cast_params(_np_torch(c["params"]), dt)
    args = (p, torch.tensor(c["ln"]).to(dt), torch.tensor(c["x"]).to(dt))
    if cell == "qrnn":
        y1, c1, _ = stacked.fused_qrnn_stack(*args, torch.tensor(c["tails"]).to(dt),
                                             torch.tensor(c["c0"]).to(dt))
    else:
        y1, c1 = stacked.fused_sru_stack(*args, torch.tensor(c["c0"]).to(dt))
    _close(y, y1.float().numpy(), bf16)
    _close(cl, c1.float().numpy(), bf16)



@pytest.mark.parametrize("shape", MESHES, ids=_mesh_id)
@pytest.mark.parametrize("cf", MOE_CFS)
def test_moe_shard_map_matches_jax_and_dense(runs, cf, shape):
    """``_moe_shard_map`` (E / m experts a rank, one all_reduce) against
    JAX's under ``use_rules`` on a (2, 2) mesh; at capacity 8.0 (nothing
    drops) also against the port's ``dense``; at 0.5 tokens drop."""
    key = f"moe/{cf}/-"
    ranks, c = runs["ranks"][shape], runs["cases"][key]
    assert all(r[key]["E_loc"] == 8 // shape[1] for r in ranks)
    y = _assemble(ranks, key, "y", 0)
    np.testing.assert_allclose(y, runs["ref"][key]["y"], rtol=0, atol=LAYER_TOL)
    cfg = _moe_cfg(cf)
    sorted_y = moe.moe_apply(_np_torch(c["params"]), cfg.with_(moe_impl="sorted"),
                             torch.tensor(c["x"]))
    np.testing.assert_allclose(y, sorted_y.numpy(), rtol=0, atol=LAYER_TOL)
    if cf >= 8.0:
        dense = moe.moe_apply(_np_torch(c["params"]), cfg.with_(moe_impl="dense"),
                              torch.tensor(c["x"]))
        np.testing.assert_allclose(y, dense.numpy(), rtol=0, atol=LAYER_TOL)


@pytest.mark.parametrize("shape", MESHES, ids=_mesh_id)
@pytest.mark.parametrize("name,ring,var", [(n, r, "") for n, r in SERVE_CASES]
                         + [(n, r, "-bf16") for n, r in SERVE_BF16_CASES])
def test_sharded_serving_logits_match_jax(runs, name, ring, var, shape):
    """Prefill + 4 decode steps through the mesh step builders, every
    step's logits within 3e-5 of JAX's sharded ``build_prefill_step`` /
    ``build_decode_step`` (under bf16 compute within one bf16 ulp of the
    largest, ``_close``), the final carries too (each within one ulp); each
    model rank holds 1/k of the gate slab bytes."""
    key = f"serve/{name}/{ring}{var}"
    ranks, ref = runs["ranks"][shape], runs["ref"][key]
    _close(_assemble(ranks, key, "logits", 1), ref["logits"], bool(var), each=False)
    _close(_assemble(ranks, key, "c", 1, 2), ref["c"], bool(var))
    whole = serve.slab_bytes(_np_torch(runs["cases"][key]["params"]))
    assert all(r[key]["slab_bytes"] * shape[1] == whole for r in ranks)


@pytest.mark.parametrize("name,ring", SERVE_CASES)
def test_serve_model_shards_gives_single_device_tokens(runs, name, ring, capsys):
    """``serve --model-shards 2 [--ring-overlap] --device cpu`` (two gloo
    ranks it starts itself) gives the single-device serve's greedy tokens
    under fp32, and prints the mesh, the backend, the dims above 1024 its
    layout replicates (none at this size) and the per-rank slab bytes (1/2
    of the whole each)."""
    out = runs["served"][(name, ring)]
    stats = json.loads(out.split("serve-stats ", 1)[1])
    argv = _serve_argv(name, False)
    assert serve.main(argv) == 0
    single = json.loads(capsys.readouterr().out.split("serve-stats ", 1)[1])
    assert stats["tokens"] == single["tokens"]
    assert stats["graphs"] is False and stats["mesh"] == {"data": 1, "model": 2}
    assert stats["slab_bytes"] == [stats["slab_bytes_whole"] // 2] * 2
    assert "mesh: {'data': 1, 'model': 2}" in out and "dist: backend gloo" in out
    assert "replicated on every model rank: nothing" in out


@pytest.mark.parametrize("shape", MESHES, ids=_mesh_id)
def test_serve_joins_an_initialised_group(runs, shape, capsys):
    """``serve.main`` called on every rank of an initialised gloo group (as
    under ``torchrun``) joins it: the mesh is (world / k, k), rank 0 alone
    prints, and the tokens gathered over the data axis are the
    single-device serve's."""
    outs = [r["joined"] for r in sorted(runs["ranks"][shape], key=lambda r: (
        r["coords"]["data"], r["coords"]["model"]))]
    assert all(o == "" for o in outs[1:]) and "serve-stats " in outs[0]
    stats = json.loads(outs[0].split("serve-stats ", 1)[1])
    assert stats["mesh"] == {"data": shape[0], "model": shape[1]}
    assert serve.main(_serve_argv(*JOIN_CASE)) == 0
    single = json.loads(capsys.readouterr().out.split("serve-stats ", 1)[1])
    assert stats["tokens"] == single["tokens"]


def test_ranks_sharing_a_card_need_gloo_asked_for(monkeypatch):
    """NCCL takes one rank a card: more shards than cards is refused, naming
    ``--dist-backend gloo``, and nothing moves to another backend."""
    args = serve.parse_args(["--arch", "sru-paper-large-stacked", "--model-shards", "2"])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="--dist-backend gloo"):
        serve._spawned_world(args, serve._backend(args, torch.device("cuda")))
    gloo = serve.parse_args(["--arch", "sru-paper-large-stacked", "--model-shards", "2",
                             "--dist-backend", "gloo"])
    assert serve._spawned_world(gloo, serve._backend(gloo, torch.device("cuda"))) == 2
    cpu = serve.parse_args(["--arch", "sru-paper-large-stacked", "--model-shards", "2",
                            "--device", "cpu", "--dist-backend", "nccl"])
    with pytest.raises(SystemExit, match="nccl runs on the card"):
        serve._backend(cpu, torch.device("cpu"))
