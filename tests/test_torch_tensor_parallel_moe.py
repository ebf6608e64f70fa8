"""The MoE experts under a model axis in every schedule (``models/moe.py``,
on the at-rest layout of ``fused_sharded.rank_specs`` and
``fused_sharded.moe_layout``) and FSDP gathered a layer at a time
(``launch/mesh.py::FsdpPlan``, ``lm.lm_hidden``'s ``fsdp``), against JAX's
sharded functions, where GSPMD partitions the same leaves.

The inputs (whole LM params from the port's ``lm_init``, prompts and train
batches) are made once here from a seed and written to a pickle. Two sides
then run at once on them:

* JAX, in one subprocess with 8 virtual CPU devices, on meshes built with
  ``axis_types=(AxisType.Auto,) * 2``: the params placed by
  ``param_specs``, its jitted ``build_prefill_step`` and
  ``build_decode_step`` (a prefill and GEN greedy decode steps) and
  ``jax.grad`` of ``lm_loss`` under ``use_rules`` on (1, 2), and its
  jitted FSDP train step on (2, 2);
* the port, in one ``torch.multiprocessing`` spawn of gloo ranks per mesh
  shape, (1, 2) and (2, 2), each rank on its shards (``serve.shard_params``,
  ``steps.train_param_specs``).

The MoE cases on (1, 2), each under the ``sorted`` schedule (JAX's too):
reduced ``mixtral-8x22b`` (E = 4: the experts over "model"), its
``n_experts=3`` variant (3 does not divide 2: each rank holds ``f / 2`` of
every expert's ff columns, JAX's ``ff_moe`` fallback) and reduced
``qwen3-moe-235b-a22b`` (E = 4 over "model" outside ``shard_map``). The
``einsum`` and ``dense`` schedules run on both layouts against the
single-device port. The FSDP cases on (2, 2): the ``n_experts=3`` variant
(``e_up`` sharded on two dims: ``d`` over "data", ``f`` over "model") and
reduced ``llama3-8b``, 2 layers, 2 microbatches (and once with microbatches
of 3 rows, which do not divide over the data axis: every data rank computes
the whole microbatch). Each rank records the all_gathers over "data" of its
train step. Tolerances are the reference's: logits 3e-5 with greedy tokens
equal under fp32, grads 5e-4, a loss 3e-5, params and moments after a step
5e-4 (absolute).
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
from repro_torch.configs.registry import get_config
from repro_torch.distribution import fused_sharded as fs
from repro_torch.distribution import sharding as shd
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import serve
from repro_torch.models import lm, moe
from repro_torch.training import steps
from repro_torch.training.steps import build_decode_step, build_prefill_step
from repro_torch.tree import flatten_with_paths, tree_leaves, unflatten_like

REPO = Path(__file__).resolve().parents[1]
B, S0, GEN = 4, 12, 4
MAX_LEN = S0 + GEN
# name -> (arch, config overrides, the experts' layout on (1, 2)).
MOE_CASES = {"mixtral": ("mixtral-8x22b", {"moe_impl": "sorted"}, "experts"),
             "mixtral_e3": ("mixtral-8x22b", {"moe_impl": "sorted", "n_experts": 3}, "ff"),
             "qwen3": ("qwen3-moe-235b-a22b", {"moe_impl": "sorted"}, "experts")}
# Held to the single-device port on (1, 2): each layout under each schedule.
SCHEDULES = ("einsum", "dense")
SCHEDULE_CASES = tuple((name, impl) for name in ("mixtral", "mixtral_e3") for impl in SCHEDULES)
# name -> (arch, config overrides, batch rows); microbatches 2, on (2, 2).
FSDP_CASES = {"mixtral_e3": ("mixtral-8x22b", {"moe_impl": "sorted", "n_experts": 3}, 8),
              "llama3": ("llama3-8b", {}, 8),
              "llama3_whole_rows": ("llama3-8b", {}, 6)}
SEQ = 16
LOGIT_TOL, GRAD_TOL, LOSS_TOL, PARAM_TOL = 3e-5, 5e-4, 3e-5, 5e-4
JOINED_ARGV = ["--arch", "mixtral-8x22b", "--reduced", "--device", "cpu", "--batch", "4",
               "--prompt-len", "12", "--gen-len", "6", "--model-shards", "2"]


def _cfg(arch, over=None, **more):
    return get_config(arch).reduced().with_(**(over or {}), **more)


def _batch(rng, cfg, rows) -> dict:
    mask = np.ones((rows, SEQ), np.float32)
    mask[1, 9:] = 0  # ragged rows
    mask[rows - 1, 5:] = 0
    return {"inputs": rng.integers(0, cfg.vocab, (rows, SEQ)).astype(np.int32),
            "targets": rng.integers(0, cfg.vocab, (rows, SEQ)).astype(np.int32),
            "mask": mask}


def _params(cfg, seed):
    return bridge.params_to_numpy(lm.lm_init(torch.Generator().manual_seed(seed), cfg,
                                             device="cpu"))


def _make_inputs() -> dict:
    rng = np.random.default_rng(0)
    cases = {}
    for name, (arch, over, _) in MOE_CASES.items():
        cfg = _cfg(arch, over)
        cases[f"moe/{name}"] = {"mesh": (1, 2), "arch": arch, "over": over,
                                "params": _params(cfg, 0),
                                "tokens": rng.integers(0, cfg.vocab, (B, S0)).astype(np.int32),
                                "batch": _batch(rng, cfg, B)}
    for name, (arch, over, rows) in FSDP_CASES.items():
        cfg = _cfg(arch, over, microbatches=2)
        cases[f"fsdp/{name}"] = {"mesh": (2, 2), "arch": arch, "over": over,
                                 "params": _params(cfg, 1), "batch": _batch(rng, cfg, rows)}
    return cases


JAX_SCRIPT = r"""
import pickle, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs.registry import get_config
from repro.distribution import sharding as shd
from repro.distribution.sharding import use_rules
from repro.models.lm import lm_loss
from repro.optim.adamw import adamw_init
from repro.training.steps import (TrainState, build_decode_step, build_prefill_step,
                                  build_train_step)

cases = pickle.load(open(sys.argv[1], "rb"))
def mesh(shape):
    n = shape[0] * shape[1]
    return jax.make_mesh(tuple(shape), ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:n])
tree = lambda p: jax.tree_util.tree_map(jnp.asarray, p)
out = {}
for key, c in cases.items():
    kind = key.split("/")[0]
    m = mesh(c["mesh"])
    params = tree(c["params"])
    if kind == "moe":
        cfg = get_config(c["arch"]).reduced().with_(**c["over"])
        psh = jax.device_put(params, shd.named_shardings(shd.param_specs(params, m), m))
        toks = c["tokens"]
        prefill = jax.jit(build_prefill_step(cfg, m, batch=toks.shape[0],
                                             max_len=toks.shape[1] + %(GEN)d))
        decode = jax.jit(build_decode_step(cfg, m))
        lg, caches = prefill(psh, {"inputs": toks})
        logits, greedy = [np.asarray(lg)], []
        for _ in range(%(GEN)d):
            tok = jnp.argmax(lg[:, -1, :cfg.vocab], axis=-1)[:, None].astype(jnp.int32)
            greedy.append(np.asarray(tok))
            lg, caches = decode(psh, caches, tok)
            logits.append(np.asarray(lg))
        with use_rules(m):
            loss, g = jax.jit(jax.value_and_grad(lambda p, b: lm_loss(p, cfg, b)[0]))(
                psh, tree(c["batch"]))
        out[key] = {"logits": np.stack(logits), "tokens": np.concatenate(greedy, axis=1),
                    "loss": float(loss),
                    "grads": {shd._path_str(p): np.asarray(v) for p, v in
                              jax.tree_util.tree_flatten_with_path(g)[0]}}
    else:
        cfg = get_config(c["arch"]).reduced().with_(microbatches=2, **c["over"])
        psh = shd.named_shardings(shd.param_specs(params, m, fsdp=True), m)
        opt = adamw_init(params, cfg.moment_dtype)
        state = TrainState(params=jax.device_put(params, psh),
                           opt=type(opt)(step=opt.step, m=jax.device_put(opt.m, psh),
                                         v=jax.device_put(opt.v, psh)), ef=None)
        batch = jax.device_put(tree(c["batch"]),
                               shd.named_shardings(shd.batch_specs(c["batch"], m), m))
        new, metrics = jax.jit(build_train_step(cfg, m, total_steps=5))(state, batch)
        out[key] = {"metrics": {k: float(v) for k, v in metrics.items()},
                    "leaves": [np.asarray(x) for x in jax.tree_util.tree_leaves(new)]}
pickle.dump(out, open(sys.argv[2], "wb"))
print("JAX-OK")
""" % {"GEN": GEN}


# ---------------------------------------------------------------------------
# The port's ranks
# ---------------------------------------------------------------------------

def _whole(params_np):
    return bridge.params_from_numpy(params_np, device="cpu")


def _greedy_run(cfg, params, toks, mesh):
    """Prefill over ``toks`` then GEN greedy decode steps through the mesh
    step builders: every step's logits and the greedy tokens (this rank's
    rows)."""
    prefill = build_prefill_step(cfg, mesh, batch=toks.shape[0], max_len=MAX_LEN, device="cpu")
    decode = build_decode_step(cfg, mesh, max_len=MAX_LEN)
    lg, caches = prefill(params, {"inputs": toks})
    logits, greedy = [lg.numpy()], []
    for _ in range(GEN):
        tok = torch.argmax(lg[:, -1, :cfg.vocab], dim=-1)[:, None]
        greedy.append(tok.numpy())
        lg, caches = decode(params, caches, tok)
        logits.append(lg.numpy())
    return {"logits": np.stack(logits), "tokens": np.concatenate(greedy, axis=1)}


def _grads(cfg, c, mesh):
    """The train step's loss and grads (``steps.step_grads``) on this rank's
    shards, each grad made whole over the mesh."""
    specs = steps.train_param_specs(cfg, mesh)
    params = shd.map_with_paths(lambda p, x: shd.local_shard(x, shd._at(specs, p), mesh),
                                _whole(c["params"]))
    batch = {k: torch.tensor(v) for k, v in c["batch"].items()}
    loss, grads = steps.step_grads(cfg, params, batch, mesh, specs)
    return {"loss": float(loss),
            "grads": {path: shd.gather_shard(g, s, mesh).numpy() for (path, g), s in
                      zip(flatten_with_paths(grads), tree_leaves(specs))}}


def _moe_case(cfg, c, mesh):
    """One MoE LM on this rank's shards: its layout, the expert leaf bytes
    it holds, the greedy run and the grads."""
    params, _ = serve.shard_params(cfg, _whole(c["params"]), mesh)
    toks = torch.tensor(c["tokens"], dtype=torch.int64)
    out = _greedy_run(cfg, params, toks, mesh)
    out.update(layout=fs.moe_layout(cfg, mesh), expert_bytes=serve.expert_bytes(params),
               e_up=tuple(params["layers"]["moe"]["e_up"].shape), **_grads(cfg, c, mesh))
    return out


def _shard_map_region(mesh, c):
    """``qwen3``'s own schedule (``shard_map``) on this rank's experts: the
    shapes of the expert leaves ``_expert_ffn`` saw inside the region and
    whether it saw a model group there (it must not: the region slices
    once, by routing, and runs under ``suppress_hints``), and the output."""
    cfg = _cfg("qwen3-moe-235b-a22b", {"moe_impl": "shard_map"})
    params, _ = serve.shard_params(cfg, _whole(c["params"]), mesh)
    layer = {k: v[0] for k, v in params["layers"]["moe"].items()}
    x = torch.tensor(np.random.default_rng(3).standard_normal((B, S0, cfg.d_model)),
                     dtype=torch.float32)
    seen, inner = [], moe._expert_ffn

    def spy(p, cfg_, xs):
        seen.append((shd.model_group() is not None, tuple(p["e_up"].shape), xs.shape[-3]))
        return inner(p, cfg_, xs)

    moe._expert_ffn = spy
    try:
        with shd.use_rules(mesh):
            y = moe.moe_apply(layer, cfg, x)
    finally:
        moe._expert_ffn = inner
    return {"seen": seen, "y": y.numpy(), "x": x.numpy()}


def _fsdp_case(cfg, c, mesh):
    """One FSDP train step (``build_train_step``, ``fsdp=True`` specs) on
    this rank's shards, with the shapes of every all_gather over "data" it
    ran; the eval step's loss on the state before it; the state after it,
    whole."""
    params = _whole(c["params"])
    whole = steps.TrainState(params=params, opt=steps.adamw_init(params, cfg.moment_dtype),
                             ef=None)
    specs = steps.train_param_specs(cfg, mesh, fsdp=True)
    sspecs = steps.train_state_specs(specs)
    state = steps.shard_train_state(whole, sspecs, mesh)
    batch = {k: torch.tensor(v) for k, v in c["batch"].items()}
    eval_loss = float(steps.build_eval_step(cfg, mesh, specs=specs)(state.params, batch)["loss"])
    data, gathered = mesh.axis("data"), []
    inner = data.all_gather

    def spy(x, dim=-1):
        gathered.append(tuple(x.shape))
        return inner(x, dim)

    data.all_gather = spy
    try:
        state, metrics = steps.build_train_step(cfg, mesh, total_steps=5, specs=specs)(state,
                                                                                       batch)
    finally:
        del data.all_gather
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "gathered": gathered,
            "eval_loss": eval_loss,
            "held": {path: tuple(x.shape) for path, x in flatten_with_paths(state.params)},
            "leaves": [(path, shd.gather_shard(x, s, mesh).numpy()) for (path, x), s in
                       zip(flatten_with_paths(state), tree_leaves(sspecs))]}


def _worker(rank, world, model_axis, init_file, cases_path, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world, timeout=mesh_lib.GROUP_TIMEOUT)
    try:
        mesh = mesh_lib.make_local_mesh(model_axis, device=torch.device("cpu"))
        shape = (world // model_axis, model_axis)
        with open(cases_path, "rb") as f:
            cases = pickle.load(f)
        res = {"coords": mesh.coords}
        for key, c in cases.items():
            if tuple(c["mesh"]) != shape:
                continue
            kind, name = key.split("/")
            if kind == "moe":
                cfg = _cfg(c["arch"], c["over"])
                res[key] = _moe_case(cfg, c, mesh)
                if name in ("mixtral", "mixtral_e3"):
                    for impl in SCHEDULES:
                        sub = cfg.with_(moe_impl=impl)
                        res[f"{key}/{impl}"] = {
                            **_greedy_run(sub, serve.shard_params(sub, _whole(c["params"]),
                                                                  mesh)[0],
                                          torch.tensor(c["tokens"], dtype=torch.int64), mesh),
                            **_grads(sub, c, mesh)}
                if name == "qwen3":
                    res["shard_map"] = _shard_map_region(mesh, c)
            else:
                res[key] = _fsdp_case(_cfg(c["arch"], c["over"], microbatches=2), c, mesh)
        if shape == (1, 2):
            with contextlib.redirect_stdout(io.StringIO()) as out:
                assert serve.main(JOINED_ARGV) == 0
            res["joined"] = out.getvalue()
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the JAX reference and one spawn of gloo ranks per mesh, all at
    once; wait for all; return their results."""
    tmp = tmp_path_factory.mktemp("tpmoe")
    cases = _make_inputs()
    cases_path = tmp / "cases.pkl"
    with open(cases_path, "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO / "src"))
    (tmp / "ref.py").write_text(textwrap.dedent(JAX_SCRIPT))
    jax_proc = subprocess.Popen(
        [sys.executable, str(tmp / "ref.py"), str(cases_path), str(tmp / "jax.pkl")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    spawns = {}
    for shape in ((1, 2), (2, 2)):
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
    stdout_jax, stderr_jax = jax_proc.communicate(timeout=420)
    assert jax_proc.returncode == 0 and "JAX-OK" in stdout_jax, stderr_jax[-3000:]
    with open(tmp / "jax.pkl", "rb") as f:
        ref = pickle.load(f)
    return {"cases": cases, "ref": ref, "ranks": ranks}


def _single_run(cfg, c) -> dict:
    """The single-device port: the greedy run, the loss and autograd's
    grads."""
    whole = _whole(c["params"])
    out = _greedy_run(cfg, whole, torch.tensor(c["tokens"], dtype=torch.int64), None)
    leaves = [x.detach().requires_grad_() for x in tree_leaves(whole)]
    batch = {k: torch.tensor(v) for k, v in c["batch"].items()}
    loss, _ = lm.lm_loss(unflatten_like(whole, leaves), cfg, batch)
    grads = torch.autograd.grad(loss, leaves)
    out.update(loss=loss.item(), grads={path: g.numpy() for (path, _), g in
                                        zip(flatten_with_paths(whole), grads)})
    return out


def _check_run(got, want):
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=0, atol=LOGIT_TOL)
    assert abs(got["loss"] - want["loss"]) <= LOSS_TOL
    assert sorted(got["grads"]) == sorted(want["grads"])
    for path, g in want["grads"].items():
        np.testing.assert_allclose(got["grads"][path], g, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=path)


# ---------------------------------------------------------------------------
# The experts under a model axis
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(MOE_CASES))
def test_moe_lm_on_a_model_axis_matches_jax(runs, name):
    """Each MoE LM on (1, 2) under ``sorted``, on the rank's shards, against
    JAX's GSPMD steps on the same mesh: greedy tokens equal and every step's
    logits within 3e-5, the loss within 3e-5 and every grad within 5e-4 of
    ``jax.grad`` under ``use_rules``; both ranks alike; the layout the
    case names (E / 2 experts a rank, or f / 2 of every expert's columns),
    and half the expert bytes a rank."""
    key = f"moe/{name}"
    arch, over, layout = MOE_CASES[name]
    cfg = _cfg(arch, over)
    ref = runs["ref"][key]
    whole = serve.expert_bytes(_whole(runs["cases"][key]["params"]))
    for r in runs["ranks"][(1, 2)]:
        got = r[key]
        _check_run(got, ref)
        assert got["layout"] == layout
        E, f = cfg.n_experts, cfg.d_ff
        assert got["e_up"][1:] == ((E // 2, cfg.d_model, f) if layout == "experts"
                                   else (E, cfg.d_model, f // 2))
        assert got["expert_bytes"] * 2 == whole


@pytest.mark.parametrize("name,impl", SCHEDULE_CASES, ids=lambda v: str(v))
def test_moe_schedules_on_a_model_axis_match_the_single_device_run(runs, name, impl):
    """The ``einsum`` and ``dense`` schedules on both layouts on (1, 2), on
    the rank's shards: greedy tokens, logits, loss and grads of the
    single-device run (which ``tests/test_torch_moe.py`` and
    ``test_torch_archs.py`` hold to JAX) within the same limits. Every
    schedule goes through the one ``_expert_ffn``, with no branch of its
    own for the mesh."""
    key = f"moe/{name}"
    c = runs["cases"][key]
    cfg = _cfg(c["arch"], c["over"]).with_(moe_impl=impl)
    want = _single_run(cfg, c)
    for r in runs["ranks"][(1, 2)]:
        _check_run(r[f"{key}/{impl}"], want)


def test_shard_map_region_does_not_slice_twice(runs):
    """``_moe_shard_map``'s region (qwen3's own schedule, E = 4 over 2) runs
    under ``suppress_hints``: ``_expert_ffn`` sees no model group there and
    the rank's E / 2 experts, on a buffer of E / 2 experts, so it takes no
    slice of its own; the output is the single-device ``sorted`` one's
    within 2e-5, on both ranks."""
    cfg = _cfg("qwen3-moe-235b-a22b")
    whole = _whole(runs["cases"]["moe/qwen3"]["params"])
    for r in runs["ranks"][(1, 2)]:
        got = r["shard_map"]
        E_l = cfg.n_experts // 2
        assert got["seen"] and all(s == (False, (E_l, cfg.d_model, cfg.d_ff), E_l)
                                   for s in got["seen"]), got["seen"]
        layer = {k: v[0] for k, v in whole["layers"]["moe"].items()}
        want = moe.moe_apply(layer, cfg.with_(moe_impl="sorted"), torch.tensor(got["x"]))
        np.testing.assert_allclose(got["y"], want.numpy(), rtol=0, atol=2e-5)


def test_expert_leaves_not_sharded_as_the_layout_raise():
    """A whole expert leaf read under a model axis (or a rank's under no
    layout) is never silently taken as whole: ``_expert_ffn`` raises,
    naming ``rank_specs``."""
    cfg = _cfg("mixtral-8x22b", {"moe_impl": "sorted"})
    params = lm.lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    layer = {k: v[0] for k, v in params["layers"]["moe"].items()}
    x = torch.zeros((2, 8, cfg.d_model))
    group = mesh_lib.AxisGroup((0, 1), 0, None)
    mesh = mesh_lib.Mesh({"data": 1, "model": 2}, {"data": 0, "model": 0}, {"model": group})
    with shd.use_rules(mesh), pytest.raises(ValueError, match="rank_specs"):
        moe.moe_apply(layer, cfg, x)
    half = {k: (v[:2] if k.startswith("e_") else v) for k, v in layer.items()}
    with pytest.raises(ValueError, match="whole layout"):
        moe.moe_apply(half, cfg, x)


def test_serve_model_shards_joined_holds_half_the_experts(runs, capsys):
    """``serve.main`` on the (1, 2) ranks' initialised group serves reduced
    ``mixtral-8x22b`` (its ``dense`` schedule, 2 of 4 experts a rank) with
    the single-device serve's greedy tokens; rank 0 alone prints, with half
    the expert leaf bytes a rank, and no expert dim replicated."""
    outs = [r["joined"] for r in runs["ranks"][(1, 2)]]
    assert outs[1] == "" and "serve-stats " in outs[0]
    stats = json.loads(outs[0].split("serve-stats ", 1)[1])
    assert serve.main(JOINED_ARGV[:-2]) == 0
    single = json.loads(capsys.readouterr().out.split("serve-stats ", 1)[1])
    assert stats["tokens"] == single["tokens"]
    assert stats["expert_bytes"] == [stats["expert_bytes_whole"] // 2] * 2
    assert "expert leaf bytes per model rank" in outs[0]
    assert stats["replicated"] == []


# ---------------------------------------------------------------------------
# FSDP gathered a layer at a time
# ---------------------------------------------------------------------------

def _allowed_gathers(cfg, c, mesh_shape, rank_coords):
    """The shapes an all_gather over "data" may take in the step: one layer's
    slice of a stacked FSDP leaf (this rank's shard without the layer dim)
    or a whole non-layer leaf's shard; and the stacked leaves' own shard
    shapes, which it must never take."""
    mesh = mesh_lib.Mesh(mesh_shape, rank_coords)
    specs = steps.train_param_specs(cfg, mesh, fsdp=True)
    allowed, stacked = set(), set()
    for (path, x), spec in zip(flatten_with_paths(_whole(c["params"])), tree_leaves(specs)):
        if "data" not in shd.spec_axes(spec):
            continue
        local = shd.local_shape(x.shape, spec, mesh)
        if path.startswith("layers/"):
            allowed.add(local[1:])
            stacked.add(local)
        else:
            allowed.add(local)
    return allowed, stacked


@pytest.mark.parametrize("name", sorted(FSDP_CASES))
def test_fsdp_step_gathers_a_layer_at_a_time_and_matches_jax(runs, name):
    """One FSDP train step on (2, 2), microbatches 2, against JAX's jitted
    FSDP step on the same mesh: loss and ``grad_norm`` within 3e-5, every
    param and moment within 5e-4; the params held as data shards (and the
    ``n_experts=3`` variant's experts on two dims: ``d`` over "data", ``f``
    over "model"). Every all_gather over "data" the step ran was one layer's
    slice of a stacked leaf or a non-layer leaf's shard, never a whole
    stacked ``(L, ...)`` leaf, and the step gathered each layer (twice per
    microbatch under ``remat="block"``: forward and the backward's
    recompute). The eval step's loss on the state before the step is the
    single device's within 3e-5."""
    key = f"fsdp/{name}"
    arch, over, rows = FSDP_CASES[name]
    c = runs["cases"][key]
    cfg = _cfg(arch, over, microbatches=2)
    ref = runs["ref"][key]
    for r in runs["ranks"][(2, 2)]:
        got = r[key]
        assert abs(got["metrics"]["loss"] - ref["metrics"]["loss"]) <= LOSS_TOL
        assert abs(got["metrics"]["grad_norm"] - ref["metrics"]["grad_norm"]) <= LOSS_TOL
        assert got["metrics"]["lr"] == pytest.approx(ref["metrics"]["lr"], rel=1e-6)
        assert len(got["leaves"]) == len(ref["leaves"])
        for (path, a), b in zip(got["leaves"], ref["leaves"]):
            np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_TOL, err_msg=path)
        allowed, stacked = _allowed_gathers(cfg, c, {"data": 2, "model": 2}, r["coords"])
        gathered = set(got["gathered"])
        assert gathered <= allowed and not gathered & stacked, (gathered, allowed)
        per_layer = [s for s in got["gathered"] if s in allowed - stacked]
        assert per_layer
        held = got["held"]
        if cfg.moe:
            E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
            assert held["layers/moe/e_up"] == (cfg.n_layers, E, d // 2, f // 2)
            assert held["layers/moe/e_down"] == (cfg.n_layers, E, f // 2, d // 2)
        else:
            assert held["layers/mlp/w_down"] == (cfg.n_layers, cfg.d_ff // 2, cfg.d_model // 2)
    batch = {k: torch.tensor(v) for k, v in c["batch"].items()}
    want = lm.lm_loss(_whole(c["params"]), cfg, batch)[0].item()
    assert all(abs(r[key]["eval_loss"] - want) <= LOSS_TOL for r in runs["ranks"][(2, 2)])
