"""The port's training on a mesh of ranks (``launch/mesh.py``'s ``enter`` /
``gather`` / ``combine`` and ``reduce_scatter``, the backward of
``distribution/fused_sharded.py`` and of ``models/moe.py::_moe_shard_map``,
``build_train_step(cfg, mesh)`` with data parallelism and FSDP, the clip
norm and int8 compression over whole leaves, ``CheckpointManager`` under a
mesh and ``launch/train.py`` on ranks) against JAX's sharded functions and
the port's own single-device ones.

The inputs are made once here from a seed (numpy, and the port's
``lm_init`` for the LM params) and written to a pickle. Two sides then run
at once on them:

* JAX, in one subprocess with 8 virtual CPU devices, on meshes built with
  ``axis_types=(AxisType.Auto,) * 2`` (jax 0.9's ``make_mesh`` gives
  Explicit axes, which the reference's sharded steps refuse). The layer and
  stack grads run on its (2, 2) mesh: JAX's sharded cores are
  ``custom_vjp``s whose backward is the global reference's VJP, so their
  grads are the same function on every mesh shape. JAX's own stack case
  (``test_sharded_fused_rnn_grads_match_reference``) runs on (2, 4), and
  each train step on the port's mesh shape.
* the port, in one ``torch.multiprocessing`` spawn of gloo ranks per mesh
  shape (1, 2), (2, 1) and (2, 2), each running every case that belongs to
  it. Each rank assembles whole arrays with the mesh's collectives (param
  grads summed over ``data``, then gathered over ``model``; activation
  grads gathered by rows and lanes), and rank 0 writes them.

Tolerances (ROADMAP's ground rules, absolute and relative as the repo's
grad checks take them): grads 5e-4, MoE 2e-5, a loss 3e-5, params and
moments after a step 5e-4 (absolute). The max differences seen on the CPU:
layer grads 2.9e-6 from JAX's and from the single device's, stack grads
5.4e-6 and 3.8e-6, JAX's own stack case 3.8e-6, MoE 1.9e-6; the int8
scales' grads (of order 1e3) 1.5e-3 and 4.9e-4, 1.2e-6 relative; the train
steps' losses 4.8e-7, grad norms 3.6e-7, params and moments 3.2e-7.
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
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import bridge
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import get_config
from repro_torch.distribution import fused_sharded as fs
from repro_torch.distribution import sharding as shd
from repro_torch.kernels.fused_rnn import layout, ops, stacked
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train
from repro_torch.models import lm, moe, rnn
from repro_torch.runtime import PreemptionHandler
from repro_torch.training import steps
from repro_torch.tree import flatten_with_paths, tree_leaves

REPO = Path(__file__).resolve().parents[1]
MESHES = ((1, 2), (2, 1), (2, 2))
LAYER_MODES = (("sru_identity", 64, 64), ("sru_proj", 48, 64), ("qrnn", 64, 64))
T, B, L, D = 8, 4, 2, 64
MOE_CFS = (8.0, 0.5)
GRAD_TOL, MOE_TOL, LOSS_TOL, PARAM_TOL = 5e-4, 2e-5, 3e-5, 5e-4
# name: (arch, mesh, fsdp, compression); 8 x 64 tokens, microbatches 2.
TRAIN_CASES = {
    "sru_stacked_1x2": ("sru-paper-large-stacked", (1, 2), False, None),
    "sru_stacked_2x2_fsdp": ("sru-paper-large-stacked", (2, 2), True, None),
    "qrnn_fused_2x2_fsdp": ("qrnn-paper-large-fused", (2, 2), True, None),
    "llama3_2x2_fsdp": ("llama3-8b", (2, 2), True, None),
    "sru_stacked_2x2_fsdp_int8": ("sru-paper-large-stacked", (2, 2), True, "int8"),
}
ELASTIC_ARCHS = ("mamba2-2.7b", "sru-paper-large-stacked")
ELASTIC_STEP, DATA_STATE = 7, {"step": 7, "seed": 0}
# The elastic resume: (2, 1) FSDP ranks train to RESUME_SAVE and save; one
# device restores and trains on to RESUME_STEPS (fp32 compute).
RESUME_ARCH, RESUME_SAVE, RESUME_STEPS, RESUME_LR = "sru-paper-large-stacked", 2, 4, 1e-2
OWN_ARCH = "qrnn-paper-large-stacked"
CLI_ARGS = ["--arch", "sru-paper-large-stacked", "--reduced", "--device", "cpu", "--batch", "8",
            "--seq", "16", "--log-every", "1"]


def _mesh_id(shape):
    return f"{shape[0]}x{shape[1]}"


def _moe_cfg(cf: float) -> ArchConfig:
    return ArchConfig(name="t", family="moe", n_layers=1, d_model=32, vocab=64, d_ff=48,
                      mlp_type="swiglu", moe=True, n_experts=8, top_k=2, moe_impl="shard_map",
                      capacity_factor=cf, renorm_topk=True)


def _train_cfg(arch):
    return get_config(arch).reduced().with_(microbatches=2)


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
        io_ = {"x": normal(T, B, d), "c0": normal(B, H), "tail": normal(1, B, d),
               "gh": normal(T, B, H), "gc": normal(B, H)}
        cases[f"layer/{mode}/fp"] = {"params": p, **io_}
        cases[f"layer/{mode}/int8"] = {"params": quant(p), **io_}
    for cell in ("sru", "qrnn"):
        if cell == "qrnn":
            p = {"w0": normal(L, D, 3, D, scale=D ** -.5), "w1": normal(L, D, 3, D, scale=D ** -.5),
                 "b": normal(L, 3, D, scale=.1)}
        else:
            p = {"w": normal(L, D, 3, D, scale=D ** -.5), "b": normal(L, 2, D, scale=.1),
                 "w_skip": None}
        io_ = {"ln": 1.0 + normal(L, D, scale=.1), "x": normal(T, B, D), "c0": normal(L, B, D),
               "tails": normal(L, B, D), "gy": normal(T, B, D), "gc": normal(L, B, D),
               "gt": normal(L, B, D)}
        cases[f"stack/{cell}/fp"] = {"params": p, **io_}
        cases[f"stack/{cell}/int8"] = {"params": quant(p), **io_}
    own = get_config(OWN_ARCH).reduced()
    cases["own"] = {"params": bridge.params_to_numpy(
        lm.lm_init(torch.Generator().manual_seed(2), own, device="cpu")["layers"]),
        "x": normal(2, 16, own.d_model)}
    for cf in MOE_CFS:
        gen = torch.Generator().manual_seed(7)
        cases[f"moe/{cf}"] = {"params": bridge.params_to_numpy(
            moe.moe_init(gen, _moe_cfg(cf), torch.float32, "cpu")),
            "x": normal(4, 16, 32), "gy": normal(4, 16, 32)}
    for name, (arch, _, _, _) in TRAIN_CASES.items():
        cfg = _train_cfg(arch)
        mask = np.ones((8, 64), np.float32)
        mask[1, 40:] = 0  # ragged rows
        mask[5, 10:] = 0
        cases[f"train/{name}"] = {
            "params": bridge.params_to_numpy(lm.lm_init(torch.Generator().manual_seed(0), cfg,
                                                        device="cpu")),
            "batch": {"inputs": rng.integers(0, cfg.vocab, (8, 64)).astype(np.int32),
                      "targets": rng.integers(0, cfg.vocab, (8, 64)).astype(np.int32),
                      "mask": mask}}
    return cases


JAX_SCRIPT = r"""
import pickle, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs.registry import get_config
from repro.distribution import fused_sharded as fs
from repro.distribution import sharding as shd
from repro.distribution.sharding import use_rules
from repro.models import rnn
from repro.optim.adamw import adamw_init
from repro.optim.compression import ef_init
from repro.training.steps import TrainState, build_train_step

cases, train_cases = pickle.load(open(sys.argv[1], "rb"))
def mesh(shape):
    n = shape[0] * shape[1]
    return jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:n])
M22 = mesh((2, 2))
tree = lambda p: jax.tree_util.tree_map(jnp.asarray, p)
out = {}

def float_leaves(p):
    return {k: v for k, v in p.items() if v is not None and v.dtype != np.int8}

def grads(fn, p, acts):
    # d(fn)/d(the float param leaves and the activations), int8 slabs held fixed
    fixed = {k: v for k, v in p.items() if k not in float_leaves(p)}
    def loss(fl, acts):
        return fn({**fixed, **fl}, **acts)
    gp, ga = jax.grad(loss, argnums=(0, 1))(tree(float_leaves(p)), tree(acts))
    return {k: np.asarray(v) for k, v in {**gp, **ga}.items()}

for key, c in cases.items():
    kind = key.split("/")[0]
    if kind == "layer":
        mode = key.split("/")[1]
        if mode == "qrnn":
            def f(p, x, tail, c0, c=c):
                h, cl = fs.sharded_fused_qrnn(p, x, tail, c0, mesh=M22)
                return jnp.sum(h * c["gh"]) + jnp.sum(cl * c["gc"])
            out[key] = grads(f, c["params"], {"x": c["x"], "tail": c["tail"], "c0": c["c0"]})
        else:
            def f(p, x, c0, c=c):
                h, cl = fs.sharded_fused_sru(p, x, c0, mesh=M22)
                return jnp.sum(h * c["gh"]) + jnp.sum(cl * c["gc"])
            out[key] = grads(f, c["params"], {"x": c["x"], "c0": c["c0"]})
    elif kind == "stack":
        cell = key.split("/")[1]
        for sched in ("barrier", "ring"):
            if cell == "qrnn":
                def f(p, ln, x, tails, c0, c=c, sched=sched):
                    y, cl, tl = fs.sharded_fused_qrnn_stack(p, ln, x, tails, c0, mesh=M22,
                                                            schedule=sched)
                    return (jnp.sum(y * c["gy"]) + jnp.sum(cl * c["gc"])
                            + jnp.sum(tl * c["gt"]))
                acts = {k: c[k] for k in ("ln", "x", "tails", "c0")}
            else:
                def f(p, ln, x, c0, c=c, sched=sched):
                    y, cl = fs.sharded_fused_sru_stack(p, ln, x, c0, mesh=M22, schedule=sched)
                    return jnp.sum(y * c["gy"]) + jnp.sum(cl * c["gc"])
                acts = {k: c[k] for k in ("ln", "x", "c0")}
            out[f"{key}/{sched}"] = grads(f, c["params"], acts)
    elif kind == "own":
        cfg = get_config("%(OWN)s").reduced()
        def sloss(sp, xb):
            return jnp.sum(rnn.rnn_stack_apply(sp, cfg, xb) ** 2)
        with use_rules(mesh((2, 4))):
            gs, gx = jax.jit(jax.grad(sloss, argnums=(0, 1)))(tree(c["params"]), c["x"])
        out[key] = {"params": jax.tree_util.tree_map(np.asarray, gs), "x": np.asarray(gx)}

for name, (arch, shape, fsdp, comp) in train_cases.items():
    c = cases[f"train/{name}"]
    cfg = get_config(arch).reduced().with_(microbatches=2)
    m = mesh(shape)
    params = tree(c["params"])
    psh = shd.named_shardings(shd.param_specs(params, m, fsdp=fsdp), m)
    opt = adamw_init(params, cfg.moment_dtype)
    state = TrainState(params=jax.device_put(params, psh),
                       opt=type(opt)(step=opt.step, m=jax.device_put(opt.m, psh),
                                     v=jax.device_put(opt.v, psh)),
                       ef=None if comp is None else jax.device_put(ef_init(params), psh))
    batch = jax.device_put(tree(c["batch"]), shd.named_shardings(shd.batch_specs(c["batch"], m), m))
    new, metrics = jax.jit(build_train_step(cfg, m, total_steps=5, compression=comp))(state, batch)
    out[f"train/{name}"] = {"metrics": {k: float(v) for k, v in metrics.items()},
                            "leaves": [np.asarray(x) for x in jax.tree_util.tree_leaves(new)]}
pickle.dump(out, open(sys.argv[2], "wb"))
print("JAX-OK")
""" % {"OWN": OWN_ARCH}


# ---------------------------------------------------------------------------
# The port's ranks
# ---------------------------------------------------------------------------

def _t(a):
    return None if a is None else torch.tensor(a)


def _cell_specs(params, mesh, stacked_dim: bool):
    """The at-rest specs of a bare cell dict (``rank_specs`` under a
    ``layers/cell`` or ``cell`` prefix; ``wq_scale`` whole)."""
    tree = {"layers": {"cell": params}} if stacked_dim else {"cell": params}
    cfg = get_config("sru-paper-large-fused").with_(rnn_hidden=D)
    specs = fs.rank_specs(cfg, fs.serving_param_specs(bridge.params_from_numpy(tree, device="cpu"),
                                                      mesh), mesh)
    return specs["layers"]["cell"] if stacked_dim else specs["cell"]


def _shard_tree(tree_np, specs, mesh):
    return shd.map_with_paths(lambda path, x: shd.local_shard(torch.tensor(x),
                                                             shd._at(specs, path), mesh), tree_np)


class _Rank:
    """One rank's view of the mesh for the grad cases: this rank's rows and
    lanes of activations, whole arrays back from shards."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.bspec = fs._batch_spec(mesh, B)

    def rows(self, a, batch_dim):
        spec = [None] * a.ndim
        spec[batch_dim] = self.bspec
        return shd.local_shard(torch.tensor(a), tuple(spec), self.mesh)

    def rows_lanes(self, a, batch_dim):
        spec = [None] * a.ndim
        spec[batch_dim], spec[-1] = self.bspec, "model"
        return shd.local_shard(torch.tensor(a), tuple(spec), self.mesh)

    def param_grad(self, g, spec):
        """A param's grad from this rank's rows: summed over ``data``, made
        whole over its sharded axes."""
        if self.bspec is not None:
            g = self.mesh.axis("data").all_reduce(g)
        return shd.gather_shard(g, spec, self.mesh).numpy()

    def act_grad(self, g, batch_dim, lanes=False):
        spec = [None] * g.dim()
        spec[batch_dim] = self.bspec
        if lanes:
            spec[-1] = "model"
        return shd.gather_shard(g, tuple(spec), self.mesh).numpy()


def _float_leaves(p):
    return {k: v for k, v in p.items() if v is not None and v.dtype != torch.int8}


def _grads(loss, named):
    """Grads of ``loss`` w.r.t. the tensors of ``named``, by name."""
    g = torch.autograd.grad(loss, list(named.values()))
    return dict(zip(named, g))


def _layer_case(r: _Rank, key, c):
    mode = key.split("/")[1]
    specs = _cell_specs(c["params"], r.mesh, False)
    p = _shard_tree(c["params"], specs, r.mesh)
    for v in _float_leaves(p).values():
        v.requires_grad_()
    x, tail = r.rows(c["x"], 1).requires_grad_(), r.rows(c["tail"], 1).requires_grad_()
    c0 = r.rows_lanes(c["c0"], 0).requires_grad_()
    if mode == "qrnn":
        h, cl = fs.sharded_fused_qrnn(p, x, tail, c0, mesh=r.mesh)
    else:
        h, cl = fs.sharded_fused_sru(p, x, c0, mesh=r.mesh)
    loss = torch.sum(h * r.rows(c["gh"], 1)) + torch.sum(cl * r.rows_lanes(c["gc"], 0))
    acts = {"x": x, "c0": c0, **({"tail": tail} if mode == "qrnn" else {})}
    g = _grads(loss, {**_float_leaves(p), **acts})
    out = {k: r.param_grad(g[k], specs[k]) for k in _float_leaves(p)}
    out.update(x=r.act_grad(g["x"], 1), c0=r.act_grad(g["c0"], 0, lanes=True))
    if mode == "qrnn":
        out["tail"] = r.act_grad(g["tail"], 1)
    return out


def _stack_case(r: _Rank, key, c, sched):
    cell = key.split("/")[1]
    specs = _cell_specs(c["params"], r.mesh, True)
    p = _shard_tree(c["params"], specs, r.mesh)
    for v in _float_leaves(p).values():
        v.requires_grad_()
    ln = torch.tensor(c["ln"]).requires_grad_()
    x, tails = r.rows(c["x"], 1).requires_grad_(), r.rows(c["tails"], 1).requires_grad_()
    c0 = r.rows_lanes(c["c0"], 1).requires_grad_()
    gy, gc = r.rows(c["gy"], 1), r.rows_lanes(c["gc"], 1)
    if cell == "qrnn":
        y, cl, tl = fs.sharded_fused_qrnn_stack(p, ln, x, tails, c0, mesh=r.mesh, schedule=sched)
        loss = torch.sum(y * gy) + torch.sum(cl * gc) + torch.sum(tl * r.rows(c["gt"], 1))
        acts = {"ln": ln, "x": x, "tails": tails, "c0": c0}
    else:
        y, cl = fs.sharded_fused_sru_stack(p, ln, x, c0, mesh=r.mesh, schedule=sched)
        loss = torch.sum(y * gy) + torch.sum(cl * gc)
        acts = {"ln": ln, "x": x, "c0": c0}
    g = _grads(loss, {**_float_leaves(p), **acts})
    out = {k: r.param_grad(g[k], specs[k]) for k in _float_leaves(p)}
    out["ln"] = r.param_grad(g["ln"], (None, None))
    out.update(x=r.act_grad(g["x"], 1), c0=r.act_grad(g["c0"], 1, lanes=True))
    if cell == "qrnn":
        out["tails"] = r.act_grad(g["tails"], 1)
    return out


def _own_case(mesh, c):
    """JAX's own test on the port: ``rnn_stack_apply`` under ``use_rules``,
    loss ``sum(y ** 2)`` over this rank's rows."""
    cfg = get_config(OWN_ARCH).reduced()
    r = _Rank(mesh)
    r.bspec = fs._batch_spec(mesh, c["x"].shape[0])
    specs = fs.rank_specs(cfg, shd.param_specs({"layers": bridge.params_from_numpy(
        c["params"], device="cpu")}, mesh), mesh)["layers"]
    p = _shard_tree(c["params"], specs, mesh)
    named = dict(flatten_with_paths(p))
    for v in named.values():
        v.requires_grad_()
    x = r.rows(c["x"], 0).requires_grad_()
    with shd.use_rules(mesh):
        loss = torch.sum(rnn.rnn_stack_apply(p, cfg, x) ** 2)
    g = _grads(loss, {**named, "x": x})
    return {"params": {path: r.param_grad(g[path], shd._at(specs, path)) for path in named},
            "x": r.act_grad(g["x"], 0)}


def _moe_case(mesh, c, cf):
    cfg = _moe_cfg(cf)
    r = _Rank(mesh)
    whole = bridge.params_from_numpy(c["params"], device="cpu")
    specs = fs.rank_specs(cfg, shd.param_specs(whole, mesh), mesh)
    p = _shard_tree(c["params"], specs, mesh)
    for v in p.values():
        v.requires_grad_()
    x = r.rows(c["x"], 0).requires_grad_()
    with shd.use_rules(mesh):
        y = moe.moe_apply(p, cfg, x)
    g = _grads(torch.sum(y * r.rows(c["gy"], 0)), {**p, "x": x})
    out = {k: r.param_grad(g[k], specs[k]) for k in p}
    out.update(x=r.act_grad(g["x"], 0), E_loc=p["e_up"].shape[0])
    return out


def _train_case(mesh, name, c):
    arch, _, fsdp, comp = TRAIN_CASES[name]
    cfg = _train_cfg(arch)
    params = bridge.params_from_numpy(c["params"], device="cpu")
    whole = steps.TrainState(params=params, opt=steps.adamw_init(params, cfg.moment_dtype),
                             ef=steps.ef_init(params) if comp else None)
    specs = steps.train_param_specs(cfg, mesh, fsdp=fsdp)
    sspecs = steps.train_state_specs(specs, comp)
    state = steps.shard_train_state(whole, sspecs, mesh)
    fn = steps.build_train_step(cfg, mesh, total_steps=5, compression=comp, specs=specs)
    batch = {k: torch.tensor(v) for k, v in c["batch"].items()}
    state, metrics = fn(state, batch)
    sharded = sorted({a for s in tree_leaves(sspecs) for a in shd.spec_axes(s)})
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "sharded_over": sharded,
            "leaves": [(path, shd.gather_shard(x, s, mesh).numpy()) for (path, x), s in
                       zip(flatten_with_paths(state), tree_leaves(sspecs))]}


def _elastic_state(arch, fsdp, mesh):
    cfg = get_config(arch).reduced()
    whole = steps.init_train_state(torch.Generator().manual_seed(0), cfg, device="cpu")
    sspecs = steps.train_state_specs(steps.train_param_specs(cfg, mesh, fsdp=fsdp))
    return whole, sspecs, steps.shard_train_state(whole, sspecs, mesh)


def _elastic_save(mesh, ckpt_root):
    """Save each elastic state from its (2, 1) FSDP shards."""
    for arch in ELASTIC_ARCHS:
        _, sspecs, state = _elastic_state(arch, True, mesh)
        CheckpointManager(str(ckpt_root / arch)).save(ELASTIC_STEP, state, DATA_STATE,
                                                      shardings=(mesh, sspecs))


def _elastic_restore(mesh, ckpt_root):
    """Restore each onto this (1, 2) mesh, params replicated over data: each
    leaf against this rank's shard of the state, bit for bit."""
    res = {}
    for arch in ELASTIC_ARCHS:
        m = CheckpointManager(str(ckpt_root / arch))
        deadline = time.time() + 300
        while m.latest_step() != ELASTIC_STEP:  # written by the (2, 1) spawn
            assert time.time() < deadline, "the (2, 1) ranks never saved"
            time.sleep(0.2)
        whole, sspecs, target = _elastic_state(arch, False, mesh)
        restored, data_state = m.restore(ELASTIC_STEP, target, shardings=(mesh, sspecs))
        want = [shd.local_shard(x, s, mesh) for x, s in
                zip(tree_leaves(whole), tree_leaves(sspecs))]
        res[arch] = {"equal": all(a.dtype == b.dtype and torch.equal(a, b) for a, b in
                                  zip(tree_leaves(restored), want)),
                     "sharded": sum(x.shape != y.shape for x, y in
                                    zip(tree_leaves(restored), tree_leaves(whole))),
                     "data_state": data_state}
    return res


def _resume_batches(cfg):
    rng = np.random.default_rng(11)
    return [{k: torch.tensor(rng.integers(0, cfg.vocab, (8, 32)).astype(np.int32))
             for k in ("inputs", "targets")} for _ in range(RESUME_STEPS)]


def _resume_step(cfg, mesh=None, specs=None):
    return steps.build_train_step(cfg, mesh, base_lr=RESUME_LR, warmup=1,
                                  total_steps=RESUME_STEPS, specs=specs)


def _whole_leaves(state, sspecs, mesh):
    return [(path, shd.gather_shard(x, s, mesh).clone()) for (path, x), s in
            zip(flatten_with_paths(state), tree_leaves(sspecs))]


def _resume_ranks(mesh, ckpt):
    """The (2, 1) FSDP ranks train RESUME_ARCH to RESUME_SAVE, save their
    shards, and go on uninterrupted to RESUME_STEPS; the saved state and
    the final one, whole."""
    cfg = get_config(RESUME_ARCH).reduced()
    whole = steps.init_train_state(torch.Generator().manual_seed(0), cfg, device="cpu")
    specs = steps.train_param_specs(cfg, mesh, fsdp=True)
    sspecs = steps.train_state_specs(specs)
    state = steps.shard_train_state(whole, sspecs, mesh)
    fn, batches = _resume_step(cfg, mesh, specs), _resume_batches(cfg)
    for i in range(RESUME_SAVE):
        state, _ = fn(state, batches[i])
    CheckpointManager(str(ckpt)).save(RESUME_SAVE, state, shardings=(mesh, sspecs))
    saved = _whole_leaves(state, sspecs, mesh)
    for i in range(RESUME_SAVE, RESUME_STEPS):
        state, _ = fn(state, batches[i])
    return {"saved": saved, "final": _whole_leaves(state, sspecs, mesh),
            "sharded_over": sorted({a for s in tree_leaves(sspecs) for a in shd.spec_axes(s)})}


def _cli(argv):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert train.main(argv) == 0
    return out.getvalue()


def _preempted_cli(tmp: Path):
    """``train`` on the initialised group, preempted on rank 0 alone during
    step 1: the flag's all-reduce makes every rank save step 2 and exit 0."""
    handler = PreemptionHandler(install=False)
    real = train.build_train_step

    def build(cfg, **kw):
        fn = real(cfg, **kw)

        def step(state, batch):
            out = fn(state, batch)
            if dist.get_rank() == 0 and int(state.opt.step) == 2:
                handler.trigger()
            return out

        return step

    train.PreemptionHandler, train.build_train_step = (lambda: handler), build
    try:
        return _cli(CLI_ARGS + ["--steps", "4", "--checkpoint-dir", str(tmp / "preempted"),
                                "--save-every", "100"])
    finally:
        train.PreemptionHandler, train.build_train_step = PreemptionHandler, real


def _worker(rank, world, model_axis, init_file, cases_path, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world, timeout=mesh_lib.GROUP_TIMEOUT)
    try:
        mesh = mesh_lib.make_local_mesh(model_axis, device=torch.device("cpu"))
        shape = (world // model_axis, model_axis)
        tmp = Path(out_dir).parent
        with open(cases_path, "rb") as f:
            cases, _ = pickle.load(f)
        if shape == (2, 1):
            _elastic_save(mesh, tmp / "elastic")
        res, r = {"coords": mesh.coords}, _Rank(mesh)
        for key, c in cases.items():
            kind = key.split("/")[0]
            if kind == "layer":
                res[key] = _layer_case(r, key, c)
            elif kind == "stack":
                for sched in ("barrier", "ring"):
                    res[f"{key}/{sched}"] = _stack_case(r, key, c, sched)
            elif kind == "moe":
                res[key] = _moe_case(mesh, c, float(key.split("/")[1]))
            elif kind == "own" and shape == (2, 2):
                res[key] = _own_case(mesh, c)
            elif kind == "train" and TRAIN_CASES[key.split("/")[1]][1] == shape:
                res[key] = _train_case(mesh, key.split("/")[1], c)
        if shape == (1, 2):
            res["cli"] = _cli(CLI_ARGS + ["--steps", "3", "--metrics-out",
                                          str(tmp / f"cli{rank}.json")])
            res["elastic"] = _elastic_restore(mesh, tmp / "elastic")
        if shape == (2, 1):
            res["preempted"] = _preempted_cli(tmp)
            res["resume"] = _resume_ranks(mesh, tmp / "resume")
        if rank == 0 or shape == (1, 2):
            with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
                pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the JAX reference and one spawn of gloo ranks per mesh, all at
    once; wait for all; return their results."""
    tmp = tmp_path_factory.mktemp("sharded_train")
    cases = _make_inputs()
    cases_path = tmp / "cases.pkl"
    with open(cases_path, "wb") as f:
        pickle.dump((cases, TRAIN_CASES), f)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO / "src"))
    (tmp / "ref.py").write_text(textwrap.dedent(JAX_SCRIPT))
    jax_proc = subprocess.Popen([sys.executable, str(tmp / "ref.py"), str(cases_path),
                                 str(tmp / "jax.pkl")], env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    spawns = {}
    for shape in MESHES:
        out = tmp / _mesh_id(shape)
        out.mkdir()
        spawns[shape] = (out, mp.start_processes(
            _worker, args=(shape[0] * shape[1], shape[1], str(out / "rdv"), str(cases_path),
                           str(out)), nprocs=shape[0] * shape[1], join=False,
            start_method="spawn"))
    ranks = {}
    for shape, (out, procs) in spawns.items():
        while not procs.join(timeout=240):
            pass
        ranks[shape] = pickle.load(open(out / "rank0.pkl", "rb"))
        if shape == (1, 2):
            ranks["1x2-rank1"] = pickle.load(open(out / "rank1.pkl", "rb"))
    stdout, stderr = jax_proc.communicate(timeout=420)
    assert jax_proc.returncode == 0 and "JAX-OK" in stdout, stderr[-3000:]
    with open(tmp / "jax.pkl", "rb") as f:
        ref = pickle.load(f)
    return {"cases": cases, "ref": ref, "ranks": ranks, "tmp": tmp}


def _allclose(got: dict, want: dict, tol: float) -> None:
    """Each entry within ``tol``, absolute and relative, as the repo's
    grad checks (``tests/test_torch_train.py``): the int8 scales' grads are
    of order 1e3."""
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=tol, err_msg=k)


# ---------------------------------------------------------------------------
# Single-device references (the port, on the CPU)
# ---------------------------------------------------------------------------

def _single_layer(key, c):
    mode = key.split("/")[1]
    p = bridge.params_from_numpy(c["params"], device="cpu")
    for v in _float_leaves(p).values():
        v.requires_grad_()
    acts = {k: torch.tensor(c[k]).requires_grad_() for k in ("x", "c0", "tail")}
    if mode == "qrnn":
        h, cl = ops.fused_qrnn(p, acts["x"], acts["tail"], acts["c0"])
    else:
        del acts["tail"]
        h, cl = ops.fused_sru(p, acts["x"], acts["c0"])
    loss = torch.sum(h * _t(c["gh"])) + torch.sum(cl * _t(c["gc"]))
    return {k: v.numpy() for k, v in _grads(loss, {**_float_leaves(p), **acts}).items()}


def _single_stack(key, c):
    cell = key.split("/")[1]
    p = bridge.params_from_numpy(c["params"], device="cpu")
    for v in _float_leaves(p).values():
        v.requires_grad_()
    acts = {k: torch.tensor(c[k]).requires_grad_() for k in ("ln", "x", "tails", "c0")}
    if cell == "qrnn":
        y, cl, tl = stacked.fused_qrnn_stack(p, acts["ln"], acts["x"], acts["tails"], acts["c0"])
        loss = torch.sum(y * _t(c["gy"])) + torch.sum(cl * _t(c["gc"])) + torch.sum(tl * _t(c["gt"]))
    else:
        del acts["tails"]
        y, cl = stacked.fused_sru_stack(p, acts["ln"], acts["x"], acts["c0"])
        loss = torch.sum(y * _t(c["gy"])) + torch.sum(cl * _t(c["gc"]))
    return {k: v.numpy() for k, v in _grads(loss, {**_float_leaves(p), **acts}).items()}


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", MESHES, ids=_mesh_id)
@pytest.mark.parametrize("quant", ("fp", "int8"))
@pytest.mark.parametrize("mode", [m for m, _, _ in LAYER_MODES])
def test_sharded_layer_grads_match_jax_and_single_device(runs, mode, quant, shape):
    """One fused layer per rank (B1's plain version here), differentiated
    through ``enter`` / ``fused_layer`` / ``gather``: grads w.r.t. ``x``,
    the float slabs (int8: straight-through, the slab gets none and the
    whole ``wq_scale`` the reference's), ``b``, ``w_skip``, ``c0`` and the
    QRNN tail, under a loss of ``h`` and the last carry, against JAX's
    sharded grads and the port's single-device ones."""
    key = f"layer/{mode}/{quant}"
    got, ref = runs["ranks"][shape][key], runs["ref"][key]
    assert set(got) == set(ref)
    if quant == "int8":
        assert "wq" not in got and "wq_scale" in got
    _allclose(got, ref, GRAD_TOL)
    _allclose(got, _single_layer(key, runs["cases"][key]), GRAD_TOL)


@pytest.mark.parametrize("shape", MESHES, ids=_mesh_id)
@pytest.mark.parametrize("sched", ("barrier", "ring"))
@pytest.mark.parametrize("quant", ("fp", "int8"))
@pytest.mark.parametrize("cell", ("sru", "qrnn"))
def test_sharded_stack_grads_match_jax_and_single_device(runs, cell, quant, sched, shape):
    """The sharded depth-fused stack under both schedules (one backward,
    shared: the rank's shard of the plain stack recomputed): grads w.r.t.
    every float leaf, the norm gains, ``x``, the carries and the QRNN tails
    against JAX's sharded stack's and the port's single-device stack's."""
    key = f"stack/{cell}/{quant}"
    got, ref = runs["ranks"][shape][f"{key}/{sched}"], runs["ref"][f"{key}/{sched}"]
    assert set(got) == set(ref)
    _allclose(got, ref, GRAD_TOL)
    _allclose(got, _single_stack(key, runs["cases"][key]), GRAD_TOL)


def test_jax_own_sharded_stack_case(runs):
    """JAX's ``test_sharded_fused_rnn_grads_match_reference`` stack case:
    ``qrnn-paper-large-stacked.reduced()`` through ``rnn_stack_apply``, loss
    ``sum(y ** 2)``, JAX on (2, 4) and the port on (2, 2): every leaf's grad
    and ``x``'s."""
    got, ref = runs["ranks"][(2, 2)]["own"], runs["ref"]["own"]
    want = dict(flatten_with_paths(ref["params"]))
    assert set(got["params"]) == set(want)
    _allclose(got["params"], want, GRAD_TOL)
    np.testing.assert_allclose(got["x"], ref["x"], rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.parametrize("shape", MESHES, ids=_mesh_id)
@pytest.mark.parametrize("cf", MOE_CFS)
def test_moe_shard_map_grads_match_sorted(runs, cf, shape):
    """MoE's expert-parallel schedule differentiated (``enter`` on ``x`` and
    the router, ``combine`` on the output): each rank's experts get their
    own grads, and all of them, the router's and ``x``'s equal ``sorted``'s
    on one rank; at capacity 0.5 tokens drop."""
    key = f"moe/{cf}"
    got, c = runs["ranks"][shape][key], runs["cases"][key]
    assert got["E_loc"] == 8 // shape[1]
    p = bridge.params_from_numpy(c["params"], device="cpu")
    for v in p.values():
        v.requires_grad_()
    x = torch.tensor(c["x"]).requires_grad_()
    y = moe.moe_apply(p, _moe_cfg(cf).with_(moe_impl="sorted"), x)
    want = {k: v.numpy() for k, v in _grads(torch.sum(y * _t(c["gy"])), {**p, "x": x}).items()}
    _allclose(got, want, MOE_TOL)


@pytest.mark.parametrize("name", sorted(TRAIN_CASES))
def test_train_step_matches_jax_sharded_step(runs, name):
    """``build_train_step(cfg, mesh)``, one step at 8 x 64 tokens,
    microbatches 2 and a ragged mask, against JAX's jitted sharded step on
    the same mesh shape and FSDP setting: loss, ``grad_norm``, and every
    param and moment leaf (and the error-feedback state under int8
    compression, whose absmax is over the whole leaf). ``llama3``'s
    attention leaves are held whole over ``model``; every config's vocab
    leaves are sharded over it."""
    arch, shape, fsdp, comp = TRAIN_CASES[name]
    got, ref = runs["ranks"][shape][f"train/{name}"], runs["ref"][f"train/{name}"]
    assert ("data" in got["sharded_over"]) == fsdp
    assert ("model" in got["sharded_over"]) == (shape[1] > 1)
    assert abs(got["metrics"]["loss"] - ref["metrics"]["loss"]) <= LOSS_TOL
    assert abs(got["metrics"]["grad_norm"] - ref["metrics"]["grad_norm"]) <= LOSS_TOL
    assert got["metrics"]["lr"] == pytest.approx(ref["metrics"]["lr"], rel=1e-6)
    assert len(got["leaves"]) == len(ref["leaves"])
    for (path, a), b in zip(got["leaves"], ref["leaves"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_TOL, err_msg=path)


@pytest.mark.parametrize("arch", ELASTIC_ARCHS)
def test_elastic_restore_onto_another_mesh(runs, arch, tmp_path):
    """A state saved from (2, 1) FSDP shards restores bit for bit onto
    (1, 2) (the vocab leaves then sharded over ``model``, and the SRU
    stack's cell leaves and mamba2's ``ff`` leaves); the files and manifest
    are byte-equal to a single-device save of the same state, and JAX's
    ``CheckpointManager`` restores them."""
    import jax

    from repro.checkpoint import CheckpointManager as JaxManager

    got = runs["ranks"][(1, 2)]["elastic"][arch]
    assert got["equal"] and got["data_state"] == DATA_STATE
    # embed and unembed (and the SRU's w and b, mamba2's in_z, in_x, conv_x,
    # gnorm and out_proj), in the params and both moments
    assert got["sharded"] == 3 * {"mamba2-2.7b": 7, "sru-paper-large-stacked": 4}[arch]
    whole = steps.init_train_state(torch.Generator().manual_seed(0), get_config(arch).reduced(),
                                   device="cpu")
    CheckpointManager(str(tmp_path)).save(ELASTIC_STEP, whole, DATA_STATE)
    saved = runs["tmp"] / "elastic" / arch / f"step_{ELASTIC_STEP}"
    names = sorted(os.listdir(tmp_path / f"step_{ELASTIC_STEP}"))
    assert names == sorted(os.listdir(saved))
    for n in names:
        assert (saved / n).read_bytes() == (tmp_path / f"step_{ELASTIC_STEP}" / n).read_bytes(), n
    jstate = jax.tree_util.tree_map(np.asarray, bridge.train_state_to_numpy(whole))
    restored, data_state = JaxManager(str(saved.parent)).restore(
        ELASTIC_STEP, jax.eval_shape(lambda: jstate))
    assert data_state == DATA_STATE
    for a, b in zip(jax.tree_util.tree_leaves(restored), tree_leaves(whole)):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_elastic_resume_on_one_device_matches_the_ranks_run(runs):
    """fp32, the reduced SRU stack: two FSDP ranks (2, 1) train to step 2
    and save their shards; one device restores the state bit for bit
    (params, both moments, the step) and trains on to step 4, ending no
    farther from the single device's uninterrupted run than the two ranks'
    uninterrupted run is (plus 1e-6): the save and restore add nothing to
    the two reduction orders' difference."""
    got = runs["ranks"][(2, 1)]["resume"]
    assert got["sharded_over"] == ["data"]
    cfg = get_config(RESUME_ARCH).reduced()
    assert cfg.compute_dtype == "float32"
    fresh = steps.init_train_state(torch.Generator().manual_seed(0), cfg, device="cpu")
    restored, _ = CheckpointManager(str(runs["tmp"] / "resume")).restore(RESUME_SAVE, fresh)
    leaves = flatten_with_paths(restored)
    assert [p for p, _ in leaves] == [p for p, _ in got["saved"]]
    assert {p.split("/")[1] for p, _ in leaves if p.startswith("opt/")} >= {"m", "v", "step"}
    for (path, a), (_, b) in zip(leaves, got["saved"]):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    fn, batches = _resume_step(cfg), _resume_batches(cfg)
    state = restored
    for i in range(RESUME_SAVE, RESUME_STEPS):
        state, _ = fn(state, batches[i])
    single = fresh
    for i in range(RESUME_STEPS):
        single, _ = fn(single, batches[i])
    resumed, ranks = dict(flatten_with_paths(state.params)), dict(got["final"])
    gap_ranks = gap_resumed = 0.0
    for path, x in flatten_with_paths(single.params):
        gap_ranks = max(gap_ranks, (ranks["params/" + path] - x).abs().max().item())
        gap_resumed = max(gap_resumed, (resumed[path] - x).abs().max().item())
    assert gap_resumed <= gap_ranks + 1e-6, (gap_resumed, gap_ranks)


def test_train_cli_on_an_initialised_group(runs, tmp_path):
    """``train --device cpu`` called on both ranks of an initialised gloo
    group joins it on the (2, 1) data mesh: rank 0 alone prints, the mesh and
    the backend first, and the losses are the single-rank run's."""
    out0, out1 = runs["ranks"][(1, 2)]["cli"], runs["ranks"]["1x2-rank1"]["cli"]
    assert out1 == ""
    assert "mesh: {'data': 2, 'model': 1}" in out0 and "dist: backend gloo" in out0
    assert "done:" in out0
    _cli(CLI_ARGS + ["--steps", "3", "--metrics-out", str(tmp_path / "single.json")])
    ranks = json.loads((runs["tmp"] / "cli0.json").read_text())
    single = json.loads((tmp_path / "single.json").read_text())
    assert [h["step"] for h in ranks] == [0, 1, 2]
    for a, b in zip(ranks, single):
        assert abs(a["loss"] - b["loss"]) <= LOSS_TOL
        assert abs(a["grad_norm"] - b["grad_norm"]) <= LOSS_TOL


def test_preempted_on_two_ranks_resumes_on_one(runs, tmp_path):
    """Preempted on rank 0 of two during step 1, both ranks save step 2 and
    exit 0; ``--resume auto`` on one rank runs on to step 4 and ends within
    PARAM_TOL of the uninterrupted single-rank run's params."""
    out = runs["ranks"][(2, 1)]["preempted"]
    assert "[preempt] checkpoint saved" in out and "done:" not in out
    ckpt = runs["tmp"] / "preempted"
    assert CheckpointManager(str(ckpt)).latest_step() == 2
    resumed = _cli(CLI_ARGS + ["--steps", "4", "--checkpoint-dir", str(ckpt), "--resume", "auto"])
    assert "[resume] step 2" in resumed
    _cli(CLI_ARGS + ["--steps", "4", "--checkpoint-dir", str(tmp_path)])
    for n in sorted(os.listdir(tmp_path / "step_4")):
        if n.endswith(".npy"):
            np.testing.assert_allclose(np.load(ckpt / "step_4" / n), np.load(tmp_path / "step_4" / n),
                                       rtol=0, atol=PARAM_TOL, err_msg=n)


def test_remat_recompute_runs_in_the_forward_context():
    """On the card the backward, and a remat block's recompute in it, runs
    on the autograd engine's device thread, where the forward's context
    variables (the mesh of ``use_rules``, which the sharded dispatch reads)
    are not set. ``maybe_remat`` recomputes in a copy of the forward's
    context: here the backward runs after the ``use_rules`` block, in a
    fresh thread, and the recompute still sees the mesh."""
    seen = []

    def fn(x):
        seen.append(shd.activation_rules() is not None)
        return x * x

    x = torch.ones(3, requires_grad=True)
    with shd.use_rules(mesh_lib.Mesh({"data": 1, "model": 2})):
        y = lm.maybe_remat(fn, "block")(x).sum()
    backward = threading.Thread(target=y.backward)
    backward.start()
    backward.join()
    assert seen == [True, True] and torch.equal(x.grad, torch.full((3,), 2.0))


def test_ranks_sharing_a_card_need_gloo_asked_for(monkeypatch):
    """Two ``torchrun`` ranks on a host with one card: NCCL is refused
    before any group starts, naming ``--dist-backend gloo``; with gloo asked
    for the check passes; ``--device cpu`` refuses NCCL."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match="--dist-backend gloo"):
        train.main(["--arch", "sru-paper-large-stacked", "--reduced", "--steps", "1"])
    assert not dist.is_initialized()
    gloo = train.parse_args(["--arch", "sru-paper-large-stacked", "--dist-backend", "gloo"])
    train._check_cards(train._backend(gloo, torch.device("cuda")), 2)
    cpu = train.parse_args(["--arch", "sru-paper-large-stacked", "--device", "cpu",
                            "--dist-backend", "nccl"])
    with pytest.raises(SystemExit, match="nccl runs on the card"):
        train._backend(cpu, torch.device("cpu"))
