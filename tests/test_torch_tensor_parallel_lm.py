"""Tensor parallelism of the attention, dense MLP and Mamba leaves
(``models/attention.py``, ``mamba.py`` and ``lm._mlp``, on the at-rest layout of
``fused_sharded.rank_specs`` / ``rank_cache_specs``) against JAX's sharded
functions, where GSPMD partitions the same leaves; and the log-sum-exp form
of the decode attention's plain version (B5), which a sequence-sharded
cache runs.

The inputs (whole LM params from the port's ``lm_init``, prompts and train
batches) are made once here from a seed and written to a pickle. Two sides
then run at once on them:

* JAX, in one subprocess with 8 virtual CPU devices, on meshes built with
  ``axis_types=(AxisType.Auto,) * 2``: the params placed by
  ``param_specs``, its jitted ``build_prefill_step`` and
  ``build_decode_step`` (a prefill and GEN greedy decode steps) on each
  case's mesh, ``jax.grad`` of ``lm_loss`` under ``use_rules`` on (1, 2),
  and ``param_specs`` / ``cache_specs`` / ``describe_replications`` of
  every non-paper config at full shapes (the spec functions read only the
  mesh's shape);
* the port, in one ``torch.multiprocessing`` spawn of gloo ranks per mesh
  shape, (1, 2) and (2, 4), each rank on its shards
  (``serve.shard_params``, ``steps.train_param_specs``). The (1, 2) ranks
  also serve ``llama3-8b`` through ``serve.main`` joined to their group.

The serving cases: ``llama3-8b`` (KV heads over the axis), ``granite-20b``
(MQA: the sequence-sharded cache, B5's log-sum-exp form), ``mamba2-2.7b``
(B4 on the rank's heads) on (1, 2), and ``zamba2-7b`` on (2, 4) as JAX's
``tests/test_distributed.py`` runs it (its 2 KV heads over a 4-wide axis:
the sequence path). Tolerances are the reference's: logits 3e-5 with greedy
tokens equal under fp32, grads 5e-4.

Sequence parallelism (``SP_CASES``): reduced ``nemotron-4-340b`` with
``sequence_parallel=True`` on (1, 2) and with FSDP on (2, 2) (a third spawn),
a sequence the axis does not divide, and ``mamba2-2.7b`` under the flag: the
train step's grads against ``jax.grad`` of ``lm_loss`` under ``use_rules(mesh,
sp=True)``, the stream each block takes, and the collectives inside the
layers.
"""
from __future__ import annotations

import contextlib
import functools
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
from repro_torch.configs import shapes
from repro_torch.configs.registry import REGISTRY, get_config
from repro_torch.distribution import fused_sharded as fs
from repro_torch.distribution import sharding as shd
from repro_torch.kernels.gqa_decode.ops import gqa_decode
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.training import steps
from repro_torch.training.steps import build_decode_step, build_prefill_step
from repro_torch.tree import flatten_with_paths, tree_leaves, unflatten_like

REPO = Path(__file__).resolve().parents[1]
B, S0, GEN = 4, 12, 4
MAX_LEN = S0 + GEN
# (arch, (data, model)): the serving cases.
SERVE_CASES = (("llama3-8b", (1, 2)), ("granite-20b", (1, 2)), ("mamba2-2.7b", (1, 2)),
               ("zamba2-7b", (2, 4)))
GRAD_ARCHS = ("llama3-8b", "mamba2-2.7b")  # on (1, 2)
# Variants of the reduced configs on (1, 2), served and differentiated
# against the single-device port: name -> (arch, config overrides, max_len).
# 3 q heads on 1 KV head: w_q shards its flat columns, which split a head, so
# q is gathered and w_o's rows take a slice of the whole output; a 17-slot
# cache does not divide over 2, so it is whole on both ranks. Padded to 4
# heads: the rank's own heads, the padded one masked, the KV cache over its
# sequence. Mamba with 2 B/C groups: each rank's heads read their own group.
# Mamba with 6 heads in 3 groups: a rank's 3 heads split a group, so each
# head reads its own group's B and C (the state still over the heads).
VARIANTS = {"gathered_q_whole_cache": ("llama3-8b", {"n_heads": 3, "n_kv_heads": 1}, MAX_LEN + 1),
            "padded_heads": ("llama3-8b", {"n_heads": 3, "n_kv_heads": 1, "pad_heads_to": 4},
                             MAX_LEN),
            "mamba_two_groups": ("mamba2-2.7b", {"ssm_ngroups": 2}, MAX_LEN),
            "mamba_heads_split_groups": ("mamba2-2.7b", {"ssm_expand": 3, "ssm_headdim": 32,
                                                         "ssm_ngroups": 3}, MAX_LEN)}
LOGIT_TOL, GRAD_TOL = 3e-5, 5e-4
BATCH_ROWS, BATCH_SEQ = 4, 16
# Sequence parallelism in the train step: name -> (arch, mesh, FSDP, the
# batch's sequence length). 15 tokens do not divide over the 2-wide model
# axis: the stream stays whole (JAX's divisibility fallback).
SP_CASES = {"nemotron": ("nemotron-4-340b", (1, 2), False, BATCH_SEQ),
            "nemotron_fsdp": ("nemotron-4-340b", (2, 2), True, BATCH_SEQ),
            "nemotron_odd_seq": ("nemotron-4-340b", (1, 2), False, BATCH_SEQ - 1),
            "mamba2": ("mamba2-2.7b", (1, 2), False, BATCH_SEQ)}
MESHES = tuple(sorted({m for _, m in SERVE_CASES} | {c[1] for c in SP_CASES.values()}))
BF16_TOL = 2 * 4 * 2.0 ** -8  # two bf16 roundings of a value below 4
JOINED_ARGV = ["--arch", "llama3-8b", "--reduced", "--device", "cpu", "--batch", "4",
               "--prompt-len", "12", "--gen-len", "6", "--model-shards", "2"]
# Every non-paper config's at-rest specs on these mesh shapes.
REST_MESHES = {"1x2": {"data": 1, "model": 2}, "2x4": {"data": 2, "model": 4},
               "prod": {"data": 16, "model": 16}}
NON_PAPER = sorted(n for n in REGISTRY if get_config(n).cell is None)


def _mesh_id(shape):
    return f"{shape[0]}x{shape[1]}"


def _cfg(arch, over=None):
    return get_config(arch).reduced().with_(**(over or {}))


def _batch(rng, cfg, seq=BATCH_SEQ) -> dict:
    mask = np.ones((BATCH_ROWS, seq), np.float32)
    mask[1, 9:] = 0  # a ragged row
    return {"inputs": rng.integers(0, cfg.vocab, (BATCH_ROWS, seq)).astype(np.int32),
            "targets": rng.integers(0, cfg.vocab, (BATCH_ROWS, seq)).astype(np.int32),
            "mask": mask}


def _sp_cfg(name):
    arch, _, fsdp, _ = SP_CASES[name]
    return _cfg(arch, {"sequence_parallel": True, "fsdp": fsdp})


def _make_inputs() -> dict:
    rng = np.random.default_rng(0)
    cases = {}
    for arch, shape in SERVE_CASES:
        cfg = _cfg(arch)
        cases[f"serve/{arch}"] = {
            "mesh": shape,
            "params": bridge.params_to_numpy(lm.lm_init(torch.Generator().manual_seed(0), cfg,
                                                        device="cpu")),
            "tokens": rng.integers(0, cfg.vocab, (B, S0)).astype(np.int32)}
    for arch in GRAD_ARCHS:
        cfg = _cfg(arch)
        cases[f"grads/{arch}"] = {
            "mesh": (1, 2),
            "params": bridge.params_to_numpy(lm.lm_init(torch.Generator().manual_seed(1), cfg,
                                                        device="cpu")),
            "batch": _batch(rng, cfg)}
    for name, (arch, over, max_len) in VARIANTS.items():
        cfg = _cfg(arch, over)
        cases[f"variant/{name}"] = {
            "mesh": (1, 2), "arch": arch, "over": over, "max_len": max_len,
            "params": bridge.params_to_numpy(lm.lm_init(torch.Generator().manual_seed(2), cfg,
                                                        device="cpu")),
            "tokens": rng.integers(0, cfg.vocab, (B, S0)).astype(np.int32),
            "batch": _batch(rng, cfg)}
    for name, (arch, shape, fsdp, seq) in SP_CASES.items():
        cfg = _sp_cfg(name)
        cases[f"sp/{name}"] = {
            "mesh": shape, "arch": arch, "over": {"sequence_parallel": True, "fsdp": fsdp},
            "params": bridge.params_to_numpy(lm.lm_init(torch.Generator().manual_seed(3), cfg,
                                                        device="cpu")),
            "batch": _batch(rng, cfg, seq)}
    return cases


JAX_SCRIPT = r"""
import json, pickle, sys, types
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType, PartitionSpec as P
from repro.configs import shapes
from repro.configs.registry import get_config
from repro.distribution import sharding as shd
from repro.distribution.sharding import use_rules
from repro.models import lm
from repro.models.lm import lm_loss
from repro.training.steps import build_decode_step, build_prefill_step

cases = pickle.load(open(sys.argv[1], "rb"))
rest = json.loads(sys.argv[3])
def mesh(shape):
    n = shape[0] * shape[1]
    return jax.make_mesh(tuple(shape), ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:n])
tree = lambda p: jax.tree_util.tree_map(jnp.asarray, p)
def placed(params, m):
    return jax.device_put(params, shd.named_shardings(shd.param_specs(params, m), m))
out = {}
for key, c in cases.items():
    kind, arch = key.split("/")
    if kind == "variant":  # held to the single-device port in the test process
        continue
    if kind == "sp":
        arch = c["arch"]
    cfg = get_config(arch).reduced().with_(**c.get("over", {}))
    m = mesh(c["mesh"])
    psh = placed(tree(c["params"]), m)
    if kind == "serve":
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
        out[key] = {"logits": np.stack(logits), "tokens": np.concatenate(greedy, axis=1)}
    else:
        with use_rules(m, sp=cfg.sequence_parallel):
            loss, g = jax.jit(jax.value_and_grad(lambda p, b: lm_loss(p, cfg, b)[0]))(
                psh, tree(c["batch"]))
        out[key] = {"loss": float(loss),
                    "grads": {shd._path_str(p): np.asarray(v) for p, v in
                              jax.tree_util.tree_flatten_with_path(g)[0]}}
def js(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]
def flat(t):
    leaves = jax.tree_util.tree_flatten_with_path(t, is_leaf=lambda x: isinstance(x, P))[0]
    return {shd._path_str(p): js(s) for p, s in leaves}
for name in rest["names"]:
    cfg = get_config(name)
    params = jax.eval_shape(lambda: lm.lm_init(jax.random.PRNGKey(0), cfg))
    caches = shapes.cache_specs(cfg, shapes.SHAPES["decode_32k"])
    for mname, shape in rest["meshes"].items():
        sm = types.SimpleNamespace(shape=shape)
        specs = shd.param_specs(params, sm)
        out[f"rest/{name}/{mname}"] = {"param": flat(specs),
                                       "cache": flat(shd.cache_specs(caches, sm)),
                                       "repl": shd.describe_replications(params, specs)}
pickle.dump(out, open(sys.argv[2], "wb"))
print("JAX-OK")
""" % {"GEN": GEN}


# ---------------------------------------------------------------------------
# The port's ranks
# ---------------------------------------------------------------------------

def _whole(params_np):
    return bridge.params_from_numpy(params_np, device="cpu")


def _greedy_run(cfg, params, toks, mesh, max_len=MAX_LEN):
    """Prefill over ``toks`` then GEN greedy decode steps through the mesh
    step builders (a ``max_len``-slot cache): every step's logits, the
    greedy tokens (this rank's rows) and the shapes of the caches the rank
    held."""
    prefill = build_prefill_step(cfg, mesh, batch=B, max_len=max_len, device="cpu")
    decode = build_decode_step(cfg, mesh, max_len=max_len)
    lg, caches = prefill(params, {"inputs": toks})
    logits, greedy = [lg.numpy()], []
    for _ in range(GEN):
        tok = torch.argmax(lg[:, -1, :cfg.vocab], dim=-1)[:, None]
        greedy.append(tok.numpy())
        lg, caches = decode(params, caches, tok)
        logits.append(lg.numpy())
    return {"logits": np.stack(logits), "tokens": np.concatenate(greedy, axis=1),
            "caches": {path: tuple(x.shape) for path, x in flatten_with_paths(caches)}}


def _grads_case(cfg, c, mesh):
    """The train step's loss and grads (``steps.step_grads``) on this rank's
    shards, each grad made whole over the mesh; the shape of the stream
    each block took (``lm._block_apply``) and the step's collectives."""
    specs = steps.train_param_specs(cfg, mesh, fsdp=cfg.fsdp)
    whole = _whole(c["params"])
    params = shd.map_with_paths(lambda p, x: shd.local_shard(x, shd._at(specs, p), mesh), whole)
    batch = {k: torch.tensor(v) for k, v in c["batch"].items()}
    streams, block = [], lm._block_apply

    def seen(params, cfg, x, positions):
        streams.append(tuple(x.shape))
        return block(params, cfg, x, positions)

    lm._block_apply = seen
    try:
        with mesh_lib.recorded_collectives(mesh) as log:
            loss, grads = steps.step_grads(cfg, params, batch, mesh, specs)
    finally:
        lm._block_apply = block
    eval_loss = steps.build_eval_step(cfg, mesh, specs=specs)(params, batch)["loss"]
    return {"loss": float(loss), "eval_loss": float(eval_loss),
            "grads": {path: shd.gather_shard(g, s, mesh).numpy() for (path, g), s in
                      zip(flatten_with_paths(grads), tree_leaves(specs))},
            "held": {path: tuple(x.shape) for path, x in flatten_with_paths(params)},
            "streams": streams, "collectives": [tuple(e) for e in log]}


def _refusal(mesh) -> str:
    """The decode step builder of the MQA config without the caches'
    length: its rank could not tell a slice of the sequence from a whole
    cache, so the builder refuses before any step runs."""
    try:
        build_decode_step(_cfg("granite-20b"), mesh)
    except ValueError as e:
        return str(e)
    return ""


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
            kind, arch = key.split("/")
            cfg = _cfg(c.get("arch", arch), c.get("over"))
            if kind in ("serve", "variant"):
                params, _ = serve.shard_params(cfg, _whole(c["params"]), mesh)
                toks = torch.tensor(c["tokens"], dtype=torch.int64)
                toks = shd.local_shard(toks, (fs._batch_spec(mesh, B), None), mesh)
                res[key] = _greedy_run(cfg, params, toks, mesh, c.get("max_len", MAX_LEN))
                res[key]["block_bytes"] = serve.block_bytes(params)
            if kind in ("grads", "variant", "sp"):
                res[key + "/grads"] = _grads_case(cfg, c, mesh)
        if shape == (1, 2):
            res["refusal"] = _refusal(mesh)
            with contextlib.redirect_stdout(io.StringIO()) as out:
                assert serve.main(JOINED_ARGV) == 0
            res["joined"] = out.getvalue()
        if rank:  # the grads are rank 0's alone; every rank's streams and collectives
            res = {k: {f: v[f] for f in ("streams", "collectives")} if k.startswith("sp/")
                   else v for k, v in res.items()
                   if k.startswith("sp/") or not k.endswith("/grads")}
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the JAX reference and one spawn of gloo ranks per mesh, all at
    once; wait for all; return their results."""
    tmp = tmp_path_factory.mktemp("tplm")
    cases = _make_inputs()
    cases_path = tmp / "cases.pkl"
    with open(cases_path, "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO / "src"))
    (tmp / "ref.py").write_text(textwrap.dedent(JAX_SCRIPT))
    jax_proc = subprocess.Popen(
        [sys.executable, str(tmp / "ref.py"), str(cases_path), str(tmp / "jax.pkl"),
         json.dumps({"names": NON_PAPER, "meshes": REST_MESHES})], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
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
        ranks[shape] = [pickle.load(open(out / f"rank{r}.pkl", "rb"))
                        for r in range(shape[0] * shape[1])]
    stdout_jax, stderr_jax = jax_proc.communicate(timeout=420)
    assert jax_proc.returncode == 0 and "JAX-OK" in stdout_jax, stderr_jax[-3000:]
    with open(tmp / "jax.pkl", "rb") as f:
        ref = pickle.load(f)
    return {"cases": cases, "ref": ref, "ranks": ranks}


def _rows(ranks, key, field, batch_dim):
    """The whole array from the ranks' row pieces: data ranks in order, the
    model ranks of one data index agreeing bit for bit."""
    rows = {}
    for r in ranks:
        i = r["coords"]["data"]
        if i in rows:
            np.testing.assert_array_equal(r[key][field], rows[i])
        else:
            rows[i] = r[key][field]
    return np.concatenate([rows[i] for i in sorted(rows)], axis=batch_dim)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape", SERVE_CASES, ids=lambda v: str(v))
def test_sharded_serving_matches_jax(runs, arch, shape):
    """A prefill and GEN greedy decode steps on the rank's shards against
    JAX's GSPMD steps on the same mesh: the greedy tokens equal, every
    step's logits within 3e-5 (zamba2's at 3e-5 too, tighter than JAX's own
    test's 3e-4); each model rank holds its shards of the attention, MLP and
    Mamba leaves (the bytes ``rank_specs`` gives it) and of the caches (KV
    heads for llama3, the KV sequence for granite and zamba2 on 4, the SSM
    heads and ``conv_x`` channels)."""
    key = f"serve/{arch}"
    ranks, ref = runs["ranks"][shape], runs["ref"][key]
    np.testing.assert_array_equal(_rows(ranks, key, "tokens", 0), ref["tokens"])
    np.testing.assert_allclose(_rows(ranks, key, "logits", 1), ref["logits"], rtol=0,
                               atol=LOGIT_TOL)
    cfg, k, D = _cfg(arch), shape[1], shape[0]
    whole = _whole(runs["cases"][key]["params"])
    spec_only = mesh_lib.Mesh({"data": D, "model": k}, {"data": 0, "model": 0})
    want = serve.block_bytes(serve.shard_params(cfg, whole, spec_only)[0])
    assert all(r[key]["block_bytes"] == want for r in ranks)
    assert want < serve.block_bytes(whole)  # B, C, dt, the norms and conv_b/c stay whole
    held = ranks[0][key]["caches"]
    size = MAX_LEN
    if cfg.n_kv_heads:
        kv = held.get("layers/k", held.get("shared_attn/k"))
        if cfg.n_kv_heads % k == 0:
            assert kv == (kv[0], B // D, size, cfg.n_kv_heads // k, cfg.d_head)
        else:
            assert kv == (kv[0], B // D, size // k, cfg.n_kv_heads, cfg.d_head)
    if cfg.ssm:
        assert held["layers/ssm"][2] * k == cfg.ssm_heads
        assert held["layers/conv_x"][-1] * k == cfg.d_inner


def test_serve_model_shards_joined_gives_single_device_tokens(runs, capsys):
    """``serve.main`` on the (1, 2) ranks' initialised group serves
    ``llama3-8b`` with the single-device serve's greedy tokens; rank 0 alone
    prints, with half the attention/MLP/Mamba leaf bytes a rank."""
    outs = [r["joined"] for r in runs["ranks"][(1, 2)]]
    assert outs[1] == "" and "serve-stats " in outs[0]
    stats = json.loads(outs[0].split("serve-stats ", 1)[1])
    assert serve.main(JOINED_ARGV[:-2]) == 0
    single = json.loads(capsys.readouterr().out.split("serve-stats ", 1)[1])
    assert stats["tokens"] == single["tokens"]
    assert stats["block_bytes"] == [stats["block_bytes_whole"] // 2] * 2
    assert "attention/MLP/Mamba leaf bytes per model rank" in outs[0]


def test_sequence_sharded_decode_needs_the_cache_length(runs):
    """Without ``max_len`` a rank of the MQA config cannot tell a slice of
    the cache's sequence from a whole cache: the decode step builder says
    so when the step is built."""
    msg = runs["ranks"][(1, 2)][0]["refusal"]
    assert "max_len" in msg and "KV heads do not divide" in msg


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_sharded_variants_match_the_single_device_run(runs, name):
    """VARIANTS on (1, 2): the greedy tokens and every step's logits of the
    rank's shards within 3e-5 of the single-device run (which
    ``tests/test_torch_serve.py`` and ``test_torch_archs.py`` hold to JAX),
    the train step's grads within 5e-4 of autograd on one device; the KV
    cache whole (17 slots) or over its sequence, the SSM state over its
    heads."""
    key = f"variant/{name}"
    c = runs["cases"][key]
    cfg = _cfg(c["arch"], c["over"])
    whole = _whole(c["params"])
    want = _greedy_run(cfg, whole, torch.tensor(c["tokens"], dtype=torch.int64), None,
                       c["max_len"])
    for r in runs["ranks"][(1, 2)]:
        np.testing.assert_array_equal(r[key]["tokens"], want["tokens"])
        np.testing.assert_allclose(r[key]["logits"], want["logits"], rtol=0, atol=LOGIT_TOL)
        if cfg.n_kv_heads:
            size = r[key]["caches"]["layers/k"][2]
            assert size == (c["max_len"] if c["max_len"] % 2 else c["max_len"] // 2)
        if cfg.ssm:
            assert r[key]["caches"]["layers/ssm"][2] * 2 == cfg.ssm_heads
    leaves = [x.detach().requires_grad_() for x in tree_leaves(whole)]
    batch = {k: torch.tensor(v) for k, v in c["batch"].items()}
    loss, _ = lm.lm_loss(unflatten_like(whole, leaves), cfg, batch)
    grads = torch.autograd.grad(loss, leaves)
    got = runs["ranks"][(1, 2)][0][key + "/grads"]
    assert abs(got["loss"] - loss.item()) <= LOGIT_TOL
    for (path, _), g in zip(flatten_with_paths(whole), grads):
        np.testing.assert_allclose(got["grads"][path], g.numpy(), rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=path)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_sharded_train_grads_match_jax(runs, arch):
    """``steps.step_grads`` on the rank's shards (the rank's q heads,
    ``w_kv`` columns, ``w_o`` rows, MLP columns and rows, Mamba ``ff``
    channels and heads), each grad made whole, against ``jax.grad`` of
    ``lm_loss`` under GSPMD on (1, 2): within 5e-4, the loss within 3e-5;
    the rank held half of each sharded leaf."""
    key = f"grads/{arch}"
    got, ref = runs["ranks"][(1, 2)][0][key + "/grads"], runs["ref"][key]
    assert abs(got["loss"] - ref["loss"]) <= LOGIT_TOL
    assert sorted(got["grads"]) == sorted(ref["grads"])
    for path, g in ref["grads"].items():
        np.testing.assert_allclose(got["grads"][path], g, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=path)
    cfg, held = _cfg(arch), got["held"]
    if cfg.ssm:
        assert held["layers/mamba/in_x"][-1] * 2 == cfg.d_inner
        assert held["layers/mamba/out_proj"][1] * 2 == cfg.d_inner
    else:
        assert held["layers/attn/w_q"][-1] * 2 == cfg.n_heads * cfg.d_head
        assert held["layers/mlp/w_down"][1] * 2 == cfg.d_ff


@pytest.mark.parametrize("name", sorted(SP_CASES))
def test_sequence_parallel_grads_match_jax(runs, name):
    """Under ``sequence_parallel=True`` ``steps.step_grads`` on the rank's
    shards (FSDP on (2, 2)) against ``jax.grad`` of ``lm_loss`` under
    ``use_rules(mesh, sp=True)``: the loss within 3e-5, every grad within
    5e-4, ``ln1``, ``ln2`` and ``final_norm`` included (each model rank
    computes them on its sequence slice; the step sums them over "model").
    The eval step, on the same forward, gives the loss too."""
    key = f"sp/{name}"
    got = runs["ranks"][SP_CASES[name][1]][0][key + "/grads"]
    ref = runs["ref"][key]
    assert abs(got["loss"] - ref["loss"]) <= LOGIT_TOL
    assert abs(got["eval_loss"] - ref["loss"]) <= LOGIT_TOL
    assert sorted(got["grads"]) == sorted(ref["grads"])
    assert {"final_norm", "layers/ln1"} <= set(got["grads"])
    for path, g in ref["grads"].items():
        np.testing.assert_allclose(got["grads"][path], g, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=path)


@pytest.mark.parametrize("name", sorted(SP_CASES))
def test_sequence_parallel_stream_is_the_rank_slice(runs, name):
    """Every block of every rank takes the rank's rows and its slice of the
    sequence, (rows, S / 2, d), in the forward and in its remat's recompute;
    where S does not divide over the axis, the whole sequence (rows, S,
    d)."""
    arch, shape, _, seq = SP_CASES[name]
    cfg = _sp_cfg(name)
    want = (BATCH_ROWS // shape[0], seq // shape[1] if seq % shape[1] == 0 else seq,
            cfg.d_model)
    for r in runs["ranks"][shape]:
        streams = r[f"sp/{name}/grads"]["streams"]
        assert set(streams) == {want} and len(streams) >= cfg.n_layers


@pytest.mark.parametrize("name", ["nemotron", "nemotron_fsdp"])
def test_sequence_parallel_blocks_gather_and_scatter_the_stream(runs, name):
    """Inside the layers (Megatron-SP around the attention and the MLP) the
    stream moves by all-gathers of the whole sequence and reduce-scatters to
    the slice, and no collective all-reduces a tensor of the slice's size or
    more (the sums over "model" of the norms' grads and the loss lie
    outside the layers, and are smaller)."""
    _, shape, _, seq = SP_CASES[name]
    cfg = _sp_cfg(name)
    rows = BATCH_ROWS // shape[0]
    whole, piece = rows * seq * cfg.d_model * 4, rows * seq // shape[1] * cfg.d_model * 4
    for r in runs["ranks"][shape]:
        log = r[f"sp/{name}/grads"]["collectives"]
        inside = [(op, n) for op, n, entry in log if not entry]
        assert ("all-gather", whole) in inside and ("reduce-scatter", piece) in inside
        assert all(n < piece for op, n, _ in log if op == "all-reduce"), log


# ---------------------------------------------------------------------------
# At rest
# ---------------------------------------------------------------------------

def _flat(tree) -> dict:
    out = {}
    shd.map_with_paths(lambda path, spec: out.__setitem__(path, json.loads(json.dumps(spec))),
                       tree)
    return out


@functools.lru_cache(maxsize=None)
def _full_shapes(name: str):
    """A config's params and ``decode_32k`` caches as meta tensors."""
    cfg = get_config(name)
    return shapes.param_shapes(cfg), shapes.cache_specs(cfg, shapes.SHAPES["decode_32k"])


@pytest.mark.parametrize("mname", sorted(REST_MESHES))
@pytest.mark.parametrize("name", NON_PAPER)
def test_non_paper_configs_rest_as_jax_places_them(runs, name, mname):
    """Every non-paper config's at-rest specs at full shape (meta tensors)
    are JAX's ``param_specs`` leaf for leaf, the MoE experts included in
    every schedule (over "model" where the expert count divides it, else
    the ``ff_moe`` columns: mixtral's 8 experts on the 16-wide ``prod``
    axis), and JAX's ``cache_specs``; the startup's replicated dims are
    JAX's ``describe_replications``."""
    want = runs["ref"][f"rest/{name}/{mname}"]
    cfg = get_config(name)
    mesh = mesh_lib.Mesh(REST_MESHES[mname])
    params, caches = _full_shapes(name)
    rank_tree = fs.rank_specs(cfg, shd.param_specs(params, mesh), mesh)
    rank = _flat(rank_tree)
    assert _flat(fs.rank_cache_specs(cfg, caches, mesh)) == want["cache"]
    assert sorted(rank) == sorted(want["param"])
    for path, spec in want["param"].items():
        assert rank[path] == spec, path
    assert shd.describe_replications(params, rank_tree) == want["repl"]
    if cfg.moe:
        layout = fs.moe_layout(cfg, mesh)
        e_up = rank["layers/moe/e_up"]
        assert layout == ("experts" if cfg.n_experts % REST_MESHES[mname]["model"] == 0
                          else "ff")
        assert e_up[1 if layout == "experts" else 3] == "model"


# ---------------------------------------------------------------------------
# B5's log-sum-exp form
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("k", [2, 4])
def test_gqa_decode_lse_shards_combine_to_the_whole_cache(k, dtype):
    """A cache cut into k slot shards, some of them empty for some lanes
    (lengths 1, 5, 20 and 32 of 32 slots): each shard's call with its local
    lengths (0 where it holds no valid row: a zero output, an lse of -inf)
    combined by log-sum-exp equals the whole-cache call within 1e-6 (fp32;
    in bf16 within BF16_TOL, two roundings of outputs below 4), and the
    whole cache's lse is the shards' logsumexp."""
    rng = np.random.default_rng(7)
    Bz, Hq, Hkv, Dh, S = 4, 6, 2, 16, 32
    q, kc, vc = (torch.tensor(rng.standard_normal(s).astype(np.float32)).to(dtype)
                 for s in ((Bz, Hq, Dh), (Bz, S, Hkv, Dh), (Bz, S, Hkv, Dh)))
    lengths = torch.tensor([1, 5, 20, 32], dtype=torch.int32)
    out, lse = gqa_decode(q, kc, vc, lengths, return_lse=True)
    tol = 1e-6 if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(out, gqa_decode(q, kc, vc, lengths), rtol=0, atol=tol)
    s = S // k
    parts = []
    for j in range(k):
        local = torch.clamp(lengths - j * s, 0, s).to(torch.int32)
        o_j, lse_j = gqa_decode(q, kc[:, j * s:(j + 1) * s].contiguous(),
                                vc[:, j * s:(j + 1) * s].contiguous(), local, return_lse=True)
        empty = local == 0
        assert torch.all(o_j[empty] == 0) and torch.all(torch.isneginf(lse_j[empty]))
        assert bool(torch.isfinite(lse_j[~empty]).all())
        parts.append((o_j, lse_j))
    lses = torch.stack([p[1] for p in parts])
    m = lses.max(dim=0).values
    w = torch.exp(lses - m)
    num = sum(p[0].float() * wj[..., None] for p, wj in zip(parts, w))
    combined = num / w.sum(dim=0)[..., None]
    torch.testing.assert_close(combined, out.float(), rtol=0, atol=tol)
    torch.testing.assert_close(torch.logsumexp(lses, dim=0), lse, rtol=0, atol=1e-6)
