"""The port's dry run (``repro_torch/launch/dryrun.py``) against JAX's
(``repro/launch/dryrun.py``) on the production meshes, the virtual rank
against a live one, FSDP-sharded weights in the serving steps, and the
kernels' meta branches.

Two sides run at once:

* JAX, in four subprocesses that import ``repro.launch.dryrun`` (so 512
  virtual CPU devices) and call its ``run_train_cell`` /
  ``run_prefill_cell`` / ``run_decode_cell`` on ``jax.make_mesh`` meshes of
  the production shapes (16, 16) and (2, 16, 16) built with
  ``axis_types=(AxisType.Auto,) * 2`` (under jax 0.9 the dry run's own
  ``make_production_mesh`` builds Explicit axes, which its steps refuse),
  and read ``NamedSharding.shard_shape`` of every input;
* the port: the same cells on a virtual rank, on meta tensors, in this
  process; and one spawn of four gloo ranks on a (2, 2) CPU mesh.

The cases: ``smollm-360m``, ``llama3-8b`` (FSDP), ``mixtral-8x22b`` (8
experts on 16 ranks: the ``ff_moe`` columns), ``qwen3-moe-235b-a22b``
(``shard_map``), ``mamba2-2.7b`` (its decode at batch 1, which the data
axis does not divide), ``zamba2-7b`` (6 layers: one shared block) and
``internvl2-2b``, at full width and 2 layers (2 microbatches), in train,
prefill and decode
on (16, 16); ``llama3-8b`` decode and train on (2, 16, 16). The shapes are
cut in length and batch (``SHAPES``): JAX compiles in seconds whatever the
length, the port's meta run walks every attention block of it. Sequence
parallelism: ``nemotron-4-340b`` (``sequence_parallel=True``) train at the
``train_4k`` shape on (16, 16), at 2 and 6 layers (``SP_LAYERS``).
"""
from __future__ import annotations

import json
import math
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

from repro_torch.configs import shapes as shp
from repro_torch.configs.registry import get_config
from repro_torch.distribution import sharding as shd
from repro_torch.kernels.common import recorded_kernel_calls
from repro_torch.kernels.fused_rnn import fused_rnn, stacked
from repro_torch.kernels.gqa_decode import gqa_decode as gqa_kernel
from repro_torch.kernels.gqa_decode.ops import gqa_decode
from repro_torch.kernels.linear_scan import linear_scan as ls_kernel
from repro_torch.kernels.ssd import ssd as ssd_kernel
from repro_torch.kernels.ssd.ops import ssd
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import lm
from repro_torch.training import steps
from repro_torch.tree import flatten_with_paths

REPO = Path(__file__).resolve().parents[1]
ARCHS = ("smollm-360m", "llama3-8b", "mixtral-8x22b", "qwen3-moe-235b-a22b", "mamba2-2.7b",
         "zamba2-7b", "internvl2-2b")
LAYERS = {"zamba2-7b": 6}
MICROBATCHES = 2  # of 64 rows: 4 a data rank on (16, 16), 2 on (2, 16, 16)
# (kind, seq_len, global_batch); mamba2's decode: one lane, as long_500k.
SHAPES = {"train": (256, 128), "prefill": (1024, 32), "decode": (1024, 32)}
ONE_LANE = {("mamba2-2.7b", "decode")}
CASES = tuple((a, k, "pod") for a in ARCHS for k in ("train", "prefill", "decode")) + (
    ("llama3-8b", "decode", "multipod"), ("llama3-8b", "train", "multipod"))
MESH_SHAPES = {"pod": (16, 16), "multipod": (2, 16, 16)}
# The probes' FLOPs, the port's over JAX's cost_analysis, by probe kind.
# The port counts the matmul FLOPs of torch.utils.flop_counter and the
# kernels' operations; XLA also counts elementwise ops (norms, RoPE,
# softmax, activations, casts) and partitions by its own choice, which
# bounds the serving probes from above (decode llama3 0.65, mixtral 0.88,
# mamba2 0.82; prefill 0.99) but for Mamba's prefill, where B4's formula
# counts its chunked algorithm at the kernel's 64-step chunks and XLA the
# model's own chunking (mamba2 1.018, zamba2 1.044). The train blocks run under remat="block":
# the port's backward recomputes the block's forward (4/3 of the FLOPs),
# where XLA's probe counts it once; without remat the port is 1.085 of
# XLA at llama3. The train head is JAX's within 1% (qwen3's loss_chunk
# checkpoints its chunks: a recompute, 4/3).
FLOP_RATIO = {"train/block_cost": (1.0, 1.45), "train/block_mem": (1.0, 1.45),
              "train/attn_block_cost": (1.0, 1.45), "train/head": (0.97, 1.4),
              "decode/block": (0.55, 1.01), "decode/head": (0.6, 1.01),
              "prefill/block": (0.55, 1.06)}
# A rank's temp bytes, the port's (the peak of the storages its step makes)
# over JAX's memory_analysis, each case's as measured on these cells; the
# test holds each within TEMP_ROOM of its own, so that a step that grows
# by a third fails (a count of the whole global cache is 16x-256x).
# Prefill 0.59-0.95: the port's one-device blocks of attention (each K/V
# block widened to fp32 where it is used, as JAX's kv_step does) and its
# caches made at the rank's shard size hold less than XLA's buffers.
# Decode 0.0007-0.65: the port writes the caches in place, and XLA's temp
# holds whole-cache copies of the sharded attention (the recurrent and
# hybrid caches' the most). Train 0.49-0.80: the loss reduces each rank's
# vocab columns as XLA partitions it; MoE dispatch buffers are the larger
# in XLA (mixtral, qwen3 0.49-0.51).
TEMP_RATIO = {
    "smollm-360m/train/pod": 0.7766, "smollm-360m/prefill/pod": 0.9478,
    "smollm-360m/decode/pod": 0.01151, "llama3-8b/train/pod": 0.5162,
    "llama3-8b/prefill/pod": 0.7724, "llama3-8b/decode/pod": 0.3226,
    "mixtral-8x22b/train/pod": 0.4911, "mixtral-8x22b/prefill/pod": 0.648,
    "mixtral-8x22b/decode/pod": 0.6526, "qwen3-moe-235b-a22b/train/pod": 0.5063,
    "qwen3-moe-235b-a22b/prefill/pod": 0.7951, "qwen3-moe-235b-a22b/decode/pod": 0.4946,
    "mamba2-2.7b/train/pod": 0.7278, "mamba2-2.7b/prefill/pod": 0.8659,
    "mamba2-2.7b/decode/pod": 0.004596, "zamba2-7b/train/pod": 0.799,
    "zamba2-7b/prefill/pod": 0.591, "zamba2-7b/decode/pod": 0.0007198,
    "internvl2-2b/train/pod": 0.6264, "internvl2-2b/prefill/pod": 0.6256,
    "internvl2-2b/decode/pod": 0.004172, "llama3-8b/decode/multipod": 0.3462,
    "llama3-8b/train/multipod": 0.5011}
TEMP_ROOM = (0.8, 1.25)
# Sequence parallelism: nemotron-4-340b's train step at the train_4k shape
# (4096 tokens, 4 microbatches of 4 rows a data rank) on (16, 16) at two
# depths. At the 256-token SHAPES["train"] the embedding's fp32 gradient
# sets the step's peak and hides the stream; at 4096 the peak falls in the
# blocks' backward, where each layer's saved input adds to it. Each residual
# stream slice is (4, 256, 18432) bf16, 37.7 MB a layer, as JAX's (without
# sequence parallelism the whole (4, 4096, 18432), 604 MB). The ratios of
# the port's temp bytes over JAX's, as measured: at 2 layers, and of the
# growth per added layer (the port's 167.2 MB a layer, JAX's 219.0; 3.23
# without sequence parallelism).
SP_ARCH, SP_LAYERS, SP_SHAPE = "nemotron-4-340b", (2, 6), "train_4k"
SP_TEMP_RATIO = {"2_layers": 0.5370, "per_layer": 0.7636}
# The gloo cells on (2, 2): reduced configs, FSDP on.
LIVE = {"decode": ("granite-20b", "decode", (16, 4)), "train": ("llama3-8b", "train", (16, 8))}
SERVE_GEN, SERVE_TOL = 4, 3e-5


def _cfg(arch, **over):
    return get_config(arch).with_(n_layers=LAYERS.get(arch, 2), microbatches=MICROBATCHES, **over)


def _shape(arch, kind):
    S, B = SHAPES[kind]
    if (arch, kind) in ONE_LANE:
        B = 1
    return shp.ShapeSpec(f"{kind}_{S}", kind, S, B)


JAX_SCRIPT = r"""
import json, sys
from repro.launch import dryrun as D   # first: 512 virtual devices
import jax, numpy as np
from jax.sharding import AxisType, NamedSharding
from repro.configs import shapes as shp
from repro.configs.registry import get_config
from repro.distribution import sharding as shd

def mesh(shape):
    names = ("pod", "data", "model")[-len(shape):]
    return jax.make_mesh(tuple(shape), names, axis_types=(AxisType.Auto,) * len(shape))

def path(kp):
    return "/".join(str(getattr(k, "key", getattr(k, "name", getattr(k, "idx", k)))) for k in kp)

def shards(tree, shardings):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    sh = jax.tree_util.tree_leaves(shardings, is_leaf=lambda x: isinstance(x, NamedSharding))
    return {path(p): list(s.shard_shape(x.shape)) for (p, x), s in zip(flat, sh)}

cells = json.loads(sys.argv[1])
out = {"meshes": {}}
def sp_cell(key, c):  # the sequence-parallel cells: the step's memory, the block probe's collectives
    m = mesh(c["mesh"])
    cfg = get_config(c["arch"]).with_(n_layers=c["layers"])
    shape = shp.SHAPES[c["name"]]
    res = D.run_train_cell(cfg, shape, m, False)
    coll = {}
    if c["block_probe"]:
        cost = cfg.with_(attn_chunk=max(cfg.attn_chunk, shape.seq_len))
        coll = D._train_block_probe(cost, shape, m)["collectives_total"]
    out[key] = {"memory": res["full_step"]["memory"], "block_collectives": coll}
for key, c in cells.items():
    if key.startswith("sp/"):
        sp_cell(key, c)
        continue
    m = mesh(c["mesh"])
    out["meshes"][str(c["mesh"])] = np.asarray([d.id for d in m.devices.flat]).reshape(
        m.devices.shape).tolist()
    cfg = get_config(c["arch"]).with_(n_layers=c["layers"], microbatches=c["microbatches"])
    shape = shp.ShapeSpec(c["name"], c["kind"], c["seq"], c["batch"])
    probes = c["mesh"] == [16, 16]
    run = {"train": D.run_train_cell, "prefill": D.run_prefill_cell,
           "decode": D.run_decode_cell}[c["kind"]]
    res = run(cfg, shape, m, probes and c["kind"] != "train")
    if probes and c["kind"] == "train":  # JAX's train probes but block_mem (not compared)
        cost = cfg.with_(attn_chunk=max(cfg.attn_chunk, shape.seq_len))
        res["probes"] = {"block_cost": D._train_block_probe(cost, shape, m),
                         "head": D._train_head_probe(cfg, shape, m)}
        if cfg.attn_every:
            res["probes"]["attn_block_cost"] = D._train_attn_probe(cost, shape, m)
    locs = {}
    if c["kind"] == "train":
        state = D._state_structs(cfg)
        locs.update(shards(state, D._state_shardings(state, cfg, m)))
        batch = shp.train_input_specs(cfg, shape)
        locs.update({"batch/" + k: v for k, v in
                     shards(batch, shd.named_shardings(shd.batch_specs(batch, m), m)).items()})
    else:
        scfg = cfg.with_(param_dtype="bfloat16")
        params = D._param_structs(scfg)
        locs.update({"params/" + k: v for k, v in shards(
            params, shd.named_shardings(shd.param_specs(params, m, fsdp=scfg.fsdp), m)).items()})
        if c["kind"] == "decode":
            caches = shp.cache_specs(scfg, shape)
            locs.update({"caches/" + k: v for k, v in shards(
                caches, shd.named_shardings(shd.cache_specs(caches, m), m)).items()})
            tok = {"t": shp.decode_token_spec(scfg, shape)}
        else:
            tok = shp.prefill_input_specs(scfg, shape)
        locs.update({"inputs/" + k: v for k, v in
                     shards(tok, shd.named_shardings(shd.batch_specs(tok, m), m)).items()})
    out[key] = {"memory": res["full_step"]["memory"], "locals": locs,
                "probes": {k: v["cost"]["flops"] for k, v in res.get("probes", {}).items()}}
json.dump(out, open(sys.argv[2], "w"))
print("JAX-OK")
"""


def _cells(cases):
    out = {}
    for arch, kind, mk in cases:
        shape = _shape(arch, kind)
        out[f"{arch}/{kind}/{mk}"] = {"arch": arch, "kind": kind, "mesh": list(MESH_SHAPES[mk]),
                                      "layers": LAYERS.get(arch, 2), "name": shape.name,
                                      "microbatches": MICROBATCHES,
                                      "seq": shape.seq_len, "batch": shape.global_batch}
    return out


# JAX's cells in four subprocesses of about equal time (about 35 s alone on
# 8 cores: a train cell compiles three programs, 10-12 s; a serving cell
# two or three, 3 s).
_TRAIN = tuple(c for c in CASES if c[1] == "train")
_SERVE = tuple(c for c in CASES if c[1] != "train")
JAX_GROUPS = (_TRAIN[0::3], _TRAIN[1::3] + _SERVE[:3], _TRAIN[2::3] + _SERVE[3:5], _SERVE[5:])


def _sp_cells():
    """JAX's sequence-parallel cells (with the last group: about 15 s)."""
    return {f"sp/{L}": {"arch": SP_ARCH, "mesh": [16, 16], "layers": L, "name": SP_SHAPE,
                        "block_probe": L == SP_LAYERS[0]} for L in SP_LAYERS}


def _sp_cfg(layers):
    return get_config(SP_ARCH).with_(n_layers=layers)


def _port_sp():
    """The port's sequence-parallel cells on the virtual rank (0, 0): each
    depth's full step, and the 2-layer block probe (attention in one block)."""
    mesh = mesh_lib.virtual_mesh(dryrun.MESHES["pod"])
    shape = shp.SHAPES[SP_SHAPE]
    out = {L: dryrun.run_step(_sp_cfg(L), shape, mesh) for L in SP_LAYERS}
    cost = _sp_cfg(SP_LAYERS[0]).with_(attn_chunk=shape.seq_len)
    out["block"] = dryrun._train_block_probe(cost, shape, mesh, "layers")
    return out


# ---------------------------------------------------------------------------
# The live (2, 2) ranks
# ---------------------------------------------------------------------------

def _fill(gen):
    """A filler of real CPU data for ``dryrun``'s step builders: params and
    caches small normals, moments zero, the step 0, ids in the vocab, the
    cache position at half the cache, masks ones."""

    def fill(like, role):
        if role.endswith("/pos"):
            return torch.full(like.shape, 7, dtype=like.dtype)
        if role == "step" or role.startswith("moment/"):
            return torch.zeros(like.shape, dtype=like.dtype)
        if role in ("inputs/inputs", "inputs/targets", "inputs/t"):
            return torch.randint(0, 200, like.shape, generator=gen, dtype=like.dtype)
        if role == "inputs/mask":
            return torch.ones(like.shape, dtype=like.dtype)
        return (torch.randn(like.shape, generator=gen) * 0.05).to(like.dtype)

    return fill


def _live_cfg(name):
    arch, kind, _ = LIVE[name]
    return get_config(arch).reduced().with_(fsdp=True, microbatches=2)


def _live_shape(name):
    _, kind, (S, B) = LIVE[name]
    return shp.ShapeSpec(name, kind, S, B)


def _record_step(step, mesh):
    with mesh_lib.recorded_collectives(mesh) as log:
        step.fn(*step.args)
    return {"log": list(log), "shapes": {p: tuple(x.shape) for p, x in
                                         flatten_with_paths(dict(enumerate(step.args)))}}


def _greedy(cfg, mesh, specs, params, toks, max_len):
    """Prefill over the rank's rows ``toks`` of a 4-lane batch, then greedy
    decode steps: every step's logits and the tokens."""
    prefill = steps.build_prefill_step(cfg, mesh, batch=4, max_len=max_len,
                                       device="cpu", specs=specs)
    decode = steps.build_decode_step(cfg, mesh, max_len=max_len, specs=specs)
    lg, caches = prefill(params, {"inputs": toks})
    logits, tokens = [lg], []
    for _ in range(SERVE_GEN):
        tok = torch.argmax(lg[:, -1, :cfg.vocab], dim=-1)[:, None]
        tokens.append(tok)
        lg, caches = decode(params, caches, tok)
        logits.append(lg)
    return torch.stack(logits).numpy(), torch.cat(tokens, dim=1).numpy()


def _fsdp_serving(mesh):
    """Reduced llama3-8b (fp32) prefill + greedy decode on the rank's
    shards, its weights FSDP-sharded over "data" (``specs=``) and whole over
    "data": logits and tokens of both, and the all_gathers over "data"."""
    from repro_torch.models import lm

    cfg = get_config("llama3-8b").reduced().with_(fsdp=True)
    whole = lm.lm_init(torch.Generator().manual_seed(5), cfg, device="cpu")
    toks = torch.randint(0, cfg.vocab, (4, 10), generator=torch.Generator().manual_seed(6))
    toks = shd.local_shard(toks, shd.batch_specs({"t": toks}, mesh)["t"], mesh)  # its rows
    out = {}
    for fsdp in (True, False):
        specs = dryrun.serving_specs(cfg.with_(fsdp=fsdp), whole, mesh)
        params = shd.map_with_paths(lambda p, x: shd.local_shard(x, shd._at(specs, p), mesh),
                                    whole)
        with mesh_lib.recorded_collectives(mesh) as log:
            logits, tokens = _greedy(cfg, mesh, specs, params, toks, 16)
        out[fsdp] = {"logits": logits, "tokens": tokens,
                     "gathers": sum(op == "all-gather" for op, _, _ in log),
                     "elements": sum(t.numel() for _, t in flatten_with_paths(params))}
    return out


def _worker(rank, world, init_file, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world, timeout=mesh_lib.GROUP_TIMEOUT)
    try:
        mesh = mesh_lib.make_local_mesh(2, device=torch.device("cpu"))
        res = {"coords": mesh.coords}
        for name in LIVE:
            step = dryrun.STEPS[LIVE[name][1]](_live_cfg(name), _live_shape(name), mesh,
                                               fill=_fill(torch.Generator().manual_seed(rank)))
            res[name] = _record_step(step, mesh)
        res["fsdp_serving"] = _fsdp_serving(mesh)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def _port_cell(arch, kind, mk):
    cfg = _cfg(arch)
    shape = _shape(arch, kind)
    mesh = mesh_lib.virtual_mesh(dryrun.MESHES[mk])
    rec = dryrun.RUNNERS[kind](cfg, shape, mesh, mk == "pod")
    step = dryrun.STEPS[kind](cfg, shape, mesh)
    if kind == "train":
        state, batch = step.args
        locs = {p: list(x.shape) for p, x in flatten_with_paths(state)}
        bspecs = shd.batch_specs(batch, mesh)
        locs.update({f"batch/{k}": list(shd.local_shape(v.shape, bspecs[k], mesh))
                     for k, v in batch.items()})
        rows = steps._rank_rows(mesh, shape.global_batch // cfg.microbatches)
        computed = (shape.global_batch if rows is None else
                    (rows[1] - rows[0]) * cfg.microbatches)
    else:
        names = ("params", "caches", "inputs") if kind == "decode" else ("params", "inputs")
        args = step.args if kind == "prefill" else (step.args[0], step.args[1], {"t": step.args[2]})
        locs = {f"{n}/{p}": list(x.shape) for n, a in zip(names, args)
                for p, x in flatten_with_paths(a)}
        computed = None
    return {"record": rec, "locals": locs, "rows": computed}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's four subprocesses and the four gloo ranks, started at once;
    the port's virtual-rank cells meanwhile in this process."""
    tmp = tmp_path_factory.mktemp("dryrun")
    (tmp / "ref.py").write_text(textwrap.dedent(JAX_SCRIPT))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO / "src"))
    procs = []
    for i, group in enumerate(JAX_GROUPS):
        cells = _cells(group) if i < len(JAX_GROUPS) - 1 else {**_cells(group), **_sp_cells()}
        procs.append(subprocess.Popen(
            [sys.executable, str(tmp / "ref.py"), json.dumps(cells),
             str(tmp / f"j{i}.json")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    live_dir = tmp / "live"
    live_dir.mkdir()
    ctx = mp.start_processes(_worker, args=(4, str(live_dir / "rdv"), str(live_dir)), nprocs=4,
                             join=False, start_method="spawn")
    port = {f"{a}/{k}/{m}": _port_cell(a, k, m) for a, k, m in CASES}
    port["sp"] = _port_sp()
    virtual = {}
    for name in LIVE:
        for rank in range(4):
            coords = {"data": rank // 2, "model": rank % 2}
            mesh = mesh_lib.virtual_mesh({"data": 2, "model": 2}, coords)
            virtual[name, rank] = _record_step(
                dryrun.STEPS[LIVE[name][1]](_live_cfg(name), _live_shape(name), mesh), mesh)
    while not ctx.join(timeout=300):
        pass
    live = [pickle.load(open(live_dir / f"rank{r}.pkl", "rb")) for r in range(4)]
    ref = {}
    for i, p in enumerate(procs):
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0 and "JAX-OK" in out, err[-3000:]
        with open(tmp / f"j{i}.json") as f:
            ref.update(json.load(f))
    return {"port": port, "ref": ref, "live": live, "virtual": virtual}


@pytest.mark.parametrize("case", CASES, ids=lambda c: "/".join(c))
def test_local_shapes_are_jaxs(runs, case):
    """Every input of the rank's step (params, both moments and the step,
    caches, the batch or token) has the local shape JAX's
    ``NamedSharding.shard_shape`` gives on the same mesh; the train step
    holds the global batch and computes its rows of each microbatch, as
    many in all as JAX's batch shard holds."""
    key = "/".join(case)
    got, want = runs["port"][key]["locals"], runs["ref"][key]["locals"]
    assert sorted(got) == sorted(want)
    for path in want:
        assert got[path] == want[path], path
    if case[1] == "train":
        assert runs["port"][key]["rows"] == want["batch/targets"][0]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "/".join(c))
def test_argument_and_output_bytes_are_jaxs(runs, case):
    """``argument_bytes`` and ``output_bytes`` equal JAX's
    ``memory_analysis`` exactly."""
    key = "/".join(case)
    got = runs["port"][key]["record"]["full_step"]["memory"]
    want = runs["ref"][key]["memory"]
    assert got["argument_bytes"] == want["argument_bytes"]
    assert got["output_bytes"] == want["output_bytes"]
    assert got["temp_bytes"] > 0 and got["held_batch_bytes"] >= 0


@pytest.mark.parametrize("case", CASES, ids=lambda c: "/".join(c))
def test_temp_bytes_against_jax(runs, case):
    """The rank's ``temp_bytes`` (the peak of the storages its step makes)
    over JAX's ``memory_analysis`` ``temp_size_in_bytes`` on the same mesh
    within ``TEMP_ROOM`` of the case's ratio in ``TEMP_RATIO`` (its comment
    gives the ratios and their causes)."""
    key = "/".join(case)
    got = runs["port"][key]["record"]["full_step"]["memory"]["temp_bytes"]
    want = runs["ref"][key]["memory"]["temp_bytes"]
    ratio = TEMP_RATIO[key]
    assert got > 0 and want > 0
    assert TEMP_ROOM[0] * ratio <= got / want <= TEMP_ROOM[1] * ratio, (got, want, got / want)


def test_sequence_parallel_temp_per_layer_against_jax(runs):
    """nemotron-4-340b's train rank under sequence parallelism: its temp
    bytes over JAX's at 2 layers, and its growth per added layer (2 to 6)
    over JAX's, each within ``TEMP_ROOM`` of ``SP_TEMP_RATIO``: the
    residual stream between blocks is the rank's sequence slice, as JAX's
    (a whole stream a layer makes the growth 3.2x JAX's, 4.2x the ratio)."""
    temp = {L: runs["port"]["sp"][L]["memory"]["temp_bytes"] for L in SP_LAYERS}
    jax = {L: runs["ref"][f"sp/{L}"]["memory"]["temp_bytes"] for L in SP_LAYERS}
    lo, hi = SP_LAYERS
    ratios = {"2_layers": temp[lo] / jax[lo],
              "per_layer": (temp[hi] - temp[lo]) / (jax[hi] - jax[lo])}
    for name, ratio in ratios.items():
        want = SP_TEMP_RATIO[name]
        assert TEMP_ROOM[0] * want <= ratio <= TEMP_ROOM[1] * want, (name, temp, jax, ratio)
    for L in SP_LAYERS:  # the inputs JAX's: the same rank
        mem = runs["port"]["sp"][L]["memory"]
        assert mem["argument_bytes"] == runs["ref"][f"sp/{L}"]["memory"]["argument_bytes"]


def test_sequence_parallel_peak_holds_no_stream(runs):
    """At the step's peak no storage of the whole (rows, S, d) residual
    stream is live (the embedding's, a residual add's, a norm's or a
    cast's): each storage of that shape is an all-gather's output, the
    sequence gathered whole inside the block being differentiated, and as
    many at 6 layers as at 2. The slices (rows, S / 16, d) cross the
    blocks."""
    cfg, shape = _sp_cfg(2), shp.SHAPES[SP_SHAPE]
    stream = [shape.global_batch // cfg.microbatches // 16, shape.seq_len, cfg.d_model]
    whole = {}
    for L in SP_LAYERS:
        peak = runs["port"]["sp"][L]["memory"]["peak_tensors"]
        whole[L] = [t["op"] for t in peak if t["shape"] == stream]
        assert set(whole[L]) <= {"aten.cat"}, (L, peak)
    assert len(whole[SP_LAYERS[0]]) == len(whole[SP_LAYERS[1]])


def test_sequence_parallel_block_collectives_beside_jax(runs):
    """The 2-layer rank's block probe (one block forward and backward under
    remat) moves the stream by all-gathers in and reduce-scatters out, and
    no all-reduce; in all it moves no more bytes than JAX's partitioning of
    the same probe (which all-reduces)."""
    got = runs["port"]["sp"]["block"]["collectives_total"]
    want = runs["ref"][f"sp/{SP_LAYERS[0]}"]["block_collectives"]
    assert got["counts"].get("all-reduce", 0) == 0
    assert got["counts"]["reduce-scatter"] > 0 and got["counts"]["all-gather"] > 0
    ops = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")
    assert 0 < sum(got[op] for op in ops) <= sum(want[op] for op in ops), (got, want)


@pytest.mark.parametrize("arch", ["llama3-8b", "nemotron-4-340b"])
def test_init_caches_counts_only_the_local_cache(arch):
    """``steps._init_caches`` at rank (0, 0) of the pod, for the 32-lane
    32768-token caches of ``prefill_32k``, makes the rank's shards and
    nothing else: the storage tracker counts exactly the bytes of the
    caches it returns (0.537 GB for llama3-8b, 2.416 GB for nemotron-4-340b;
    the whole caches would be 137.4 and 618.5 GB)."""
    cfg = dryrun.serving_cfg(get_config(arch))
    mesh = mesh_lib.virtual_mesh(dryrun.MESHES["pod"])
    live = dryrun._LiveBytes((), 1)
    with live:
        caches = steps._init_caches(cfg, mesh, 32, 32768, "meta")
    local = sum(dryrun._nbytes(t) for t in dryrun._tensors(caches))
    assert live.peak == local
    whole = sum(math.prod(leaf.shape) * leaf.dtype.itemsize
                for leaf in _leaves(lm.lm_cache_shapes(cfg, 32, 32768)))
    assert local * 16 <= whole


def _leaves(tree):
    return [v for x in tree.values() for v in (_leaves(x) if isinstance(x, dict) else [x])]


@pytest.mark.parametrize("case", [c for c in CASES if c[2] == "pod"], ids=lambda c: "/".join(c))
def test_probe_flops_against_jax_cost_analysis(runs, case):
    """Each probe's FLOPs against XLA's ``cost_analysis`` of JAX's probe,
    within ``FLOP_RATIO`` (its comment names the gaps); JAX's train
    ``block_mem`` is not compiled here (its FLOPs are ``block_cost``'s, the
    chunking aside)."""
    key = "/".join(case)
    got = runs["port"][key]["record"]["probes"]
    want = runs["ref"][key]["probes"]
    assert sorted(got) == sorted(set(want) | ({"block_mem"} if case[1] == "train" else set()))
    for name, flops in want.items():
        lo, hi = FLOP_RATIO[f"{case[1]}/{name}"]
        assert lo <= got[name]["cost"]["flops"] / flops <= hi, (name, got[name]["cost"], flops)


@pytest.mark.parametrize("case", [c for c in CASES if c[2] == "pod"], ids=lambda c: "/".join(c))
def test_full_step_flops_are_probes_times_trips(runs, case):
    """Within the port, the full step's FLOPs are the probes' times the
    trips plus the rest, exactly: train, microbatches x (layers x block +
    shared-block applications + head + the frontend adapter's product and
    its weight grad); decode, layers x block + head + the adapter; prefill,
    layers x block + the head at the last position + the adapter. A
    hybrid's serving steps also run its shared block, which no probe
    covers (as in JAX): there the full step is larger."""
    arch, kind, _ = case
    cfg, shape = _cfg(arch), _shape(arch, kind)
    rec = runs["port"]["/".join(case)]["record"]
    full, probes, trips = rec["full_step"]["cost"]["flops"], rec["probes"], rec["trips"]
    flops = {k: v["cost"]["flops"] for k, v in probes.items()}
    layers = trips.get("layers", trips.get("layers_mamba"))
    d, V = cfg.d_model, cfg.padded_vocab
    v_local = V // 16 if V % 16 == 0 else V
    if kind == "train":
        rows = runs["port"]["/".join(case)]["rows"] // cfg.microbatches
        adapter = 2 * 2.0 * rows * shape.seq_len * d * d if cfg.frontend else 0.0
        want = trips["microbatches"] * (layers * flops["block_cost"] + trips.get("layers_attn", 0)
                                        * flops.get("attn_block_cost", 0.0)
                                        + flops["head"] + adapter)
        assert full == pytest.approx(want, rel=1e-9)
        return
    rows = shape.global_batch // 16 if shape.global_batch % 16 == 0 else shape.global_batch
    seq = 1 if kind == "decode" else shape.seq_len
    adapter = 2.0 * rows * seq * d * d if cfg.frontend else 0.0
    head = flops["head"] if kind == "decode" else 2.0 * rows * d * v_local
    want = layers * flops["block"] + head + adapter
    if trips.get("layers_attn"):
        assert full > want
    else:
        assert full == pytest.approx(want, rel=1e-9)


# Decode cells and the kernel launches their steps record: B5's lse form on
# the sequence-sharded caches (8 KV heads on 16 ranks; mixtral's 4096-slot
# window is past the 1024-slot cache), B4 on the rank's Mamba heads, B5 on
# zamba2's shared block, whose 32 KV heads divide the axis.
DECODE_KERNELS = {("llama3-8b", "multipod"): {"gqa_decode_lse": 2},
                  ("mixtral-8x22b", "pod"): {"gqa_decode_lse": 2},
                  ("mamba2-2.7b", "pod"): {"ssd": 2},
                  ("zamba2-7b", "pod"): {"ssd": 6, "gqa_decode": 1}}


@pytest.mark.parametrize("arch,mk", sorted(DECODE_KERNELS), ids=lambda v: str(v))
def test_decode_records_hold_their_kernels_and_loop_collectives(runs, arch, mk):
    """The decode steps ran their kernels' meta branches once a layer (a
    shared-block application), and the layers' collectives lie outside the
    entry computation."""
    rec = runs["port"][f"{arch}/decode/{mk}"]["record"]["full_step"]
    assert {k: v["launches"] for k, v in rec["kernels"].items()} == DECODE_KERNELS[arch, mk]
    assert 0 < rec["collectives_entry"]["count"] < rec["collectives_total"]["count"]


def test_virtual_mesh_ranks_are_jaxs(runs):
    """Each axis group of a virtual rank holds the ranks JAX's ``make_mesh``
    lays along that axis, and the data-parallel group spans ("pod",
    "data") in JAX's order."""
    for mk, shape in MESH_SHAPES.items():
        ids = np.asarray(runs["ref"]["meshes"][str(list(shape))])
        names = list(dryrun.MESHES[mk])
        for coords in ({a: 0 for a in names}, {a: n - 1 for a, n in zip(names, shape)},
                       dict(zip(names, (1, 5, 9)[-len(names):]))):
            mesh = mesh_lib.virtual_mesh(dryrun.MESHES[mk], coords)
            at = tuple(coords[a] for a in names)
            assert int(ids[at]) == sum(c * int(np.prod(shape[i + 1:]))
                                       for i, c in enumerate(at))
            for i, a in enumerate(names):
                line = [int(ids[at[:i] + (j,) + at[i + 1:]]) for j in range(shape[i])]
                assert list(mesh.axis(a).ranks) == line and mesh.axis(a).index == coords[a]
            dp = mesh.dp_group()
            want = ids[..., coords["model"]].reshape(-1).tolist()
            assert list(dp.ranks) == [int(x) for x in want]


@pytest.mark.parametrize("name", sorted(LIVE))
def test_virtual_rank_records_a_live_ranks_collectives(runs, name):
    """On a (2, 2) gloo CPU mesh, each of the four ranks of the reduced
    decode (granite-20b: the sequence-sharded KV cache) and train
    (llama3-8b, 2 microbatches) cells with FSDP records the collectives
    (op, result bytes, entry or loop) in the order the virtual rank at its
    coordinates records them on meta, and holds the same local shapes."""
    for rank, live in enumerate(runs["live"]):
        virt = runs["virtual"][name, rank]
        assert live[name]["shapes"] == virt["shapes"]
        assert live[name]["log"] == virt["log"]
        assert live[name]["log"]


def test_fsdp_serving_gives_the_whole_weights_tokens(runs):
    """``build_prefill_step`` / ``build_decode_step`` with ``specs=``
    holding FSDP-sharded weights (gathered a layer at a time over "data")
    give, on the live (2, 2) ranks, the tokens and logits (within 3e-5) of
    the same steps on weights whole over "data", and hold fewer weight
    elements a rank."""
    for live in runs["live"]:
        got, want = live["fsdp_serving"][True], live["fsdp_serving"][False]
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        np.testing.assert_allclose(got["logits"], want["logits"], rtol=0, atol=SERVE_TOL)
        assert got["gathers"] > want["gathers"]
        assert got["elements"] < want["elements"]


def test_shape_memo_changes_no_record(monkeypatch):
    """The storage tracker's shape memo (an op met again with operands of
    the same metadata makes its results without its meta kernel) leaves
    every number of a record as the plain meta run gives it: a reduced
    train cell with FSDP and a prefill cell with a hybrid's shared block."""
    mesh = mesh_lib.virtual_mesh({"data": 2, "model": 2})
    cells = ((get_config("llama3-8b").reduced().with_(fsdp=True, microbatches=2),
              shp.ShapeSpec("t", "train", 16, 8)),
             (get_config("zamba2-7b").reduced(), shp.ShapeSpec("p", "prefill", 64, 4)))

    def drop_wall(r):
        return {k: drop_wall(v) for k, v in r.items() if k != "wall_s"} if isinstance(r, dict) \
            else r

    for cfg, shape in cells:
        memo = drop_wall(dryrun.RUNNERS[shape.kind](cfg, shape, mesh, True))
        with monkeypatch.context() as m:
            m.setattr(dryrun._LiveBytes, "_call",
                      lambda self, func, args, kwargs, operands: func(*args, **kwargs))
            plain = drop_wall(dryrun.RUNNERS[shape.kind](cfg, shape, mesh, True))
        assert memo == plain


def test_rank_classes_from_the_specs():
    """Every rank of both production meshes holds rank 0's local shapes in
    the assigned cells (the specs shard a dim only where it divides), so one
    rank runs for all of them: checked from the specs alone."""
    for mk, n in (("pod", 256), ("multipod", 512)):
        for arch, kind in (("llama3-8b", "decode_32k"), ("mamba2-2.7b", "long_500k")):
            classes = dryrun.rank_classes(get_config(arch), shp.SHAPES[kind],
                                          dryrun.MESHES[mk])
            assert len(classes) == 1 and classes[0][1] == n
            assert set(classes[0][0].values()) == {0}


def test_all_records_statuses_follow_applicability(tmp_path, monkeypatch):
    """``--all --no-probes`` with the step runners stubbed (the specs alone:
    every rank's local shapes still computed) writes the 80 records with
    JAX's keys, each cell's ``status`` what JAX's ``applicability`` says:
    ``ok`` or its ``skip(...)``."""
    from repro.configs import shapes as jax_shapes
    from repro.configs.registry import get_config as jax_config

    monkeypatch.setattr(dryrun, "RUNNERS", {k: (lambda cfg, shape, mesh, probes: {})
                                            for k in dryrun.RUNNERS})
    assert dryrun.main(["--all", "--no-probes", "--out", str(tmp_path)]) == 0
    files = sorted(tmp_path.iterdir())
    assert len(files) == 80
    for f in files:
        rec = json.loads(f.read_text())
        skip = jax_shapes.applicability(jax_config(rec["arch"]), jax_shapes.SHAPES[rec["shape"]])
        assert rec["status"] == (skip or "ok"), f.name
        assert {"arch", "shape", "mesh", "params", "active_params", "wall_s"} <= set(rec)
        if skip is None:
            assert rec["ranks"]["checked"] == (256 if rec["mesh"] == "pod" else 512)


# ---------------------------------------------------------------------------
# The kernels' meta branches
# ---------------------------------------------------------------------------

def _pair(make):
    """The same operands on the CPU (random) and on meta."""
    cpu = make(lambda *s, dtype=torch.float32: torch.randn(s).to(dtype))
    meta = [None if t is None else
            (t.to("meta") if isinstance(t, torch.Tensor) else tuple(x.to("meta") for x in t))
            for t in cpu]
    return cpu, meta


def _same_layout(a, b):
    for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
        if x is None:
            assert y is None
            continue
        assert y.device.type == "meta" and x.shape == y.shape and x.dtype == y.dtype


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("lse", [False, True], ids=["out", "lse"])
def test_gqa_decode_meta_branch(dtype, lse):
    """B5 (and its lse form) on meta: the plain version's output shapes and
    dtypes; the recorded call's operations (q.k and p.v over every slot)
    and bytes (K, V rows, q, out, lengths) by hand."""
    B, Hq, Hkv, Dh, S = 2, 8, 2, 16, 40
    q, k, v = (torch.randn(s).to(dtype) for s in ((B, Hq, Dh), (B, S, Hkv, Dh), (B, S, Hkv, Dh)))
    lens = torch.tensor([40, 7], dtype=torch.int32)
    plain = gqa_decode(q, k, v, lens, return_lse=lse)
    with recorded_kernel_calls() as calls:
        got = gqa_decode(*(t.to("meta") for t in (q, k, v, lens)), return_lse=lse)
    _same_layout(plain, got)
    e = torch.finfo(dtype).bits // 8
    n_split, _, blocks = gqa_kernel.plan(dtype, B, Hkv, S, Dh, Hq // Hkv, meta=True)
    inst = gqa_kernel.meta_instance(dtype, Dh, Hq // Hkv, (n_split, Hkv * blocks, B))
    assert inst["kernel"].startswith("gqa_decode_mma" if dtype == torch.bfloat16 else
                                     "gqa_decode_split")
    assert calls == [{"name": "gqa_decode_lse" if lse else "gqa_decode", "launches": 1,
                      "ops": 2 * 2 * (B * S) * Hq * Dh,
                      "bytes": 2 * (B * S) * Hkv * Dh * e + 2 * B * Hq * Dh * e + 4 * B,
                      "dtype": str(dtype)[6:], "instance": inst}]


def test_gqa_decode_meta_allocates_the_wrappers_partials():
    """B5's meta branch plans its splits on the H100 model and makes the
    partials the wrapper makes: at the llama3-8b serve shape (6 splits of
    192 rows, as the card reported) its peak live bytes are the output, the
    partials and a block of launch words."""
    from repro_torch.launch.dryrun import _LiveBytes

    B, Hq, Hkv, Dh, S = 4, 32, 8, 128, 1056
    assert gqa_kernel.plan(torch.bfloat16, B, Hkv, S, Dh, 4, meta=True) == (6, 192, 1)
    args = [torch.empty(s, dtype=torch.bfloat16, device="meta")
            for s in ((B, Hq, Dh), (B, S, Hkv, Dh), (B, S, Hkv, Dh))]
    args.append(torch.empty(B, dtype=torch.int32, device="meta"))
    live = _LiveBytes(args)
    with live:
        gqa_decode(*args)
    out = B * Hq * Dh * 2
    parts = B * Hkv * 6 * 4 * (2 + Dh) * 4
    assert live.peak == out + parts + 1024 * 4


@pytest.mark.parametrize("S", [1, 100], ids=["step", "chunk"])
def test_ssd_meta_branch(S):
    """B4 on meta: the plain version's shapes and dtypes (the state written
    into ``state_out`` in place); operations by the chunked formula and
    bytes (every operand read, y and the fp32 state written) by hand."""
    Bsz, H, P, N, G = 2, 4, 8, 16, 1

    def make(r):
        return (r(Bsz, S, H, P, dtype=torch.bfloat16), torch.rand(Bsz, S, H), -torch.rand(H),
                r(Bsz, S, G, N, dtype=torch.bfloat16), r(Bsz, S, G, N, dtype=torch.bfloat16),
                torch.ones(H), torch.zeros(Bsz, H, N, P))

    cpu, meta = _pair(make)
    plain = ssd(*cpu[:6], initial_state=cpu[6], state_out=cpu[6], chunk=64)
    with recorded_kernel_calls() as calls:
        got = ssd(*meta[:6], initial_state=meta[6], state_out=meta[6], chunk=64)
    _same_layout(plain, got)
    assert got[1] is meta[6]
    if S == 1:
        ops = Bsz * H * 4.0 * N * P
    else:
        tri = [L * (L + 1) / 2 for L in (64, 36)]
        ops = Bsz * H * sum(2.0 * (t * N + t * P + 2 * L * N * P) for t, L in zip(tri, (64, 36)))
    rw = (2 * Bsz * S * H * P * 2 + Bsz * S * H * 4 + 2 * H * 4 + 2 * Bsz * S * G * N * 2
          + 2 * Bsz * H * N * P * 4)
    inst = ssd_kernel.meta_instance(torch.bfloat16, torch.bfloat16, Bsz, S, H, G, P, N)
    assert inst["kernel"] == ("ssd_step_vec_kernel<bf16,bf16>" if S == 1 else
                              "ssd_chunk_mma_kernel")
    assert calls == [{"name": "ssd", "launches": 1, "ops": ops, "bytes": rw,
                      "dtype": "bfloat16", "instance": inst}]


@pytest.mark.parametrize("T", [1, 200], ids=["one_chunk", "chunks"])
def test_linear_scan_meta_branches(T):
    """B3 forward and backward on meta: the plain versions' shapes and
    dtypes; 2 operations an element forward, 3 backward; the operands read
    and results written once."""
    F = 48
    cpu, meta = _pair(lambda r: (r(T, F), r(T, F), r(F)))
    with recorded_kernel_calls() as calls:
        c_meta = ls_kernel.linear_scan_kernel(*meta)
        grads = ls_kernel.linear_scan_bwd(meta[0], c_meta, meta[2], meta[1])
    c = ls_kernel.linear_scan_kernel(*cpu)
    _same_layout(c, c_meta)
    _same_layout(ls_kernel.linear_scan_bwd(cpu[0], c, cpu[2], cpu[1]), grads)
    assert calls == [
        {"name": "linear_scan", "launches": 1, "ops": 2.0 * T * F, "bytes": (3 * T * F + F) * 4,
         "dtype": "float32", "instance": ls_kernel.meta_instance(T, F, torch.float32)},
        {"name": "linear_scan", "launches": 1, "ops": 3.0 * T * F,
         "bytes": (3 * T * F + F) * 4 + (2 * T * F + F) * 4, "dtype": "float32",
         "instance": ls_kernel.meta_instance(T, F, torch.float32, backward=True)}]


@pytest.mark.parametrize("mode", ["sru_identity", "qrnn", "sru_proj"])
def test_fused_rnn_layer_meta_branch(mode):
    """B1 on meta: the plain version's shapes and dtypes; the gate GEMM's
    operations (and sru_proj's highway GEMM) and every operand and output's
    bytes."""
    T, B, d, H = 5, 3, 16, 16 if mode != "sru_proj" else 12
    n = 2 if mode == "qrnn" else 1

    def make(r):
        taps = tuple(r(d, 3, H) for _ in range(n))
        return (r(T, B, d), taps, r(3, H), r(B, H), r(1, B, d) if mode == "qrnn" else None,
                r(d, H) if mode == "sru_proj" else None)

    cpu, meta = _pair(make)
    kw = lambda a: {"mode": mode, "tail": a[4], "wskip": a[5]}
    plain = fused_rnn.fused_rnn_layer(*cpu[:4], **kw(cpu))
    with recorded_kernel_calls() as calls:
        got = fused_rnn.fused_rnn_layer(*meta[:4], **kw(meta))
    _same_layout(plain, got)
    ops = 2.0 * T * B * d * n * 3 * H + (2.0 * T * B * d * H if mode == "sru_proj" else 0)
    rw = 4 * (T * B * d + n * d * 3 * H + 3 * H + B * H + (B * d if mode == "qrnn" else 0)
              + (d * H if mode == "sru_proj" else 0) + T * B * H + B * H)
    inst = fused_rnn.meta_instance(T, B, d, H, io_dtype=torch.float32, w_dtype=torch.float32,
                                   ng=4 if mode == "sru_proj" else 3, taps=n)
    assert inst["kernel"] == f"fused_rnn_layer_kernel<float,float,{4 if mode == 'sru_proj' else 3}>"
    assert calls == [{"name": "fused_rnn_layer", "launches": 1, "ops": ops, "bytes": rw,
                      "dtype": "float32", "instance": inst}]


@pytest.mark.parametrize("cell", ["sru", "qrnn"])
def test_fused_rnn_stack_meta_branch(cell):
    """B2 on meta: the plain version's shapes and dtypes, L launches, the
    L layers' gate GEMMs and every operand and output's bytes."""
    T, B, H, L = 4, 2, 16, 3
    n = 2 if cell == "qrnn" else 1
    cpu, meta = _pair(lambda r: (r(T, B, H), tuple(r(L, H, 3, H) for _ in range(n)), r(L, 3, H),
                                 r(L, H), r(L, B, H), r(L, B, H) if cell == "qrnn" else None))
    plain = stacked.fused_rnn_stack(*cpu)
    with recorded_kernel_calls() as calls:
        got = stacked.fused_rnn_stack(*meta)
    _same_layout(plain, got)
    tails = L * B * H if cell == "qrnn" else 0
    rw = 4 * (T * B * H + n * L * H * 3 * H + L * 3 * H + L * H + L * B * H + tails
              + T * B * H + L * B * H + tails)
    inst = fused_rnn.meta_instance(T, B, H, H, io_dtype=torch.float32, w_dtype=torch.float32,
                                   stack=True, taps=n)
    assert calls == [{"name": "fused_rnn_stack", "launches": L,
                      "ops": 2.0 * L * T * B * n * H * 3 * H, "bytes": rw, "dtype": "float32",
                      "instance": inst}]


def test_cuda_wrappers_still_refuse_other_devices():
    """The meta branch is no fallback: the CUDA wrappers refuse CPU and meta
    tensors, as before."""
    q = torch.zeros(1, 2, 8)
    k = torch.zeros(1, 4, 1, 8)
    lens = torch.ones(1, dtype=torch.int32)
    for dev in ("cpu", "meta"):
        with pytest.raises(ValueError, match="CUDA tensors"):
            gqa_kernel.gqa_decode_cuda(q.to(dev), k.to(dev), k.to(dev), lens.to(dev))
        with pytest.raises(ValueError, match="CUDA tensors"):
            ssd_kernel.ssd_cuda(*(torch.zeros(1, 2, 1, 8, device=dev),) * 1,
                                torch.zeros(1, 2, 1, device=dev), torch.zeros(1, device=dev),
                                torch.zeros(1, 2, 1, 8, device=dev),
                                torch.zeros(1, 2, 1, 8, device=dev), None, None,
                                torch.zeros(1, 2, 1, 8, device=dev),
                                torch.zeros(1, 1, 8, 8, device=dev))
    with pytest.raises(ValueError, match="meta tensors"):
        gqa_kernel.gqa_decode_meta(q, k, k, lens)
