"""Tensor parallelism of the paper RNNs' own engines, the LSTM and the vocab
leaves (``distribution/tensor_parallel.py``, and the at-rest layout of
``fused_sharded.rank_specs`` / ``rank_cache_specs`` it runs on) against
JAX's sharded functions, where GSPMD partitions the same leaves.

The inputs (whole LM params from the port's ``lm_init``, prompts and train
batches) are made once here from a seed and written to a pickle. Two sides
then run at once on them:

* JAX, in one subprocess with 8 virtual CPU devices, on meshes built with
  ``axis_types=(AxisType.Auto,) * 2`` (jax 0.9's ``make_mesh`` gives
  Explicit axes, which the reference's sharded steps refuse): the params
  placed by ``param_specs``, then its jitted ``build_prefill_step`` and
  ``build_decode_step`` on (2, 2) (a prefill and GEN greedy decode steps),
  and ``jax.grad`` of ``lm_loss`` under ``use_rules`` on (1, 2);
* the port, in one ``torch.multiprocessing`` spawn of gloo ranks per mesh
  shape, (1, 2) and (2, 2), each rank on its shards (``serve.shard_params``,
  ``steps.train_param_specs``). The (1, 2) ranks also serve the LSTM
  through ``serve.main`` joined to their group, run one continuous
  speculative serve with the default draft, take one sharded train step
  and save it from their shards, and run the train step's grads under
  ``pallas`` (B3's plain version on the CPU).

A ``serve --model-shards 2`` subprocess runs beside them. Tolerances are the
reference's: logits 3e-5 with greedy tokens equal under fp32, grads 5e-4
(absolute and relative), params after a step 5e-4.
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
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.registry import get_config
from repro_torch.core import mts
from repro_torch.distribution import fused_sharded as fs
from repro_torch.distribution import sharding as shd
from repro_torch.distribution import tensor_parallel as tp
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.training import steps
from repro_torch.training.steps import build_decode_step, build_prefill_step
from repro_torch.tree import flatten_with_paths, tree_leaves

REPO = Path(__file__).resolve().parents[1]
MESHES = ((1, 2), (2, 2))
B, S0, GEN = 4, 12, 4
# (arch, engine): every reduced config's own engine unless named; smollm's
# head is tied to its embedding, the paper configs' is not.
SERVE_CASES = (("sru-paper-large", "chunked"), ("sru-paper-large", "sequential"),
               ("sru-paper-large", "associative"), ("qrnn-paper-large", "chunked"),
               ("lstm-paper-large", None), ("smollm-360m", None))
GRAD_CASES = (("sru-paper-large", "chunked"), ("lstm-paper-large", None), ("smollm-360m", None))
LOGIT_TOL, GRAD_TOL, PARAM_TOL = 3e-5, 5e-4, 5e-4
BATCH_ROWS, BATCH_SEQ = 4, 16
CLI_ARCH = "sru-paper-large"
JOINED_ARGV = ["--arch", "lstm-paper-large", "--reduced", "--device", "cpu", "--batch", "4",
               "--prompt-len", "12", "--gen-len", "6", "--model-shards", "2"]
CONT_ARGV = ["--arch", "sru-paper-large", "--reduced", "--device", "cpu", "--mode", "continuous",
             "--requests", "6", "--batch", "2", "--prompt-len", "12", "--gen-len", "8",
             "--chunk", "8", "--speculative"]
ELASTIC_ARCH = "sru-paper-large"


def _cfg(arch, engine=None):
    cfg = get_config(arch).reduced()
    return cfg if engine is None else cfg.with_(scan_engine=engine)


def _key(kind, arch, engine):
    return f"{kind}/{arch}/{engine}"


def _batch(rng, cfg) -> dict:
    mask = np.ones((BATCH_ROWS, BATCH_SEQ), np.float32)
    mask[1, 9:] = 0  # a ragged row
    return {"inputs": rng.integers(0, cfg.vocab, (BATCH_ROWS, BATCH_SEQ)).astype(np.int32),
            "targets": rng.integers(0, cfg.vocab, (BATCH_ROWS, BATCH_SEQ)).astype(np.int32),
            "mask": mask}


def _make_inputs() -> dict:
    rng = np.random.default_rng(0)
    cases = {}
    for arch, engine in SERVE_CASES:
        cfg = _cfg(arch, engine)
        cases[_key("serve", arch, engine)] = {
            "params": bridge.params_to_numpy(lm.lm_init(torch.Generator().manual_seed(0), cfg,
                                                        device="cpu")),
            "tokens": rng.integers(0, cfg.vocab, (B, S0)).astype(np.int32)}
    for arch, engine in GRAD_CASES:
        cfg = _cfg(arch, engine)
        cases[_key("grads", arch, engine)] = {
            "params": bridge.params_to_numpy(lm.lm_init(torch.Generator().manual_seed(1), cfg,
                                                        device="cpu")),
            "batch": _batch(rng, cfg)}
    def normal(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    d, H = 48, 64  # an SRU layer with a skip projection (d != H)
    cases["layer"] = {"params": {"w": normal(d, 3, H, scale=d ** -.5), "b": normal(2, H, scale=.1),
                                 "w_skip": normal(d, H, scale=d ** -.5)},
                      "x": normal(B, S0, d), "c0": normal(B, H), "g": normal(B, S0, H)}
    cases["elastic"] = {"batch": _batch(rng, _cfg(ELASTIC_ARCH))}
    return cases


JAX_SCRIPT = r"""
import pickle, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs.registry import get_config
from repro.distribution import sharding as shd
from repro.distribution.sharding import use_rules
from repro.models.lm import lm_loss
from repro.training.steps import build_decode_step, build_prefill_step

cases = pickle.load(open(sys.argv[1], "rb"))
def mesh(shape):
    n = shape[0] * shape[1]
    return jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:n])
M22, M12 = mesh((2, 2)), mesh((1, 2))
tree = lambda p: jax.tree_util.tree_map(jnp.asarray, p)
def placed(params, m):
    return jax.device_put(params, shd.named_shardings(shd.param_specs(params, m), m))
def config(arch, engine):
    cfg = get_config(arch).reduced()
    return cfg if engine == "None" else cfg.with_(scan_engine=engine)
out = {}
for key, c in cases.items():
    kind, *rest = key.split("/")
    if kind == "serve":
        cfg = config(*rest)
        psh = placed(tree(c["params"]), M22)
        toks = c["tokens"]
        prefill = jax.jit(build_prefill_step(cfg, M22, batch=toks.shape[0],
                                             max_len=toks.shape[1] + %(GEN)d))
        decode = jax.jit(build_decode_step(cfg, M22))
        lg, caches = prefill(psh, {"inputs": toks})
        logits, greedy = [np.asarray(lg)], []
        for _ in range(%(GEN)d):
            tok = jnp.argmax(lg[:, -1, :cfg.vocab], axis=-1)[:, None].astype(jnp.int32)
            greedy.append(np.asarray(tok))
            lg, caches = decode(psh, caches, tok)
            logits.append(np.asarray(lg))
        out[key] = {"logits": np.stack(logits), "tokens": np.concatenate(greedy, axis=1)}
    elif kind == "grads":
        cfg = config(*rest)
        psh = placed(tree(c["params"]), M12)
        with use_rules(M12):
            loss, g = jax.jit(jax.value_and_grad(lambda p, b: lm_loss(p, cfg, b)[0]))(
                psh, tree(c["batch"]))
        out[key] = {"loss": float(loss),
                    "grads": {shd._path_str(p): np.asarray(v) for p, v in
                              jax.tree_util.tree_flatten_with_path(g)[0]}}
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
    prefill = build_prefill_step(cfg, mesh, batch=B, max_len=S0 + GEN, device="cpu")
    decode = build_decode_step(cfg, mesh)
    lg, caches = prefill(params, {"inputs": toks})
    logits, greedy = [lg.numpy()], []
    for _ in range(GEN):
        tok = torch.argmax(lg[:, -1, :cfg.vocab], dim=-1)[:, None]
        greedy.append(tok.numpy())
        lg, caches = decode(params, caches, tok)
        logits.append(lg.numpy())
    c = caches["layers"].get("c")
    return {"logits": np.stack(logits), "tokens": np.concatenate(greedy, axis=1),
            "c": None if c is None else c.numpy()}


def _grads_case(cfg, c, mesh):
    """The train step's loss and grads (``steps.step_grads``) on this rank's
    shards, each grad made whole over the mesh."""
    specs = steps.train_param_specs(cfg, mesh)
    whole = _whole(c["params"])
    params = shd.map_with_paths(lambda p, x: shd.local_shard(x, shd._at(specs, p), mesh), whole)
    batch = {k: torch.tensor(v) for k, v in c["batch"].items()}
    loss, grads = steps.step_grads(cfg, params, batch, mesh, specs)
    return {"loss": float(loss),
            "grads": {path: shd.gather_shard(g, s, mesh).numpy() for (path, g), s in
                      zip(flatten_with_paths(grads), tree_leaves(specs))},
            "held": {path: tuple(x.shape) for path, x in flatten_with_paths(params)}}


def _layer_case(c, mesh):
    """One SRU layer with a skip projection under ``chunked`` on this
    rank's lanes: the output and the grads of sum(h * g), made whole."""
    group = mesh.axis("model")
    spec = {"w": (None, None, "model"), "b": (None, "model"), "w_skip": (None, "model")}
    p = {k: shd.local_shard(torch.tensor(v), spec[k], mesh).requires_grad_()
         for k, v in c["params"].items()}
    x = torch.tensor(c["x"]).requires_grad_()
    c0 = shd.local_shard(torch.tensor(c["c0"]), (None, "model"), mesh)
    h, c_last = mts.mts_sru(p, x, c0, engine="chunked", block_size=4, mesh=mesh)
    g = torch.autograd.grad(torch.sum(h * torch.tensor(c["g"])), [*p.values(), x])
    out = {k: group.all_gather(gk).numpy() for k, gk in zip(p, g)}  # lanes last
    return {"h": h.detach().numpy(), "c": group.all_gather(c_last.detach()).numpy(),
            "grads": {**out, "x": g[-1].numpy()}}


def _elastic_save(mesh, c, root):
    """One train step of ELASTIC_ARCH on this rank's shards, saved from
    them; returns the at-rest shapes of the vocab and slab leaves."""
    cfg = _cfg(ELASTIC_ARCH)
    specs = steps.train_param_specs(cfg, mesh)
    sspecs = steps.train_state_specs(specs)
    state = steps.shard_train_state(
        steps.init_train_state(torch.Generator().manual_seed(3), cfg, device="cpu"), sspecs, mesh)
    step = steps.build_train_step(cfg, mesh, total_steps=5, specs=specs)
    state, _ = step(state, {k: torch.tensor(v) for k, v in c["batch"].items()})
    CheckpointManager(str(root)).save(1, state, shardings=(mesh, sspecs))
    return {"embed": tuple(state.params["embed"]["embed"].shape),
            "w": tuple(state.params["layers"]["cell"]["w"].shape)}


def _frontend_rows(mesh) -> bool:
    """``serve.step_input`` of a frontend stub on this rank's vocab block:
    each token's embedding row, bit for bit the whole table's (the first and
    last padded ids, one from each rank's block)."""
    cfg = _cfg("internvl2-2b")
    whole = lm.lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    params, _ = serve.shard_params(cfg, whole, mesh)
    tok = torch.tensor([[0], [cfg.padded_vocab - 1], [5], [cfg.padded_vocab // 2]])
    return torch.equal(serve.step_input(cfg, params, tok, mesh), whole["embed"]["embed"][tok])


def _capture(argv) -> str:
    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert serve.main(argv) == 0
    return out.getvalue()


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
        bspec = (fs._batch_spec(mesh, B),)
        for key, c in cases.items():
            kind, *rest = key.split("/")
            if kind == "serve":
                cfg = _cfg(rest[0], None if rest[1] == "None" else rest[1])
                params, _ = serve.shard_params(cfg, _whole(c["params"]), mesh)
                toks = shd.local_shard(torch.tensor(c["tokens"], dtype=torch.int64),
                                       bspec + (None,), mesh)
                res[key] = _greedy_run(cfg, params, toks, mesh)
                res[key]["vocab_bytes"] = serve.vocab_bytes(params)
                res[key]["slab_bytes"] = serve.slab_bytes(params)
            elif kind == "grads":
                cfg = _cfg(rest[0], None if rest[1] == "None" else rest[1])
                res[key] = _grads_case(cfg, c, mesh)
                if shape == (1, 2) and rest[1] == "chunked":
                    res[key + "/pallas"] = _grads_case(cfg.with_(scan_engine="pallas"), c, mesh)
            elif kind == "layer":
                res[key] = _layer_case(c, mesh)
        res["frontend"] = _frontend_rows(mesh)
        if shape == (1, 2):
            res["elastic"] = _elastic_save(mesh, cases["elastic"], Path(out_dir) / "elastic")
            res["joined"] = _capture(JOINED_ARGV)
            res["continuous"] = _capture(CONT_ARGV + ["--model-shards", "2"])
        if rank:  # the grads and the elastic state are rank 0's alone
            res = {k: v for k, v in res.items() if not k.startswith(("grads/", "elastic"))}
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def _cli_argv(arch):
    return ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "4", "--prompt-len", "12",
            "--gen-len", "6"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the JAX reference, the serve subprocess and one spawn of gloo
    ranks per mesh, all at once; wait for all; return their results."""
    tmp = tmp_path_factory.mktemp("tp")
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
    cli = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.serve", *_cli_argv(CLI_ARCH),
                            "--model-shards", "2"], env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
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
    stdout, stderr = cli.communicate(timeout=300)
    assert cli.returncode == 0, stderr[-3000:]
    stdout_jax, stderr_jax = jax_proc.communicate(timeout=420)
    assert jax_proc.returncode == 0 and "JAX-OK" in stdout_jax, stderr_jax[-3000:]
    with open(tmp / "jax.pkl", "rb") as f:
        ref = pickle.load(f)
    return {"cases": cases, "ref": ref, "ranks": ranks, "cli": stdout, "tmp": tmp}


def _mesh_id(shape):
    return f"{shape[0]}x{shape[1]}"


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


def _allclose(got: dict, want: dict, tol: float) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=tol, err_msg=k)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", MESHES, ids=_mesh_id)
@pytest.mark.parametrize("arch,engine", SERVE_CASES, ids=lambda v: str(v))
def test_sharded_serving_matches_jax(runs, arch, engine, shape):
    """A prefill and GEN greedy decode steps on the rank's shards (the lane
    shards of the non-fused engines and the LSTM's columns, the vocab
    blocks, tied for smollm) against JAX's GSPMD steps on the (2, 2) mesh:
    the greedy tokens equal, every step's logits within 3e-5; each model
    rank holds half of the vocab and gate-slab bytes."""
    key = _key("serve", arch, engine)
    ranks, ref = runs["ranks"][shape], runs["ref"][key]
    np.testing.assert_array_equal(_rows(ranks, key, "tokens", 0), ref["tokens"])
    np.testing.assert_allclose(_rows(ranks, key, "logits", 1), ref["logits"], rtol=0,
                               atol=LOGIT_TOL)
    whole = _whole(runs["cases"][key]["params"])
    k = shape[1]
    assert all(r[key]["vocab_bytes"] * k == serve.vocab_bytes(whole) for r in ranks)
    assert all(r[key]["slab_bytes"] * k == serve.slab_bytes(whole) for r in ranks)
    cfg = _cfg(arch, engine)
    if cfg.cell is not None:  # the carries a rank keeps: its lanes
        assert all(r[key]["c"].shape[-1] * k == cfg.rnn_hidden for r in ranks)


@pytest.mark.parametrize("shape", MESHES, ids=_mesh_id)
def test_skip_projection_layer_on_lane_shards(runs, shape):
    """An SRU layer with ``w_skip`` (d 48, H 64) under ``chunked`` on the
    rank's lanes: output, last carry and the grads of every param and of
    the input against the whole layer on one device."""
    c = runs["cases"]["layer"]
    p = {k: torch.tensor(v).requires_grad_() for k, v in c["params"].items()}
    x = torch.tensor(c["x"]).requires_grad_()
    h, c_last = mts.mts_sru(p, x, torch.tensor(c["c0"]), engine="chunked", block_size=4)
    g = torch.autograd.grad(torch.sum(h * torch.tensor(c["g"])), [*p.values(), x])
    for r in runs["ranks"][shape]:
        got = r["layer"]
        np.testing.assert_allclose(got["h"], h.detach().numpy(), rtol=0, atol=2e-5)
        np.testing.assert_allclose(got["c"], c_last.detach().numpy(), rtol=0, atol=2e-5)
        _allclose(got["grads"], {**{k: gk.numpy() for k, gk in zip(p, g)}, "x": g[-1].numpy()},
                  GRAD_TOL)


@pytest.mark.parametrize("shape", MESHES, ids=_mesh_id)
def test_frontend_step_input_on_vocab_blocks(runs, shape):
    """A frontend stub's decode input under a mesh: the chosen token's
    embedding row looked up in the rank's block of the vocab and summed over
    the axis, the whole table's row bit for bit on every rank."""
    assert all(r["frontend"] for r in runs["ranks"][shape])


def test_serve_model_shards_gives_single_device_tokens(runs, capsys):
    """``serve --model-shards 2`` of the chunked SRU (two gloo ranks it
    starts itself) gives the single-device greedy tokens and prints each
    model rank's half of the slab and vocab bytes; nothing above 1024 is
    replicated at this size."""
    out = runs["cli"]
    stats = json.loads(out.split("serve-stats ", 1)[1])
    assert serve.main(_cli_argv(CLI_ARCH)) == 0
    single = json.loads(capsys.readouterr().out.split("serve-stats ", 1)[1])
    assert stats["tokens"] == single["tokens"]
    assert stats["vocab_bytes"] == [stats["vocab_bytes_whole"] // 2] * 2
    assert stats["slab_bytes"] == [stats["slab_bytes_whole"] // 2] * 2
    assert "vocab leaf bytes per model rank" in out
    assert "replicated on every model rank: nothing" in out


@pytest.mark.parametrize("what", ["joined", "continuous"])
def test_serve_on_ranks_gives_single_device_tokens(runs, what, capsys):
    """``serve.main`` on the (1, 2) ranks' initialised group: the LSTM in
    batch mode, and the chunked SRU in continuous mode with speculative
    decode and its default draft (``sru-paper-draft``, chunked, sharded the
    same way). Rank 0 alone prints; the tokens are the single-device
    serve's."""
    outs = [r[what] for r in runs["ranks"][(1, 2)]]
    line = "serve-stats " if what == "joined" else "continuous-stats "
    assert outs[1] == "" and line in outs[0]
    stats = json.loads(outs[0].split(line, 1)[1])
    argv = JOINED_ARGV[:-2] if what == "joined" else CONT_ARGV
    assert serve.main(argv) == 0
    single = json.loads(capsys.readouterr().out.split(line, 1)[1])
    assert stats["tokens"] == single["tokens"]
    assert stats["mesh"] == {"data": 1, "model": 2}


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", MESHES, ids=_mesh_id)
@pytest.mark.parametrize("arch,engine", GRAD_CASES, ids=lambda v: str(v))
def test_sharded_train_grads_match_jax(runs, arch, engine, shape):
    """``steps.step_grads`` on the rank's shards (the chunked SRU's lane
    shards, the LSTM's columns, the vocab blocks, tied for smollm), each
    grad made whole, against ``jax.grad`` of ``lm_loss`` under GSPMD:
    within 5e-4, the loss within 3e-5; the rank held half of each vocab
    leaf."""
    key = _key("grads", arch, engine)
    got, ref = runs["ranks"][shape][0][key], runs["ref"][key]
    assert abs(got["loss"] - ref["loss"]) <= LOGIT_TOL
    _allclose(got["grads"], ref["grads"], GRAD_TOL)
    cfg = _cfg(arch, engine)
    assert got["held"]["embed/embed"][0] * shape[1] == cfg.padded_vocab


def test_pallas_train_grads_on_lane_shards(runs):
    """The train step under ``pallas`` on (1, 2): each rank's recurrence on
    B3 (its plain version here) over its lanes; the grads are JAX's
    (``chunked``: the same function)."""
    key = _key("grads", "sru-paper-large", "chunked")
    got = runs["ranks"][(1, 2)][0][key + "/pallas"]
    _allclose(got["grads"], runs["ref"][key]["grads"], GRAD_TOL)


def test_elastic_restore_of_a_chunked_state_saved_from_two_ranks(runs):
    """One train step of the chunked SRU on (1, 2), saved from the ranks'
    shards (half the vocab rows and gate lanes each), restored on one
    device: the single-device step's state within 5e-4."""
    cfg = _cfg(ELASTIC_ARCH)
    held = runs["ranks"][(1, 2)][0]["elastic"]
    assert held["embed"][0] * 2 == cfg.padded_vocab and held["w"][-1] * 2 == cfg.rnn_hidden
    state = steps.init_train_state(torch.Generator().manual_seed(3), cfg, device="cpu")
    target = steps.init_train_state(torch.Generator().manual_seed(3), cfg, device="cpu")
    batch = {k: torch.tensor(v) for k, v in runs["cases"]["elastic"]["batch"].items()}
    state, _ = steps.build_train_step(cfg, total_steps=5)(state, batch)
    restored, _ = CheckpointManager(str(runs["tmp"] / "1x2" / "elastic")).restore(1, target)
    for (path, a), b in zip(flatten_with_paths(restored), tree_leaves(state)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=PARAM_TOL, err_msg=path)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def test_predicates_follow_the_divisibility_fallback():
    """``lane_sharded`` / ``vocab_sharded`` hold exactly where JAX's specs
    shard: SRU/QRNN under the non-fused engines when H divides, the LSTM
    when 4H does (its carries only when H does), the vocab when the padded
    vocab does; never without a model axis."""
    m2, m3, m4 = (mesh_lib.Mesh({"data": 1, "model": k}) for k in (2, 3, 4))
    sru = get_config("sru-paper-large")
    assert tp.lane_sharded(sru, m2) and not tp.lane_sharded(sru, m3)
    assert not tp.lane_sharded(get_config("sru-paper-large-fused"), m2)  # fused_sharded's
    assert not tp.lane_sharded(sru, None) and not tp.lane_sharded(get_config("llama3-8b"), m2)
    small = get_config("lstm-paper-small")  # H 350: 4H divides by 4, H does not
    assert tp.lane_sharded(small, m4)
    caches = lm.lm_init_caches(small, 8, 1, device="meta")
    assert fs.rank_cache_specs(small, caches, m4)["layers"]["c"] == (None, "data", None)
    assert tp.vocab_sharded(sru, m2) and not tp.vocab_sharded(sru, m3)
    assert not tp.vocab_sharded(sru, mesh_lib.Mesh({"data": 2}))
