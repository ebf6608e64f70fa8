"""Continuous batching on a mesh of ranks: the port's ``Scheduler(...,
mesh=)`` over the lane-masked mesh steps of ``training/steps.py``, and
``serve --mode continuous --model-shards 2``, against JAX's sharded
``Scheduler`` and the port's single-device engine on the same params.

The drives are those of JAX's three sharded engine tests
(``tests/test_continuous_batching.py::test_sharded_engine_matches_single_device``,
``tests/test_prefix_cache.py::test_sharded_prefix_cache_async_matches_single_device``,
``tests/test_speculative.py::test_sharded_speculative_matches_single_device``):
churn (three requests up front, two admitted mid-flight, one cancelled),
the prefix cache at async depth 2 (one request warms it, three hit), and
speculative decode with an oracle draft (the target itself: no rollback)
and an adversarial one (other params: rollbacks). They run on the reduced
``sru-paper-large-stacked`` (the barrier schedule) and
``qrnn-paper-large-stacked-int8`` (its config's ring), fp32, 4 slots, chunk 8.

Three sides run at once on params made here from a seed:

* JAX, in one subprocess with 8 virtual CPU devices, on meshes built with
  ``axis_types=(AxisType.Auto,) * 2`` (under jax 0.9 ``jax.make_mesh``
  builds Explicit axes, which JAX's own sharded engine tests trip on; on
  Auto axes its Scheduler runs unchanged), for the cells of ``JAX_RUNS``:
  churn and the prefix cache on both configs, the adversarial draft, each
  mesh (a JAX engine compiles its steps anew, 3-10 s each, so not every
  cell; the oracle draft is held to the single-device engine, and its
  JAX engine is the adversarial one's with other params);
* the port, in one ``torch.multiprocessing`` spawn of gloo ranks per mesh
  (1, 2) and (2, 2), every drive on its rank's shards, and a run whose
  rank clocks disagree: rank 1's injected clock runs at half rank 0's
  while arrivals spread at 200 req/s;
* ``serve --mode continuous --model-shards 2 --device cpu`` as a
  subprocess, once starting its two ranks itself and once as four ranks
  under ``torch.distributed.run``, which it joins as a (2, 2) mesh.

The port's single-device engine runs in this process. Tokens are compared
exactly; so are the prefix hits, the rollbacks and the prefix cache's bytes
(each rank counts a snapshot's whole bytes, as JAX does); the churn drive's
traced logits rows within 3e-5.
"""
from __future__ import annotations

import inspect
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
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.serving import Request, Scheduler, poisson_trace

REPO = Path(__file__).resolve().parents[1]
CONFIGS = {"sru": "sru-paper-large-stacked", "qrnn": "qrnn-paper-large-stacked-int8"}
MESHES = ((1, 2), (2, 2))
BATCH, CHUNK, SPEC_K = 4, 8, 4
DRIVES = (("churn", "sru"), ("churn", "qrnn"), ("prefix", "sru"), ("prefix", "qrnn"),
          ("oracle", "sru"), ("oracle", "qrnn"), ("adversarial", "sru"))
JAX_RUNS = (((1, 2), "churn", "sru"), ((1, 2), "prefix", "qrnn"), ((2, 2), "prefix", "sru"),
            ((2, 2), "adversarial", "sru"), ((2, 2), "churn", "qrnn"))
SKEW_RATE = 200.0
LOGIT_TOL = 3e-5  # the engine tests' bound on a traced logits row against JAX's
CLI_ARGV = ["--arch", "sru-paper-large-stacked", "--reduced", "--device", "cpu", "--mode",
            "continuous", "--requests", "8", "--prompt-len", "20", "--gen-len", "6"]


def _traces(vocab: int) -> dict:
    """Each drive's requests as ``(rid, prompt, max_new_tokens)``, drawn as
    JAX's sharded tests draw them."""
    def draw(lens):
        rng = np.random.default_rng(0)
        return [(i, rng.integers(0, vocab, size=p, dtype=np.int32), g)
                for i, (p, g) in enumerate(lens)]

    rng = np.random.default_rng(0)
    prefix = rng.integers(0, vocab, size=8, dtype=np.int32)
    spec = draw([(9, 10), (4, 3), (14, 8)])
    return {"churn": draw([(9, 20), (4, 3), (18, 12), (6, 4), (5, 5)]),
            "prefix": [(i, np.concatenate([prefix, rng.integers(0, vocab, size=p,
                                                                dtype=np.int32)]), g)
                       for i, (p, g) in enumerate([(8, 1), (5, 6), (3, 4), (6, 5)])],
            "oracle": spec, "adversarial": spec}


# The drives, run as they are by both sides (their source goes into the JAX
# script): ``engine`` a Scheduler, ``trace`` its requests.

def drive_churn(engine, trace):
    for r in trace[:3]:
        engine.submit(r)
    for tick in range(200):
        if tick == 5:
            engine.submit(trace[3])
        if tick == 6:
            assert engine.cancel(1) or trace[1].done
        if tick == 9:
            engine.submit(trace[4])
        engine.tick()
        if tick > 10 and engine.idle:
            break


def drive_prefix(engine, trace):
    engine.run(trace[:1], max_ticks=100)   # warms the cache
    engine.run(trace[1:], max_ticks=300)   # rids 1..3 hit
    assert engine.prefix_cache.report()["hits"] >= 3


def drive_spec(engine, trace):
    engine.run(trace, max_ticks=600)


DRIVE_FNS = {"churn": drive_churn, "prefix": drive_prefix, "oracle": drive_spec,
             "adversarial": drive_spec}


def engine_kwargs(drive):
    """The Scheduler's knobs of a drive, besides the draft's params."""
    kw = {"batch": BATCH, "chunk": CHUNK}
    if drive == "prefix":
        kw.update(prefix_cache_mb=8.0, async_depth=2)
    elif drive in ("oracle", "adversarial"):
        kw.update(async_depth=2, spec_k=SPEC_K)
    return kw


def outcome(engine, trace):
    """What the sides compare: tokens and cancellations per rid, hits,
    rollbacks and the prefix cache's bytes."""
    pc = engine.prefix_cache
    return {"tokens": {r.rid: list(r.tokens) for r in trace},
            "cancelled": {r.rid: bool(r.cancelled) for r in trace},
            "hits": engine.metrics.prefix_hits, "rollbacks": engine.metrics.spec_rollbacks,
            "prefix_bytes": None if pc is None else pc.report()["used_bytes"]}


JAX_SCRIPT = r"""
import pickle, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs.registry import get_config
from repro.distribution import sharding as shd
from repro.distribution.fused_sharded import serving_param_specs
from repro.serving import Request, Scheduler

inputs = pickle.load(open(sys.argv[1], "rb"))
%(helpers)s
def mesh(shape):
    return jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:shape[0] * shape[1]])
tree = lambda p: jax.tree_util.tree_map(jnp.asarray, p)
out = {}
for shape, drive, cname in inputs["jax_runs"]:
    m = mesh(shape)
    cfg = get_config(inputs["configs"][cname]).reduced()
    shard = lambda p: jax.device_put(tree(p), shd.named_shardings(
        serving_param_specs(tree(p), m), m))
    params = shard(inputs["params"][cname])
    kw = engine_kwargs(drive)
    if drive in ("oracle", "adversarial"):
        kw.update(draft_cfg=cfg, draft_params=params if drive == "oracle"
                  else shard(inputs["wrong"][cname]))
    trace = [Request(rid=i, prompt=p.copy(), max_new_tokens=g)
             for i, p, g in inputs["traces"][drive]]
    eng = Scheduler(cfg, params, mesh=m, **kw)
    DRIVE_FNS[drive](eng, trace)
    res = outcome(eng, trace)
    res["spec"] = str(eng.pool.caches["layers"]["c"].sharding.spec)
    out[(shape, drive, cname)] = res
pickle.dump(out, open(sys.argv[2], "wb"))
print("JAX-OK")
"""


def _helpers() -> str:
    src = [f"BATCH, CHUNK, SPEC_K = {BATCH}, {CHUNK}, {SPEC_K}"]
    src += [inspect.getsource(f) for f in (drive_churn, drive_prefix, drive_spec,
                                           engine_kwargs, outcome)]
    src.append('DRIVE_FNS = {"churn": drive_churn, "prefix": drive_prefix, '
               '"oracle": drive_spec, "adversarial": drive_spec}')
    return "\n".join(src)


def _cfg(cname):
    return get_config(CONFIGS[cname]).reduced()


def _make_inputs() -> dict:
    params, wrong = {}, {}
    for cname in CONFIGS:
        cfg = _cfg(cname)
        params[cname] = bridge.params_to_numpy(
            lm.lm_init(torch.Generator().manual_seed(0), cfg, device="cpu"))
        wrong[cname] = bridge.params_to_numpy(
            lm.lm_init(torch.Generator().manual_seed(7), cfg, device="cpu"))
    return {"configs": CONFIGS, "params": params, "wrong": wrong, "jax_runs": JAX_RUNS,
            "traces": _traces(_cfg("sru").vocab)}


def _requests(spec):
    return [Request(rid=i, prompt=p.copy(), max_new_tokens=g) for i, p, g in spec]


def _skew_trace():
    return poisson_trace(8, rate=SKEW_RATE, prompt_lens=(6, 12), gen_mix=((3, 0.5), (6, 0.5)),
                         vocab=_cfg("sru").vocab, seed=3)


class Clock:
    """An engine clock that moves ``dt`` at every read."""

    def __init__(self, dt: float = 1e-3):
        self.t, self.dt = 0.0, dt

    def __call__(self) -> float:
        self.t += self.dt
        return self.t


def _run(inputs, drive, cname, mesh=None):
    """One drive on the port's engine: whole params, or under ``mesh`` this
    rank's shards. Returns its outcome (under a mesh with this rank's pool
    carry shape, whether the pools stayed in place and the admissions)."""
    cfg = _cfg(cname)

    def load(p):
        p = bridge.params_from_numpy(p, device="cpu")
        return p if mesh is None else serve.shard_params(cfg, p, mesh)[0]

    params = load(inputs["params"][cname])
    kw = engine_kwargs(drive)
    if drive in ("oracle", "adversarial"):
        kw.update(draft_cfg=cfg, draft_params=params if drive == "oracle"
                  else load(inputs["wrong"][cname]))
    trace = _requests(inputs["traces"][drive])
    # churn also records every emitted token's logits row (on (2, 2) each
    # step's rows are gathered over "data" for it)
    eng = Scheduler(cfg, params, mesh=mesh, device="cpu", trace_logits=drive == "churn", **kw)
    DRIVE_FNS[drive](eng, trace)
    res = outcome(eng, trace)
    res.update(carry=tuple(eng.pool.caches["layers"]["c"].shape), in_place=eng.cache_in_place,
               admissions=eng.admission_log,
               logits={rid: np.stack(rows) for rid, rows in eng.logit_trace.items()})
    return res


def _skew_run(mesh=None, dt=1e-3):
    trace = _skew_trace()
    eng = Scheduler(_cfg("sru"), _skew_params(mesh), mesh=mesh, device="cpu", batch=BATCH,
                    chunk=CHUNK, clock=Clock(dt))
    eng.run(trace, max_ticks=2000)
    return {"tokens": {r.rid: list(r.tokens) for r in trace}, "admissions": eng.admission_log}


def _skew_params(mesh):
    cfg = _cfg("sru")
    p = lm.lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    return p if mesh is None else serve.shard_params(cfg, p, mesh)[0]


def _worker(rank, world, model_axis, init_file, inputs_path, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world, timeout=mesh_lib.GROUP_TIMEOUT)
    try:
        mesh = mesh_lib.make_local_mesh(model_axis, device=torch.device("cpu"))
        with open(inputs_path, "rb") as f:
            inputs = pickle.load(f)
        res = {"coords": mesh.coords}
        for drive, cname in DRIVES:
            res[(drive, cname)] = _run(inputs, drive, cname, mesh)
        # rank 1's clock runs at half rank 0's: the ranks still admit alike
        res["skew"] = _skew_run(mesh, dt=1e-3 if rank == 0 else 5e-4)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the JAX reference, the CLI and one spawn of gloo ranks per
    mesh, all at once; run the single-device engine meanwhile; return every
    side's results."""
    tmp = tmp_path_factory.mktemp("cmesh")
    inputs = _make_inputs()
    inputs_path = tmp / "inputs.pkl"
    with open(inputs_path, "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO / "src"))
    (tmp / "ref.py").write_text(textwrap.dedent(JAX_SCRIPT) % {"helpers": _helpers()})
    jax_proc = subprocess.Popen([sys.executable, str(tmp / "ref.py"), str(inputs_path),
                                 str(tmp / "jax.pkl")], env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    serve_cmd = ["-m", "repro_torch.launch.serve", *CLI_ARGV, "--model-shards", "2"]
    launchers = {"spawned": [], "torchrun": ["-m", "torch.distributed.run", "--standalone",
                                             "--nproc-per-node", "4"]}
    cli_env = dict(env, OMP_NUM_THREADS="1")  # six ranks beside the rest of the suite
    cli = {how: subprocess.Popen([sys.executable, *pre, *serve_cmd], env=cli_env,
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
           for how, pre in launchers.items()}
    spawns = {}
    for shape in MESHES:
        out = tmp / f"{shape[0]}x{shape[1]}"
        out.mkdir()
        spawns[shape] = (out, mp.start_processes(
            _worker, args=(shape[0] * shape[1], shape[1], str(out / "rdv"), str(inputs_path),
                           str(out)), nprocs=shape[0] * shape[1], join=False,
            start_method="spawn"))
    single = {key: _run(inputs, *key) for key in DRIVES}
    single["skew"] = _skew_run()
    ranks = {}
    for shape, (out, procs) in spawns.items():
        while not procs.join(timeout=240):
            pass
        ranks[shape] = [pickle.load(open(out / f"rank{r}.pkl", "rb"))
                        for r in range(shape[0] * shape[1])]
    served = {}
    for how, proc in cli.items():
        stdout, stderr = proc.communicate(timeout=300)
        assert proc.returncode == 0, stderr[-3000:]
        served[how] = stdout
    stdout_j, stderr_j = jax_proc.communicate(timeout=420)
    assert jax_proc.returncode == 0 and "JAX-OK" in stdout_j, stderr_j[-3000:]
    with open(tmp / "jax.pkl", "rb") as f:
        ref = pickle.load(f)
    return {"single": single, "ranks": ranks, "ref": ref, "cli": served}


def _mesh_id(shape):
    return f"{shape[0]}x{shape[1]}"


def _drive_id(key):
    return "-".join(key)


@pytest.mark.parametrize("shape", MESHES, ids=_mesh_id)
@pytest.mark.parametrize("key", DRIVES, ids=_drive_id)
def test_sharded_engine_matches_jax_and_single_device(runs, key, shape):
    """Every rank's engine emits the single-device engine's tokens, with
    the same cancellations, prefix hits (at least 3 in the prefix drive),
    rollbacks (none for the oracle, some for the adversarial draft) and
    prefix-cache bytes; where JAX ran the cell, its sharded engine's too."""
    single = runs["single"][key]
    drive = key[0]
    for r in runs["ranks"][shape]:
        mine = r[key]
        for field in ("tokens", "cancelled", "hits", "rollbacks", "prefix_bytes"):
            assert mine[field] == single[field], (field, r["coords"])
    assert all(single["tokens"].values())
    if drive == "prefix":
        assert single["hits"] >= 3
    if drive == "oracle":
        assert single["rollbacks"] == 0
    if drive == "adversarial":
        assert single["rollbacks"] > 0
    if drive == "churn":
        assert single["cancelled"][1] or len(single["tokens"][1]) == 3
        for r in runs["ranks"][shape]:
            assert r[key]["logits"].keys() == single["logits"].keys()
            for rid, rows in single["logits"].items():
                np.testing.assert_allclose(r[key]["logits"][rid], rows, rtol=0, atol=LOGIT_TOL)
    ref = runs["ref"].get((shape, *key))
    if ref is not None:
        assert "'model'" in ref["spec"] and ("'data'" in ref["spec"]) == (shape[0] > 1)
        for field in ("tokens", "cancelled", "hits", "rollbacks", "prefix_bytes"):
            assert single[field] == ref[field], field


@pytest.mark.parametrize("shape", MESHES, ids=_mesh_id)
@pytest.mark.parametrize("key", DRIVES, ids=_drive_id)
def test_pool_carries_are_lane_shards_held_in_place(runs, key, shape):
    """Each rank's pool carry is its (L, B/D, H/k) shard, and no pool leaf
    (the draft's included) moved during the run."""
    cfg = _cfg(key[1])
    D, k = shape
    for r in runs["ranks"][shape]:
        assert r[key]["carry"] == (cfg.n_layers, BATCH // D, cfg.rnn_hidden // k)
        assert r[key]["in_place"]


@pytest.mark.parametrize("shape", MESHES, ids=_mesh_id)
def test_ranks_admit_alike_under_skewed_clocks(runs, shape):
    """Rank 1's clock runs at half rank 0's while arrivals spread at 200
    req/s: every rank reads rank 0's clock, so their admission logs are
    equal, admissions spread over several ticks, and the tokens are the
    single-device engine's."""
    ranks = runs["ranks"][shape]
    logs = [r["skew"]["admissions"] for r in ranks]
    assert all(log == logs[0] for log in logs)
    assert len(logs[0]) == 8 and len({tick for tick, _, _ in logs[0]}) > 2
    for r in ranks:
        assert r["skew"]["tokens"] == runs["single"]["skew"]["tokens"]


@pytest.mark.parametrize("how,mesh", [("spawned", (1, 2)), ("torchrun", (2, 2))])
def test_serve_continuous_model_shards_gives_single_device_tokens(runs, how, mesh, capsys):
    """``serve --mode continuous --model-shards 2 --device cpu --reduced``
    exits 0, starting two ranks itself or joining four under
    ``torch.distributed.run``; rank 0 alone prints the mesh lines and
    ``continuous-stats``, whose tokens are the single-device continuous
    serve's."""
    out = runs["cli"][how]
    D, k = mesh
    assert out.count("continuous-stats ") == 1
    assert f"mesh: {{'data': {D}, 'model': {k}}}" in out and "dist: backend gloo" in out
    stats = json.loads(out.split("continuous-stats ", 1)[1])
    assert serve.main(CLI_ARGV) == 0
    single = json.loads(capsys.readouterr().out.split("continuous-stats ", 1)[1])
    assert stats["tokens"] == single["tokens"] and stats["completed"] == 8
    assert stats["graphs"] is False and stats["cache_in_place"]
    assert stats["mesh"] == {"data": D, "model": k}
    assert stats["pool_carry_shape"][1:] == [4 // D, 64 // k]
