"""The port's observability slice (``repro_torch/observability/``,
``repro_torch/runtime/monitor.py``, the Scheduler's telemetry hooks and
``serve --mode continuous``'s telemetry flags) against the JAX package's, on
the CPU.

* Exporters: ``prometheus_text`` gives JAX's text byte for byte for the same
  report dict (the port's ``busy_s`` key included), and the JSONL writer
  writes, flushes and closes as JAX's does.
* ``StepMonitor``: the same observe dicts and events as JAX's, exactly, on a
  seeded sequence of tick times with injected outliers.
* ``Telemetry.from_flags``: the same sinks on for every combination of flags.
* The Scheduler: JAX's ``test_tokens_identical_with_telemetry_on`` repeated
  on the port (every sink on changes no token; ``tools/trace_check.py``
  accepts the trace; the metrics rows carry ``METRICS_KEYS``), the
  ``straggler`` instant, and on the same injected clock the same trace
  events and metrics rows as JAX's Scheduler.
* ``serve``: the four artifacts, checked by ``tools/trace_check.py`` as the
  Makefile's ``serve-smoke`` checks JAX's; the flags refused outside
  continuous mode; disabled telemetry records nothing.
* ``chip_smoke.profile_split``, which splits the card's profile by tick
  phase, on a profile with known device events.

The card's cases (tokens under graphs, annotation names in a CUDA profile)
are in ``tests/test_torch_cuda.py``.
"""
from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.models import lm as jlm
from repro.observability import MetricsJSONLWriter as JaxMetricsJSONLWriter
from repro.observability import Telemetry as JaxTelemetry
from repro.observability import annotation as jax_annotation
from repro.observability import RollingMetrics as JaxRollingMetrics
from repro.observability import TraceRecorder as JaxTraceRecorder
from repro.observability import prometheus_text as jax_prometheus_text
from repro.runtime.monitor import StepMonitor as JaxStepMonitor
from repro.serving import Request as JaxRequest
from repro.serving import Scheduler as JaxScheduler
from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.launch import serve
from repro_torch.observability import (NULL_TELEMETRY, NULL_TRACE, MetricsJSONLWriter,
                                       RollingMetrics, Telemetry, TraceRecorder, annotation,
                                       make_trace, null_annotation, prometheus_text,
                                       torch_profile, write_prometheus)
from repro_torch.runtime.monitor import StepMonitor
from repro_torch.serving import Scheduler, clone_trace, headline_poisson_trace

REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


trace_check = _load("trace_check", REPO / "tools" / "trace_check.py")


class FakeClock:
    """An engine clock that moves 1 ms at every read."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        self.t += 1e-3
        return self.t


def _bridged(arch, engine=None, seed=0):
    """(port cfg, port params, JAX cfg, JAX params): JAX's params, bridged."""
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    if engine:
        jcfg, cfg = jcfg.with_(scan_engine=engine), cfg.with_(scan_engine=engine)
    jparams = jlm.lm_init(jax.random.PRNGKey(seed), jcfg)
    params = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device=CPU)
    return cfg, params, jcfg, jparams


def _jax_requests(trace):
    return [JaxRequest(rid=r.rid, prompt=r.prompt.copy(), max_new_tokens=r.max_new_tokens,
                       arrival=r.arrival) for r in trace]


def _prom_samples(text):
    """Parse an exposition: every non-comment line ``name value`` with a
    numeric value; returns the names."""
    names = []
    for line in text.splitlines():
        if line.startswith("#"):
            assert line.startswith(("# HELP ", "# TYPE "))
            continue
        name, value = line.rsplit(" ", 1)
        float(value)
        names.append(name)
    return names


# ---------------------------------------------------------------------------
# Exporters
# ---------------------------------------------------------------------------

def _port_report():
    """A real report of the port's Scheduler (with ``busy_s``), on a fake
    clock: two requests on the reduced SRU LM."""
    cfg, params, _, _ = _bridged("sru-paper-small", "sequential")
    eng = Scheduler(cfg, params, batch=2, chunk=6, clock=FakeClock(), device=CPU)
    trace = headline_poisson_trace(cfg.vocab, requests=2, rate=0.0, prompt_len=5,
                                   gen_mix=((3, 1.0),))
    eng.run(clone_trace(trace), max_ticks=200)
    rep = eng.metrics.report()
    assert "busy_s" in rep and rep["completed"] == 2
    return rep


REPORTS = {
    # JAX's test_prometheus_text_parses report: a bool and a string skipped
    "jax_test": lambda: {"ticks": 42, "goodput_tok_s": 123.4, "outputs_match": True,
                         "arch": "sru-paper-small",
                         "ttft_s": {"mean": 0.2, "p50": 0.18, "p95": 0.4, "max": 0.5}},
    "port_scheduler": _port_report,
    "awkward_floats": lambda: {"busy_s": 1e-300, "elapsed_s": 3.0, "batch": 7,
                               "fetch_wait_s": float("inf"), "unknown_key": -0.0,
                               "tpot_s": {"mean": 1 / 3, "p50": 0.1, "p95": 2.5e-7,
                                          "max": 12345678.9}},
}


@pytest.mark.parametrize("name", sorted(REPORTS))
def test_prometheus_text_is_byte_identical_to_jax(name, tmp_path):
    """For the same report dict, the port's exposition is JAX's byte for
    byte (one dashboard reads both), and it parses; the port's ``busy_s``
    is a gauge with the generic help line."""
    report = REPORTS[name]()
    text = prometheus_text(report)
    assert text == jax_prometheus_text(report)
    assert prometheus_text(report, prefix="x_") == jax_prometheus_text(report, prefix="x_")
    assert text.endswith("\n")
    names = _prom_samples(text)
    assert not any("outputs_match" in n or "arch" in n for n in names)
    if "busy_s" in report:
        assert "repro_serving_busy_s" in names
        assert "# TYPE repro_serving_busy_s gauge" in text
    path = tmp_path / "m.prom"
    assert write_prometheus(str(path), report) == text and path.read_text() == text


def test_metrics_jsonl_writer_behaves_as_jax(tmp_path):
    """Row count, a flush per row (readable before close), the same file,
    an idempotent second close and a write after close refused."""
    rows = [{"t": 1.0, "x": 2}, {"t": 2.0, "x": [3, 4]}, {"t": 3.5, "ticks": 8}]
    texts = []
    for cls, path in ((MetricsJSONLWriter, tmp_path / "port.jsonl"),
                      (JaxMetricsJSONLWriter, tmp_path / "jax.jsonl")):
        w = cls(str(path))
        for i, row in enumerate(rows):
            w.write(row)
            assert w.rows == i + 1
            assert len(path.read_text().splitlines()) == i + 1  # flushed
        w.close()
        w.close()  # idempotent
        with pytest.raises(ValueError):
            w.write({"t": 9.0})
        with cls(str(path) + ".2") as w2:
            w2.write(rows[0])
        assert w2.rows == 1
        texts.append(path.read_text())
    assert texts[0] == texts[1]
    assert [json.loads(line) for line in texts[0].splitlines()] == rows


# ---------------------------------------------------------------------------
# StepMonitor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,alpha,z_threshold,warmup", [
    (0, 0.1, 4.0, 5), (1, 0.2, 3.0, 2), (2, 0.05, 4.0, 0), (3, 1.0, 2.5, 10),
])
def test_step_monitor_matches_jax_exactly(seed, alpha, z_threshold, warmup):
    """A seeded sequence of tick times (lognormal around 0.4 ms) with
    injected outliers: every ``observe`` dict, the flagged events and the
    callback's arguments equal JAX's, float for float."""
    rng = np.random.default_rng(seed)
    dts = rng.lognormal(np.log(4e-4), 0.15, 400)
    spikes = rng.choice(np.arange(warmup + 5, 400), size=12, replace=False)
    dts[spikes] *= rng.uniform(3.0, 40.0, size=12)
    dts[:3] = [5e-2, 1e-6, 4e-4]  # a slow first tick and a tiny one
    runs = []
    for cls in (StepMonitor, JaxStepMonitor):
        calls = []
        mon = cls(alpha=alpha, z_threshold=z_threshold, warmup_steps=warmup,
                  on_straggler=lambda *a, calls=calls: calls.append(a))
        outs = [mon.observe(i, float(dt)) for i, dt in enumerate(dts)]
        runs.append((outs, mon.events, calls, mon._mean))
    assert runs[0] == runs[1]
    outs, events, calls, _ = runs[0]
    assert events and len(calls) == len(events) and sum(o["straggler"] for o in outs) == len(events)


def test_step_monitor_delegates_to_the_shared_ewma():
    from repro_torch.observability import EwmaMeanVar

    mon = StepMonitor(alpha=0.2, z_threshold=3.0, warmup_steps=2)
    for step in range(4):
        assert not mon.observe(step, 0.01)["straggler"]
    out = mon.observe(4, 1.0)
    assert out["straggler"] and out["z"] > 3.0 and mon.events[-1]["step"] == 4
    assert isinstance(mon._ewma, EwmaMeanVar)
    mon.start()
    res = mon.stop(5)
    assert res["step_time"] >= 0.0


# ---------------------------------------------------------------------------
# Telemetry.from_flags
# ---------------------------------------------------------------------------

FLAG_CASES = [
    dict(),
    dict(trace_out="t.json"),
    dict(metrics_jsonl="m.jsonl"),
    dict(metrics_jsonl="m.jsonl", metrics_every=0),
    dict(metrics_jsonl="m.jsonl", metrics_every=4, rolling_window=16),
    dict(trace_out="t.json", metrics_jsonl="m.jsonl", monitor=True),
    dict(monitor=True),
    dict(profiling=True),
    dict(trace_out="t.json", metrics_jsonl="m.jsonl", metrics_every=16, monitor=True,
         profiling=True, trace_capacity=8),
]


@pytest.mark.parametrize("flags", FLAG_CASES, ids=lambda f: "-".join(sorted(f)) or "none")
def test_telemetry_from_flags_turns_on_the_sinks_jax_does(flags, tmp_path):
    kw = dict(flags)
    if "metrics_jsonl" in kw:
        kw["metrics_jsonl"] = str(tmp_path / kw["metrics_jsonl"])
    mine_kw, jax_kw = dict(kw), dict(kw)
    if kw.get("monitor"):
        mine_kw["monitor"], jax_kw["monitor"] = StepMonitor(), JaxStepMonitor()
    mine, ref = Telemetry.from_flags(**mine_kw), JaxTelemetry.from_flags(**jax_kw)

    def sinks(tel, annotate):
        return (tel.enabled, tel.trace.enabled, getattr(tel.trace, "capacity", None),
                tel.rolling is None, getattr(tel.rolling, "window", None), tel.metrics_every,
                tel.metrics_writer is None, tel.monitor is None, tel.annotate is annotate)

    assert sinks(mine, annotation) == sinks(ref, jax_annotation)
    assert (mine.annotate is null_annotation) == (not flags.get("profiling"))
    mine.close()
    ref.close()
    mine.close()  # idempotent


def test_default_telemetry_is_all_off():
    assert not NULL_TELEMETRY.enabled and NULL_TELEMETRY.trace is NULL_TRACE
    assert NULL_TELEMETRY.monitor is None and NULL_TELEMETRY.annotate is null_annotation
    with NULL_TELEMETRY.annotate("decode") as a, null_annotation("x") as b:
        assert a is None and b is None
    NULL_TELEMETRY.close()


# ---------------------------------------------------------------------------
# The Scheduler with telemetry on
# ---------------------------------------------------------------------------

def _engine(cfg, params, *, telemetry=None, async_depth=1, spec=None, **kw):
    extra = {}
    if spec is not None:
        extra = dict(draft_cfg=spec[0], draft_params=spec[1], spec_k=3)
    return Scheduler(cfg, params, batch=2, chunk=6, async_depth=async_depth,
                     telemetry=telemetry, device=CPU, **extra, **kw)


def _run(cfg, params, trace, **kw):
    eng = _engine(cfg, params, **kw)
    eng.warmup()
    done = eng.run(clone_trace(trace), max_ticks=800)
    return {r.rid: list(r.tokens) for r in done}


@pytest.mark.parametrize("arch,engine,depth,spec", [
    ("sru-paper-small", "fused", 1, False),
    ("sru-paper-small", "fused", 2, False),
    ("sru-paper-small", "fused", 2, True),
    ("qrnn-paper-small", "chunked", 2, True),
])
def test_tokens_identical_with_telemetry_on(tmp_path, arch, engine, depth, spec):
    """JAX's acceptance bar on the port: every sink on (trace, rolling
    window, JSONL rows, straggler monitor, profiler annotations) changes no
    token of any stream, at async depth 2 and in speculative decode; the
    trace passes ``trace_check`` with JAX's test's arguments and the rows
    carry exactly the documented keys."""
    cfg, params, _, _ = _bridged(arch, engine)
    draft = None
    if spec:
        dcfg, dparams, _, _ = _bridged("sru-paper-draft", seed=1)
        assert dcfg.vocab == cfg.vocab
        draft = (dcfg, dparams)
    trace = headline_poisson_trace(cfg.vocab, requests=6, rate=0.0, prompt_len=7,
                                   gen_mix=((4, 0.5), (8, 0.5)))
    tel = Telemetry.from_flags(trace_out="yes", metrics_jsonl=str(tmp_path / "m.jsonl"),
                               metrics_every=4, monitor=StepMonitor(warmup_steps=2),
                               profiling=True)
    on = _run(cfg, params, trace, telemetry=tel, async_depth=depth, spec=draft)
    tel.close()
    off = _run(cfg, params, trace, async_depth=depth, spec=draft)
    assert on == off and len(on) == 6

    doc = tel.trace.to_chrome()
    want = ["decode", "fetch", "retire"] + (["draft", "verify"] if spec else [])
    errors = trace_check.check_trace(doc, expect_overlap=(depth == 2), expect_phases=want,
                                     epsilon_frac=0.5, epsilon_us=5000.0)
    assert errors == [], errors
    rows = [json.loads(line) for line in (tmp_path / "m.jsonl").read_text().splitlines()]
    assert len(rows) >= 2 and all(set(r) == trace_check.METRICS_KEYS for r in rows)
    assert rows[-1]["ticks"] >= rows[0]["ticks"]


def test_straggler_becomes_trace_instant():
    """A tick the monitor flags lands on the engine track as a ``straggler``
    instant with JAX's arguments: the tick, its time, z and the mean."""
    cfg, params, _, _ = _bridged("sru-paper-small", "fused")

    class AlwaysStraggling:
        events = []

        def observe(self, step, dt):
            return {"step_time": dt, "straggler": True, "mean": dt, "z": 9.9}

    tel = Telemetry(trace=make_trace(True), monitor=AlwaysStraggling())
    eng = _engine(cfg, params, telemetry=tel)
    trace = headline_poisson_trace(cfg.vocab, requests=2, rate=0.0, prompt_len=5,
                                   gen_mix=((3, 1.0),))
    eng.warmup()
    eng.run(clone_trace(trace), max_ticks=200)
    stragglers = [e for e in tel.trace.to_chrome()["traceEvents"]
                  if e.get("ph") == "i" and e["name"] == "straggler"]
    assert len(stragglers) == eng.metrics.ticks
    engine_track = next(e["tid"] for e in tel.trace.to_chrome()["traceEvents"]
                        if e.get("ph") == "M" and e.get("args", {}).get("name") == "engine")
    first = stragglers[0]
    assert first["tid"] == engine_track and first["args"]["z"] == 9.9
    assert set(first["args"]) == {"tick", "dt_s", "z", "mean_s"}
    assert [e["args"]["tick"] for e in stragglers] == list(range(eng.metrics.ticks))


@pytest.mark.parametrize("kind", ["prefix_cache", "speculative"])
def test_scheduler_writes_jax_trace_and_rows(kind, tmp_path):
    """The same trace through the port's and JAX's Schedulers, each on its
    own fake clock, every sink on: the same trace events (names, phases
    ``X``/``i``/``b``/``e``/``n``/``C``, tracks, timestamps and arguments)
    and the same metrics rows, so the span catalog of
    ``docs/observability.md`` holds for the port's traces as it is."""
    cfg, params, jcfg, jparams = _bridged("sru-paper-small", "sequential")
    kw = dict(batch=2, chunk=6, async_depth=2)
    if kind == "prefix_cache":
        from repro_torch.serving import shared_prefix_trace

        trace = shared_prefix_trace(8, rate=300.0, prefix_len=12, prompt_len=20, share=0.7,
                                    vocab=cfg.vocab, seed=2, gen_mix=((3, 0.5), (7, 0.5)))
        mine_kw, jax_kw = dict(prefix_cache_mb=4.0), dict(prefix_cache_mb=4.0)
    else:
        trace = headline_poisson_trace(cfg.vocab, requests=6, rate=300.0, prompt_len=9,
                                       gen_mix=((4, 0.5), (9, 0.5)))
        dcfg, dparams, jdcfg, jdparams = _bridged("sru-paper-draft", seed=1)
        mine_kw = dict(draft_cfg=dcfg, draft_params=dparams, spec_k=3)
        jax_kw = dict(draft_cfg=jdcfg, draft_params=jdparams, spec_k=3)
    docs, rows = [], []
    for side in ("port", "jax"):
        path = tmp_path / f"{side}.jsonl"
        # every sink on, the recorder on a fake clock of its own
        if side == "port":
            tel = Telemetry(trace=TraceRecorder(clock=FakeClock()),
                            rolling=RollingMetrics(window=256), metrics_every=3,
                            metrics_writer=MetricsJSONLWriter(str(path)),
                            monitor=StepMonitor(warmup_steps=2))
            eng = Scheduler(cfg, params, clock=FakeClock(), telemetry=tel, device=CPU,
                            **kw, **mine_kw)
            reqs = clone_trace(trace)
        else:
            tel = JaxTelemetry(trace=JaxTraceRecorder(clock=FakeClock()),
                               rolling=JaxRollingMetrics(window=256), metrics_every=3,
                               metrics_writer=JaxMetricsJSONLWriter(str(path)),
                               monitor=JaxStepMonitor(warmup_steps=2))
            eng = JaxScheduler(jcfg, jparams, clock=FakeClock(), telemetry=tel, **kw, **jax_kw)
            reqs = _jax_requests(trace)
        done = eng.run(reqs, max_ticks=800)
        tel.close()
        assert len(done) == len(trace)
        docs.append(tel.trace.to_chrome())
        rows.append([json.loads(line) for line in path.read_text().splitlines()])
    mine, ref = docs
    assert {(e["name"], e["ph"]) for e in mine["traceEvents"]} == \
        {(e["name"], e["ph"]) for e in ref["traceEvents"]}
    assert mine == ref
    assert rows[0] == rows[1] and len(rows[0]) >= 2


def test_disabled_telemetry_records_nothing(capsys):
    cfg, params, _, _ = _bridged("sru-paper-small", "fused")
    eng = _engine(cfg, params)
    assert eng.tel is NULL_TELEMETRY and eng.tel.trace is NULL_TRACE and not eng.tel.enabled
    trace = headline_poisson_trace(cfg.vocab, requests=2, rate=0.0, prompt_len=5,
                                   gen_mix=((3, 1.0),))
    eng.warmup()
    assert len(eng.run(clone_trace(trace), max_ticks=200)) == 2
    assert serve.main(["--arch", "sru-paper-small", "--reduced", "--device", "cpu", "--mode",
                       "continuous", "--requests", "3", "--prompt-len", "6", "--gen-len",
                       "4"]) == 0
    out = capsys.readouterr().out
    stats = json.loads(out.split("continuous-stats ", 1)[1])
    assert (stats["stragglers"], stats["trace_events"], stats["metrics_rows"],
            stats["torch_profile"]) == (None, None, None, None)
    assert not any(x.startswith(("trace:", "metrics:", "prometheus", "stragglers:"))
                   for x in out.splitlines())


# ---------------------------------------------------------------------------
# serve --mode continuous with the telemetry flags
# ---------------------------------------------------------------------------

# The Makefile's serve-smoke run, on the port (its first half).
SMOKE = ["--arch", "sru-paper-small", "--reduced", "--device", "cpu", "--mode", "continuous",
         "--requests", "8", "--batch", "3", "--prompt-len", "12", "--gen-len", "8", "--chunk",
         "8", "--prefix-cache-mb", "4", "--prefix-share", "0.75"]


def test_serve_writes_the_four_artifacts(tmp_path, capsys):
    """``--trace-out --metrics-jsonl --prom-out --torch-profile``: the trace
    passes ``tools/trace_check.py`` (a subprocess, the Makefile's
    serve-smoke arguments), the rows and the snapshot parse, the profile
    names the tick phases, and the tokens are the run's without telemetry."""
    paths = {k: tmp_path / n for k, n in (("trace", "trace.json"), ("rows", "m.jsonl"),
                                          ("prom", "m.prom"), ("prof", "prof"))}
    flags = ["--trace-out", str(paths["trace"]), "--metrics-jsonl", str(paths["rows"]),
             "--metrics-every", "16", "--prom-out", str(paths["prom"]), "--torch-profile",
             str(paths["prof"])]
    assert serve.main(SMOKE + flags) == 0
    out = capsys.readouterr().out
    stats = json.loads(out.split("continuous-stats ", 1)[1])
    for prefix in ("trace: ", "metrics: ", "prometheus snapshot -> "):
        assert any(x.startswith(prefix) for x in out.splitlines()), prefix
    assert stats["torch_profile"] is True and stats["graphs"] is False
    assert stats["trace_events"] > 0 and stats["metrics_rows"] >= 2
    assert isinstance(stats["stragglers"], int)
    check = subprocess.run(
        [sys.executable, str(REPO / "tools" / "trace_check.py"), str(paths["trace"]),
         "--metrics-jsonl", str(paths["rows"]), "--expect-phase", "decode", "--expect-phase",
         "fetch", "--expect-phase", "retire"], capture_output=True, text=True, timeout=120)
    assert check.returncode == 0, check.stdout
    names = _prom_samples(paths["prom"].read_text())
    assert "repro_serving_ticks_total" in names and "repro_serving_busy_s" in names
    assert len(paths["rows"].read_text().splitlines()) == stats["metrics_rows"]
    profiles = list(paths["prof"].glob("*.pt.trace.json"))
    assert len(profiles) == 1
    doc = json.loads(profiles[0].read_text())
    named = {e["name"] for e in doc["traceEvents"] if e.get("cat") == "user_annotation"}
    assert {"decode", "prefill", "reset"} <= named <= set(_chip_smoke().TICK_PHASES)
    assert serve.main(SMOKE) == 0
    plain = json.loads(capsys.readouterr().out.split("continuous-stats ", 1)[1])
    assert plain["tokens"] == stats["tokens"]


@pytest.mark.parametrize("flag", [["--trace-out", "t.json"], ["--metrics-jsonl", "m.jsonl"],
                                  ["--prom-out", "m.prom"], ["--torch-profile", "prof"]],
                         ids=lambda f: f[0])
def test_telemetry_flags_need_continuous_mode(flag, capsys):
    with pytest.raises(SystemExit):
        serve.parse_args(["--arch", "sru-paper-small", "--device", "cpu"] + flag)
    assert "require --mode continuous" in capsys.readouterr().err
    args = serve.parse_args(["--arch", "sru-paper-small", "--mode", "continuous"] + flag)
    assert args.metrics_every == 32


def test_metrics_every_must_be_positive(capsys):
    with pytest.raises(SystemExit):
        serve.parse_args(["--arch", "sru-paper-small", "--mode", "continuous",
                          "--metrics-every", "0"])
    assert "--metrics-every must be >= 1" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# The profiler seam
# ---------------------------------------------------------------------------

def test_torch_profile_seam(tmp_path, monkeypatch):
    """No dir: a no-op that yields False. A dir: the capture runs (True) and
    leaves a ``*.pt.trace.json`` naming the annotations. A profiler that
    fails to start warns and yields False, and the block still runs."""
    with torch_profile(None) as on, torch_profile("", CPU) as on2:
        assert on is False and on2 is False
    with torch_profile(str(tmp_path / "p"), CPU) as on:
        assert on is True
        with annotation("decode"):
            torch.ones(3).sum()
    doc = json.loads(next((tmp_path / "p").glob("*.pt.trace.json")).read_text())
    assert any(e.get("name") == "decode" and e.get("cat") == "user_annotation"
               for e in doc["traceEvents"])

    def broken(*a, **k):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(torch.profiler, "profile", broken)
    ran = []
    with pytest.warns(UserWarning, match="no profiler here"):
        with torch_profile(str(tmp_path / "q"), CPU) as on:
            ran.append(on)
    assert ran == [False]


def _chip_smoke():
    return _load("chip_smoke", REPO / "chip_smoke.py")


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "pid": 7, "tid": tid, "ts": ts, "dur": dur,
         "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def test_profile_split_attributes_device_time_by_correlation():
    """chip_smoke's split of a profile: a warm-up launch before the first
    annotation is left out; a graph replay's kernels count for the phase
    whose annotation holds the ``cudaGraphLaunch`` (even when they run
    during the next phase); a copy launched outside every annotation is
    unattributed; a launch that lost its device events marks its phase
    instance, whose device time the complete instances' mean stands in
    for; host self times are split by phase and call."""
    cs = _chip_smoke()
    ev = [
        _x("cuda_runtime", "cudaLaunchKernel", 0, 5, corr=1),          # warm-up
        _x("kernel", "warm", 10, 50, tid=9, corr=1),
        _x("user_annotation", "prefill", 100, 40),                     # instance 0
        _x("cpu_op", "aten::copy_", 105, 10),
        _x("cuda_runtime", "cudaMemcpyAsync", 107, 5, corr=2),
        _x("cuda_runtime", "cudaGraphLaunch", 120, 15, corr=3),
        _x("cuda_runtime", "cudaMemcpyAsync", 150, 4, corr=4),         # unannotated
        _x("user_annotation", "decode", 160, 30),                      # instance 0, lost
        _x("cuda_runtime", "cudaGraphLaunch", 165, 20, corr=5),
        _x("user_annotation", "decode", 200, 30),                      # instance 1
        _x("cuda_runtime", "cudaGraphLaunch", 205, 20, corr=6),
        _x("user_annotation", "decode", 240, 30),                      # instance 2
        _x("cuda_runtime", "cudaGraphLaunch", 245, 20, corr=7),
        _x("gpu_memcpy", "Memcpy HtoD", 130, 2, tid=9, corr=2),
        _x("kernel", "k_prefill_a", 140, 30, tid=9, corr=3),
        _x("kernel", "k_prefill_b", 171, 10, tid=9, corr=3),
        _x("gpu_memcpy", "Memcpy DtoH", 182, 3, tid=9, corr=4),
        _x("kernel", "k_decode", 230, 8, tid=9, corr=6),
        _x("kernel", "k_decode", 270, 12, tid=9, corr=7),
        _x("gpu_user_annotation", "decode", 230, 8, tid=9),            # not device work
    ]
    split = cs.profile_split({"traceEvents": ev}, ticks=2)
    us = 1e3 * 2  # us per ms, per tick
    assert split["phase_instances"] == {"prefill": 1, "decode": 3}
    assert split["device_events_before_the_run"] == 1
    assert split["device_ms_per_tick_by_phase"]["prefill"] == pytest.approx(42 / us)
    # decode: instance 0 lost its kernels; the mean of (8, 12) stands in
    assert split["device_ms_per_tick_by_phase"]["decode"] == pytest.approx(10 * 3 / us)
    assert split["device_ms_per_tick"] == pytest.approx((42 + 3 + 20) / us)
    assert split["device_ms_per_tick_unattributed"] == pytest.approx(3 / us)
    assert split["unattributed_share"] == pytest.approx(3 / 65)
    assert (split["launching_calls"], split["lost_launching_calls"]) == (6, 1)
    assert split["phase_instances_with_lost_events"] == 1
    assert split["first_lost_call_at"] == split["last_lost_call_at"] == 3
    host = split["host_ms_per_tick_by_phase"]
    assert host["prefill"]["ms_per_tick"] == pytest.approx(40 / us)
    calls = dict(host["prefill"]["calls_ms_per_tick"])
    assert calls == pytest.approx({"(python)": 15 / us, "cudaGraphLaunch": 15 / us,
                                   "aten::copy_": 5 / us, "cudaMemcpyAsync": 5 / us})
    assert host["decode"]["ms_per_tick"] == pytest.approx(90 / us)
    assert dict(host["decode"]["calls_ms_per_tick"])["cudaGraphLaunch"] == pytest.approx(60 / us)
    assert host["unannotated"]["calls_ms_per_tick"] == [["cudaMemcpyAsync", pytest.approx(4 / us)]]
    assert split["graph_launch_device_events"] == {"prefill": [2], "decode": [0, 1]}
    assert split["device_us_by_name"] == {
        "prefill": {"Memcpy HtoD": [2, 1], "k_prefill_a": [30, 1], "k_prefill_b": [10, 1]},
        "unannotated": {"Memcpy DtoH": [3, 1]}, "decode": {"k_decode": [20, 2]}}
    assert cs.profile_split({"traceEvents": ev[:2]}, ticks=1) is None
    # other phases (chip_smoke's profile window): from the first decode on
    only = cs.profile_split({"traceEvents": ev}, ticks=3, phases=("decode",))
    assert only["phase_instances"] == {"decode": 3}
    assert only["device_events_before_the_run"] == 5
    assert only["device_us_by_name"] == {"decode": {"k_decode": [20, 2]}}
    assert only["lost_launching_calls"] == 1 and "prefill" not in only["host_ms_per_tick_by_phase"]
    # the complete instances: decode's instance 0 lost its kernels
    assert split["complete_instances"] == {"prefill": 1, "decode": 2}
    assert split["device_us_by_name_complete"] == {
        "prefill": {"Memcpy HtoD": [2, 1], "k_prefill_a": [30, 1], "k_prefill_b": [10, 1]},
        "decode": {"k_decode": [20, 2]}}


def test_profile_split_leaves_out_a_partial_graph_replay():
    """A replay of the phase's graph with fewer device events than its
    fullest replay lost some to the profiler: its instance is not complete,
    and the complete instances' events are counted alone; an eager launch
    without device events leaves its instance out as well."""
    cs = _chip_smoke()
    ev = [_x("user_annotation", "w", 0, 10), _x("cuda_runtime", "cudaGraphLaunch", 1, 5, corr=1),
          _x("user_annotation", "w", 20, 10), _x("cuda_runtime", "cudaGraphLaunch", 21, 5, corr=2),
          _x("user_annotation", "w", 40, 10), _x("cuda_runtime", "cudaGraphLaunch", 41, 5, corr=3),
          _x("cuda_runtime", "cudaLaunchKernel", 46, 2, corr=4),     # lost: no device event
          _x("user_annotation", "w", 60, 10), _x("cuda_runtime", "cudaGraphLaunch", 61, 5, corr=5)]
    for corr, names in ((1, "ab"), (2, "a"), (3, "ab"), (5, "ab")):  # replay 2 lost its b
        ev += [_x("kernel", f"k_{n}", 100 * corr + j, 4, tid=9, corr=corr)
               for j, n in enumerate(names)]
    split = cs.profile_split({"traceEvents": ev}, ticks=4, phases=("w",))
    assert split["graph_launch_device_events"] == {"w": [1, 2]}
    assert split["lost_launching_calls"] == 1
    assert split["complete_instances"] == {"w": 2}
    assert split["device_us_by_name_complete"] == {"w": {"k_a": [8, 2], "k_b": [8, 2]}}
    assert split["device_us_by_name"] == {"w": {"k_a": [16, 4], "k_b": [12, 3]}}
