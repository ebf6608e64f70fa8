"""The port's continuous-batching engine (``repro_torch/serving/``) and
``launch/serve.py --mode continuous``, on the CPU.

Against the JAX package: the seed-pinned traffic generators give the same
requests; the trie, queue and telemetry copies behave the same; and the
port's ``Scheduler`` and JAX's replay the same trace, each on an injected
fake clock, under the ``sequential``, ``pallas``, ``fused`` and
``fused_stack`` engines on bridged params: every stream's tokens identical
(fp32 compute) and every traced logits row within 3e-5.

Inside the port, the reference's own engine checks (JAX
``tests/test_continuous_batching.py`` and ``tests/test_prefix_cache.py``):
a stream multiplexed through the engine equals the stream run alone at the
engine's width (bitwise for SRU) and at B = 1 (within 3e-5: PyTorch's CPU
BLAS sums a one-row product, a GEMV, in another order), slot isolation under a mid-flight admit and evict,
backpressure and ``cancel``, the metrics report's schema, the refusal of
attention, Mamba, hybrid and frontend configs (and of speculative decode,
a later slice), prefix hit == cold prefill (bitwise), ``async_depth`` 1 == 2
(with the EOS discard), the empty-prompt seed. Under ``pallas`` a prefill
chunk longer than B3's 64 steps (``--chunk 80``) folds chunk aggregates, so
the engine equals the one-shot prefill within STREAM_TOL (3e-5), not
bitwise; at chunks of at most 64 it is bitwise.
"""
from __future__ import annotations

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
from repro.observability.rolling import P2Quantile as JaxP2Quantile
from repro.observability.rolling import RollingMetrics as JaxRollingMetrics
from repro.observability.trace import TraceRecorder as JaxTraceRecorder
from repro.serving import PrefixCache as JaxPrefixCache
from repro.serving import Scheduler as JaxScheduler
from repro.serving import workload as jworkload
from repro.serving.metrics import EngineMetrics as JaxEngineMetrics
from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.observability import Telemetry
from repro_torch.observability.rolling import P2Quantile, RollingMetrics
from repro_torch.observability.trace import TraceRecorder
from repro_torch.serving import (EngineMetrics, PrefixCache, Request, RequestQueue, Scheduler,
                                 SlotState, clone_trace, headline_poisson_trace, poisson_trace,
                                 shared_prefix_trace, state_nbytes, workload)
from repro_torch.training.graphs import leaves

REPO = Path(__file__).resolve().parents[1]
LOGIT_TOL = 3e-5
STREAM_TOL = 3e-5
CPU = "cpu"


class FakeClock:
    """An engine clock that moves 1 ms at every read: runs are independent
    of the host's speed."""

    def __init__(self, dt: float = 1e-3):
        self.t, self.dt = 0.0, dt

    def __call__(self) -> float:
        self.t += self.dt
        return self.t


def _params(arch, engine=None, seed=0):
    """(port cfg, port params, JAX cfg, JAX params): the JAX package's
    params, bridged."""
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    if engine:
        jcfg, cfg = jcfg.with_(scan_engine=engine), cfg.with_(scan_engine=engine)
    jparams = jlm.lm_init(jax.random.PRNGKey(seed), jcfg)
    params = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device=CPU)
    return cfg, params, jcfg, jparams


def _port(arch, engine=None, seed=0):
    cfg = get_config(arch).reduced()
    if engine:
        cfg = cfg.with_(scan_engine=engine)
    return cfg, lm.lm_init(torch.Generator().manual_seed(seed), cfg, device=CPU)


def _jax_requests(trace):
    from repro.serving import Request as JaxRequest

    return [JaxRequest(rid=r.rid, prompt=r.prompt.copy(), max_new_tokens=r.max_new_tokens,
                       arrival=r.arrival) for r in trace]


def _same_requests(mine, ref):
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        assert (a.rid, a.max_new_tokens, a.arrival) == (b.rid, b.max_new_tokens, b.arrival)
        assert a.prompt.dtype == b.prompt.dtype and np.array_equal(a.prompt, b.prompt)


# ---------------------------------------------------------------------------
# Host-side copies against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["poisson", "poisson_burst", "shared_prefix", "headline"])
def test_traffic_is_the_jax_package_traffic(kind):
    """Every generator is seed-pinned as in JAX: the same requests, arrivals
    and budgets (the headline trace is the JAX benchmarks' shared one)."""
    if kind == "headline":
        assert workload.HEADLINE_TRACE == jworkload.HEADLINE_TRACE
        _same_requests(headline_poisson_trace(256), jworkload.headline_poisson_trace(256))
        return
    if kind == "shared_prefix":
        kw = dict(rate=80.0, prefix_len=16, prompt_len=40, share=0.6, vocab=300, seed=4,
                  gen_cap=50)
        _same_requests(shared_prefix_trace(20, **kw), jworkload.shared_prefix_trace(20, **kw))
        return
    kw = dict(rate=50.0 if kind == "poisson" else 0.0, prompt_lens=[4, 8, 31], vocab=100,
              seed=7, gen_mix=((3, 0.3), (12, 0.7)))
    _same_requests(poisson_trace(24, **kw), jworkload.poisson_trace(24, **kw))
    c = clone_trace(poisson_trace(4, **kw))
    c[0].tokens.append(1)
    assert not poisson_trace(4, **kw)[0].tokens


def test_request_queue_arrival_order_and_backpressure():
    q = RequestQueue(capacity=3)
    mk = lambda rid, arrival: Request(rid=rid, prompt=np.arange(1, 5), max_new_tokens=3,  # noqa: E731
                                      arrival=arrival)
    assert q.push(mk(0, 2.0)) and q.push(mk(1, 0.5)) and q.push(mk(2, 1.0))
    assert q.full and not q.push(mk(3, 0.0))
    assert [q.pop().rid for _ in range(3)] == [1, 2, 0]
    assert q.pop() is None
    q.push(mk(7, 1.0))
    q.push(mk(8, 1.0))
    assert q.remove(8).rid == 8 and q.remove(8) is None and q.pop().rid == 7
    with pytest.raises(ValueError, match="prompt"):
        Request(rid=0, prompt=np.zeros((2, 2), np.int32), max_new_tokens=1)
    with pytest.raises(ValueError, match="max_new_tokens"):
        Request(rid=0, prompt=np.arange(3), max_new_tokens=0)


def test_prefix_cache_trie_matches_jax_and_counts_tensor_bytes():
    """The same inserts and lookups give the same boundaries, LRU evictions
    and report in both packages; ``state_nbytes`` counts CPU tensors (the
    port's snapshots) and numpy leaves alike."""
    state = {"layers": {"c": torch.zeros((2, 8)), "x_tail": torch.zeros((2, 1, 8),
                                                                        dtype=torch.bfloat16)}}
    assert state_nbytes(state) == 2 * 8 * 4 + 2 * 8 * 2
    assert state_nbytes({"a": np.zeros(5, np.float32)}) == 20
    budget = 3 * state_nbytes(state)
    mine, ref = PrefixCache(chunk=2, budget_bytes=budget), JaxPrefixCache(chunk=2,
                                                                          budget_bytes=budget)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 4, 6).astype(np.int32) for _ in range(6)]
    for p in prompts:
        for cut in (2, 4):
            assert mine.wants(p[:cut]) == ref.wants(p[:cut])
            assert mine.insert(p[:cut], state) == ref.insert(
                p[:cut], {"a": np.zeros(state_nbytes(state), np.uint8)})
        got, want = mine.lookup(p), ref.lookup(p)
        assert got[0] == want[0] and (got[1] is None) == (want[1] is None)
    assert mine.report() == ref.report()
    assert mine.report()["evicted"] > 0


def test_rolling_metrics_and_trace_match_jax():
    rng = np.random.default_rng(3)
    xs = rng.exponential(0.02, 300)
    mine, ref = P2Quantile(0.95), JaxP2Quantile(0.95)
    for x in xs:
        mine.add(float(x))
        ref.add(float(x))
    assert mine.value() == ref.value()
    rows = []
    for cls in (RollingMetrics, JaxRollingMetrics):
        r = cls(window=8)
        for i, x in enumerate(xs[:40]):
            r.observe_ttft(float(x))
            r.observe_tpot(float(x) / 4)
            r.on_token()
            r.on_tick(0.5 + (i % 3) / 6, i % 5)
            if i % 7 == 0:
                r.on_finish(3)
        rows.append(r.sample(1.5))
    assert rows[0] == rows[1]
    docs = []
    for cls in (TraceRecorder, JaxTraceRecorder):
        clock = FakeClock()
        rec = cls(capacity=4, clock=clock)
        with rec.span("tick", serial=0) as s:
            s.arg("lanes", 2)
            rec.instant("prefix_hit", rid=1)
        rec.async_begin("requests", "request", id=3)
        rec.counter("engine_load", occupancy=0.5)
        rec.async_end("requests", "request", id=3)
        docs.append(rec.to_chrome())
    assert docs[0] == docs[1] and docs[0]["otherData"]["dropped_events"] == 1


# ---------------------------------------------------------------------------
# The port's Scheduler against JAX's
# ---------------------------------------------------------------------------

# (arch, engine override, trace kind): the four engines, SRU and QRNN, and a
# shared-prefix trace with the prefix cache on.
JAX_ENGINE_CASES = [
    ("sru-paper-small", "sequential", "poisson"),
    ("qrnn-paper-small", "pallas", "poisson"),
    ("sru-paper-large-fused", None, "poisson"),
    ("qrnn-paper-large-stacked", None, "poisson"),
    ("sru-paper-large-stacked", None, "shared_prefix"),
]


@pytest.mark.parametrize("arch,engine,kind", JAX_ENGINE_CASES)
def test_scheduler_matches_the_jax_scheduler(arch, engine, kind):
    """The same trace through both Schedulers (batch 3, chunk 16, each on a
    fake clock): the same requests finish with the same tokens, and every
    emitted token's logits row agrees within 3e-5."""
    cfg, params, jcfg, jparams = _params(arch, engine, seed=1)
    if kind == "poisson":
        trace = poisson_trace(9, rate=300.0, prompt_lens=[5, 16, 37], vocab=cfg.vocab, seed=2,
                              gen_mix=((3, 0.5), (9, 0.5)))
        cache_mb = 0.0
    else:
        trace = shared_prefix_trace(9, rate=300.0, prefix_len=16, prompt_len=37, share=0.7,
                                    vocab=cfg.vocab, seed=2, gen_mix=((3, 0.5), (9, 0.5)))
        cache_mb = 4.0
    mine = Scheduler(cfg, params, batch=3, trace_logits=True, prefix_cache_mb=cache_mb,
                     clock=FakeClock(), device=CPU)
    ref = JaxScheduler(jcfg, jparams, batch=3, trace_logits=True, prefix_cache_mb=cache_mb,
                       clock=FakeClock())
    got = {r.rid: r.tokens for r in mine.run(clone_trace(trace), max_ticks=600)}
    want = {r.rid: r.tokens for r in ref.run(_jax_requests(trace), max_ticks=600)}
    assert got == want and sorted(got) == list(range(9))
    for rid in got:
        assert len(mine.logit_trace[rid]) == len(ref.logit_trace[rid]) == len(got[rid])
        for a, b in zip(mine.logit_trace[rid], ref.logit_trace[rid]):
            np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=LOGIT_TOL)
    if cache_mb:
        assert mine.metrics.prefix_hits > 0
    assert mine.cache_in_place and mine.idle


# ---------------------------------------------------------------------------
# The reference's engine checks, inside the port
# ---------------------------------------------------------------------------

def _isolated_logits(cfg, params, prompt, tokens, batch=1):
    """Teacher-forced isolated run of one stream in lane 0 of ``batch``
    lanes (the others idle on placeholder tokens): row i is the
    distribution token i was sampled from."""
    caches = lm.lm_init_caches(cfg, batch, 1, device=CPU)
    inputs = torch.zeros((batch, len(prompt)), dtype=torch.int64)
    inputs[0] = torch.from_numpy(prompt)
    with torch.inference_mode():
        lg, caches = lm.lm_prefill(params, cfg, {"inputs": inputs}, caches)
        rows = [lg[0, -1].numpy()]
        for tok in tokens[:-1]:
            token = torch.zeros((batch, 1), dtype=torch.int64)
            token[0] = tok
            lg, caches = lm.lm_decode_step(params, cfg, caches, token)
            rows.append(lg[0, -1].numpy())
    return rows


ISOLATION_CASES = [
    ("sru-paper-small", "sequential", None),
    ("sru-paper-small", "fused", None),
    ("sru-paper-small", "pallas", None),
    ("sru-paper-large-stacked", "fused_stack", None),
    ("qrnn-paper-small", "chunked", None),
    ("sru-paper-small", "pallas", 80),
]


@pytest.mark.parametrize("arch,engine,chunk", ISOLATION_CASES)
def test_engine_matches_isolated_single_stream(arch, engine, chunk):
    """Streams multiplexed through the engine (queueing, chunked prefill,
    lane recycling) emit the logits of the stream run alone at the engine's
    width: bitwise for SRU, within 2e-6 for QRNN (JAX's bars). Against the
    stream run at B = 1 the logits agree within STREAM_TOL and the tokens
    are the same: on the CPU, PyTorch's BLAS takes another path for a
    one-row product (a GEMV) whose sums differ in the last bits. Under
    ``pallas`` with chunks of 80 (two B3 chunks in a prefill step) the
    one-shot prompt folds its chunks in another order: within STREAM_TOL."""
    cfg, params = _port(arch, engine)
    chunk = chunk or 6
    eng = Scheduler(cfg, params, batch=2, chunk=chunk, trace_logits=True, device=CPU)
    rng = np.random.default_rng(0)
    shapes = [(4, 5), (6, 3), (15, 8), (12, 2), (5, 6)] if chunk == 6 else \
        [(90, 4), (170, 5), (81, 3), (40, 4)]
    trace = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=p, dtype=np.int32),
                     max_new_tokens=g) for i, (p, g) in enumerate(shapes)]
    done = eng.run(clone_trace(trace), max_ticks=600)
    assert sorted(r.rid for r in done) == list(range(len(shapes)))
    for r in sorted(done, key=lambda r: r.rid):
        got_rows = eng.logit_trace[r.rid]
        alone = _isolated_logits(cfg, params, trace[r.rid].prompt, r.tokens, batch=eng.batch)
        one = _isolated_logits(cfg, params, trace[r.rid].prompt, r.tokens)
        assert len(got_rows) == len(alone) == len(one) == r.max_new_tokens
        for step, (a, b, c) in enumerate(zip(got_rows, alone, one)):
            msg = f"rid {r.rid} step {step}"
            if chunk == 80:
                np.testing.assert_allclose(a, b, rtol=0, atol=STREAM_TOL, err_msg=msg)
            elif cfg.cell == "sru":
                np.testing.assert_array_equal(a, b, err_msg=msg)
            else:
                np.testing.assert_allclose(a, b, rtol=0, atol=2e-6, err_msg=msg)
            np.testing.assert_allclose(a, c, rtol=0, atol=STREAM_TOL, err_msg=msg)
        for rows in (alone, one):
            assert r.tokens == [int(np.argmax(row[: cfg.vocab])) for row in rows]


def test_slot_isolation_mid_flight_admit_evict():
    """While stream R0 decodes, other lanes are admitted, chunk-prefilled,
    evicted mid-flight and recycled; R0's tokens equal an uninterrupted
    isolated run's."""
    cfg, params = _port("sru-paper-small", "fused")
    eng = Scheduler(cfg, params, batch=3, chunk=4, device=CPU)
    rng = np.random.default_rng(1)

    def mk(rid, p, g):
        return Request(rid=rid, prompt=rng.integers(0, cfg.vocab, size=p, dtype=np.int32),
                       max_new_tokens=g)

    r0 = mk(0, 9, 30)
    others = [mk(1, 4, 3), mk(2, 11, 25), mk(3, 6, 4), mk(4, 13, 5), mk(5, 3, 6)]
    for r in (r0, others[0], others[1]):
        eng.submit(r)
    churn = {4: others[2], 9: others[3], 15: others[4]}
    finished = []
    for tick in range(120):
        if tick in churn:
            eng.submit(churn[tick])
        if tick == 7:
            assert eng.cancel(2)
            assert not eng.cancel(99)
        finished.extend(eng.tick())
        if len(r0.tokens) >= r0.max_new_tokens and eng.idle:
            break
    assert len(r0.tokens) == r0.max_new_tokens
    assert others[1].cancelled and len(others[1].tokens) < others[1].max_new_tokens
    assert {r.rid for r in finished} >= {0, 1, 3, 4, 5}
    for r in [r0, others[2], others[3], others[4]]:
        rows = _isolated_logits(cfg, params, r.prompt, r.tokens, batch=eng.batch)
        assert r.tokens == [int(np.argmax(row[: cfg.vocab])) for row in rows], r.rid


def test_backpressure_admission_recycling_and_cancel():
    cfg, params = _port("sru-paper-small")
    eng = Scheduler(cfg, params, batch=2, chunk=4, queue_capacity=2, device=CPU)
    trace = poisson_trace(9, rate=0.0, prompt_lens=[4], vocab=cfg.vocab, seed=2,
                          gen_mix=((3, 1.0),))
    assert len(eng.run(trace, max_ticks=300)) == 9
    rep = eng.metrics.report()
    assert rep["backpressure_stalls"] > 0 and rep["completed"] == rep["admitted"] == 9
    assert all(s.state is SlotState.FREE for s in eng.pool)
    # a request withdrawn while queued never takes a slot
    eng = Scheduler(cfg, params, batch=1, chunk=4, queue_capacity=4, device=CPU)
    for rid in range(3):
        assert eng.submit(Request(rid=rid, prompt=np.arange(1, 5), max_new_tokens=4))
    eng.tick()
    assert eng.cancel(1)
    assert sorted(r.rid for r in eng.run(max_ticks=100)) == [0, 2]
    rep = eng.metrics.report()
    assert rep["cancelled"] == 1 and rep["admitted"] == 2
    assert not eng.metrics.requests[1].new_tokens


def test_metrics_report_schema_and_sanity():
    cfg, params = _port("sru-paper-small")
    rolling = RollingMetrics(window=16)
    rows = []
    tel = Telemetry(trace=TraceRecorder(), rolling=rolling, metrics_every=4,
                    metrics_writer=type("W", (), {"write": lambda self, row: rows.append(row)})())
    eng = Scheduler(cfg, params, batch=2, chunk=4, device=CPU, telemetry=tel)
    trace = poisson_trace(4, rate=0.0, prompt_lens=[6], vocab=cfg.vocab, seed=3,
                          gen_mix=((4, 1.0),))
    done = eng.run(trace, max_ticks=200)
    rep = eng.metrics.report()
    ref_keys = set(JaxEngineMetrics(2).report())
    assert ref_keys <= set(rep) and set(rep) - ref_keys == {"busy_s"}
    assert rep["completed"] == 4
    assert rep["completed_tokens"] == sum(r.max_new_tokens for r in done) == 16
    assert 0.0 < rep["occupancy_mean"] <= 1.0 and rep["goodput_tok_s"] > 0
    assert rep["ttft_s"]["p95"] >= rep["ttft_s"]["p50"] >= 0.0
    assert 0.0 < rep["busy_s"] <= rep["elapsed_s"]
    for t in eng.metrics.requests.values():
        assert t.ttft is not None and t.ttft >= 0.0
        assert t.tpot is not None and t.tpot >= 0.0
    names = {e["name"] for e in tel.trace.events()}
    assert {"tick", "recycle", "admit", "prefill", "decode", "retire", "fetch"} <= names
    assert rows and rows[-1]["completed"] == 4
    assert isinstance(eng.metrics, EngineMetrics)


def test_engine_refuses_attention_mamba_hybrid_frontend_and_speculative():
    sru = get_config("sru-paper-small").reduced()
    for cfg in (get_config("llama3-8b").reduced(), get_config("mamba2-2.7b").reduced(),
                sru.with_(attn_every=2)):
        with pytest.raises(ValueError, match="RNN"):
            Scheduler(cfg, {}, batch=2, device=CPU)
    with pytest.raises(ValueError, match="frontend"):
        Scheduler(sru.with_(frontend="audio_stub"), {}, batch=2, device=CPU)
    with pytest.raises(NotImplementedError, match="ROADMAP.md §A3"):
        Scheduler(sru, {}, batch=2, device=CPU, draft_cfg=sru, draft_params={})
    with pytest.raises(ValueError, match="async_depth"):
        Scheduler(sru, {}, batch=1, async_depth=0, device=CPU)


def test_engine_runs_on_the_card_unless_asked_for_the_cpu():
    cfg, params = _port("sru-paper-small")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Scheduler(cfg, params, batch=2)
    eng = Scheduler(cfg, params, batch=2, device=CPU, graphs=True)
    eng.warmup()
    assert not eng.graphs and not eng.captured and eng.capture_ms is None


CHUNK = 4
HIT_CASES = [
    ("sru-paper-small", "sequential"),
    ("sru-paper-small", "fused"),
    ("sru-paper-small", "pallas"),
    ("sru-paper-large-stacked", "fused_stack"),
    ("qrnn-paper-small", "chunked"),
]


def _warm_then_measure(cfg, params, trace, *, cache_mb, prefix, chunk=CHUNK):
    eng = Scheduler(cfg, params, batch=2, chunk=chunk, trace_logits=True,
                    prefix_cache_mb=cache_mb, device=CPU)
    if cache_mb > 0:
        eng.run([Request(rid=999, prompt=prefix.copy(), max_new_tokens=1)])
    eng.metrics = EngineMetrics(eng.batch)
    eng.run(trace, max_ticks=400)
    return eng


@pytest.mark.parametrize("arch,engine", HIT_CASES)
def test_prefix_hit_matches_cold_prefill(arch, engine):
    """A cache-hit admission (inject + tail-only prefill) gives the cold
    full prefill's logits bitwise for SRU (within 2e-6 for QRNN, JAX's bar),
    and the lane-chunk counter shows the prefix chunks skipped."""
    cfg, params = _port(arch, engine)
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, cfg.vocab, size=2 * CHUNK, dtype=np.int32)
    trace = [Request(rid=i, max_new_tokens=g, prompt=np.concatenate(
                 [prefix, rng.integers(0, cfg.vocab, size=p, dtype=np.int32)]))
             for i, (p, g) in enumerate([(6, 5), (3, 4)])]
    cold = _warm_then_measure(cfg, params, clone_trace(trace), cache_mb=0.0, prefix=prefix)
    warm = _warm_then_measure(cfg, params, clone_trace(trace), cache_mb=8.0, prefix=prefix)
    rep = warm.metrics.report()
    assert rep["prefix_hits"] == 2 and rep["prefix_misses"] == 0
    assert rep["prefix_hit_tokens"] == 2 * len(prefix)
    assert rep["prefill_lane_chunks"] == cold.metrics.report()["prefill_lane_chunks"] - 2 * 2
    for rid in (0, 1):
        a, b = warm.logit_trace[rid], cold.logit_trace[rid]
        assert len(a) == len(b) == trace[rid].max_new_tokens
        for step, (x, y) in enumerate(zip(a, b)):
            if cfg.cell == "sru":
                np.testing.assert_array_equal(x, y, err_msg=f"rid {rid} step {step}")
            else:
                np.testing.assert_allclose(x, y, rtol=0, atol=2e-6, err_msg=f"rid {rid} step {step}")


def test_prefix_hit_matches_cold_prefill_at_a_chunk_longer_than_b3s():
    """Under ``pallas`` with prefill chunks of 80 steps (B3 folds two of its
    64-step chunks inside each): a hit and a cold prefill run the same chunk
    steps, so they stay bitwise."""
    cfg, params = _port("sru-paper-small", "pallas")
    rng = np.random.default_rng(4)
    prefix = rng.integers(0, cfg.vocab, size=80, dtype=np.int32)
    trace = [Request(rid=0, max_new_tokens=4, prompt=np.concatenate(
        [prefix, rng.integers(0, cfg.vocab, size=85, dtype=np.int32)]))]
    cold = _warm_then_measure(cfg, params, clone_trace(trace), cache_mb=0.0, prefix=prefix,
                              chunk=80)
    warm = _warm_then_measure(cfg, params, clone_trace(trace), cache_mb=8.0, prefix=prefix,
                              chunk=80)
    assert warm.metrics.prefix_hits == 1
    for x, y in zip(warm.logit_trace[0], cold.logit_trace[0]):
        np.testing.assert_array_equal(x, y)


def test_prefix_cache_populates_and_evicts_live():
    cfg, params = _port("sru-paper-small")
    eng = Scheduler(cfg, params, batch=2, chunk=CHUNK, prefix_cache_mb=8.0, device=CPU)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=8, dtype=np.int32) for _ in range(2)]
    eng.run([Request(rid=i, prompt=p, max_new_tokens=2) for i, p in enumerate(prompts)],
            max_ticks=200)
    rep = eng.prefix_cache.report()
    assert rep["entries"] == 4 and rep["inserted"] == 4 and rep["evicted"] == 0
    probe = np.concatenate([prompts[0], prompts[0][:1]])
    boundary, state = eng.prefix_cache.lookup(probe)
    assert boundary == 8
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu" for t in leaves(state))
    small = Scheduler(cfg, params, batch=1, chunk=CHUNK, device=CPU,
                      prefix_cache_mb=1.5 * state_nbytes(state) / 2**20)
    small.run([Request(rid=i, prompt=p, max_new_tokens=1) for i, p in enumerate(prompts)],
              max_ticks=200)
    srep = small.prefix_cache.report()
    assert srep["evicted"] >= 1 and srep["entries"] == 1


def _run_depth(cfg, params, trace, depth, **kw):
    eng = Scheduler(cfg, params, batch=3, chunk=4, async_depth=depth, device=CPU, **kw)
    done = eng.run(trace, max_ticks=600)
    return eng, {r.rid: list(r.tokens) for r in done}


def test_async_depth_output_invariance_poisson():
    cfg, params = _port("sru-paper-small", "fused")
    trace = shared_prefix_trace(10, rate=200.0, prefix_len=4, prompt_len=9, share=0.6,
                                gen_mix=((3, 0.6), (9, 0.4)), vocab=cfg.vocab, seed=5)
    _, out1 = _run_depth(cfg, params, clone_trace(trace), 1, prefix_cache_mb=8.0)
    eng2, out2 = _run_depth(cfg, params, clone_trace(trace), 2, prefix_cache_mb=8.0)
    assert sorted(out1) == list(range(10)) and out1 == out2
    assert eng2.idle and eng2.metrics.report()["completed"] == 10


def test_async_depth_eos_step_discarded():
    """At depth 2 an EOS finish is seen one tick after a decode for the
    stream was already dispatched: that token is discarded, and the outputs
    equal depth 1's."""
    cfg, params = _port("sru-paper-small")
    rng = np.random.default_rng(2)
    trace = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=5, dtype=np.int32),
                     max_new_tokens=12) for i in range(4)]
    _, probe = _run_depth(cfg, params, clone_trace(trace), 1)
    eos = next(t[len(t) // 2] for t in probe.values() if len(t) >= 3)
    _, out1 = _run_depth(cfg, params, clone_trace(trace), 1, eos_id=eos)
    _, out2 = _run_depth(cfg, params, clone_trace(trace), 2, eos_id=eos)
    assert out1 == out2
    assert [t for t in out2.values() if t and t[-1] == eos and len(t) < 12]


def test_empty_prompt_decodes_as_seeded_prompt_and_submit_validates():
    cfg, params = _port("sru-paper-small")
    bos = 5
    empty = Request(rid=0, prompt=np.zeros((0,), np.int32), max_new_tokens=6)
    seeded = Request(rid=1, prompt=np.asarray([bos], np.int32), max_new_tokens=6)
    eng = Scheduler(cfg, params, batch=2, bos_id=bos, device=CPU)
    done = eng.run([empty, seeded], max_ticks=100)
    assert sorted(r.rid for r in done) == [0, 1] and eng.idle
    assert empty.tokens == seeded.tokens
    eng2 = Scheduler(cfg, params, batch=1, device=CPU)
    assert eng2._seed_token == 0
    done2 = eng2.run([Request(rid=2, prompt=np.zeros((0,), np.int32), max_new_tokens=2)],
                     max_ticks=50)
    assert len(done2) == 1 and len(done2[0].tokens) == 2
    for bad in ([cfg.vocab], [-1]):
        with pytest.raises(ValueError, match="vocab"):
            eng2.submit(Request(rid=3, prompt=np.asarray(bad, np.int32), max_new_tokens=1))


# ---------------------------------------------------------------------------
# serve --mode continuous
# ---------------------------------------------------------------------------

def _stats(out: str) -> dict:
    line = next(x for x in out.splitlines() if x.startswith("continuous-stats "))
    return json.loads(line[len("continuous-stats "):])


def test_serve_continuous_runs_as_a_module_on_the_cpu():
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "sru-paper-large-stacked",
           "--reduced", "--device", "cpu", "--mode", "continuous", "--requests", "6",
           "--prompt-len", "24", "--gen-len", "8", "--arrival-rate", "500"]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=REPO,
                         env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert "continuous: 6/6 requests" in out.stdout
    stats = _stats(out.stdout)
    assert stats["completed"] == 6 and stats["graphs"] is False and stats["cache_in_place"]
    assert stats["peak_mem_gb"] is None and stats["capture_ms"] is None


def test_serve_continuous_flags_and_tokens(capsys):
    """``main`` in continuous mode: the prefix cache (hits) at async depth 2
    gives the tokens of the cache-off, depth-1 run and of a Scheduler driven
    directly on the same params and trace; ``--headline-trace`` needs the
    continuous mode."""
    base = ["--arch", "qrnn-paper-large-stacked", "--reduced", "--device", "cpu", "--mode",
            "continuous", "--requests", "8", "--prompt-len", "40", "--gen-len", "8",
            "--prefix-share", "0.6", "--arrival-rate", "400"]
    runs = []
    for extra in ([], ["--prefix-cache-mb", "4", "--async-depth", "2", "--queue-cap", "3"]):
        assert serve.main(base + extra) == 0
        runs.append(_stats(capsys.readouterr().out))
    plain, cached = runs
    assert cached["prefix_hits"] > 0 and plain["prefix_cache"] is None
    assert cached["prefix_cache"]["entries"] > 0 and cached["async_depth"] == 2
    assert plain["tokens"] == cached["tokens"] and len(plain["tokens"]) == 8
    cfg = get_config("qrnn-paper-large-stacked").reduced()
    params = lm.lm_init(torch.Generator().manual_seed(0), cfg, device=CPU)
    args = serve.argparse.Namespace(headline_trace=False, gen_len=8, prefix_share=0.6,
                                    prompt_len=40, requests=8, arrival_rate=400.0, seed=0)
    trace = serve.continuous_trace(cfg, args, cfg.mts_block_size)
    done = Scheduler(cfg, params, batch=4, device=CPU).run(trace, max_ticks=500)
    assert {str(r.rid): r.tokens for r in done} == plain["tokens"]
    with pytest.raises(SystemExit):
        serve.main(["--arch", "sru-paper-small", "--reduced", "--device", "cpu",
                    "--headline-trace"])
