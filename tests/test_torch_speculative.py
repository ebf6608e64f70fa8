"""Speculative multi-token decode in the port (``repro_torch``), on the CPU.

Against the JAX package, on bridged params: ``lm_verify`` and
``build_verify_step`` (every position's logits, the per-position argmax,
the merged caches) under the ``sequential``, ``chunked``, ``pallas``,
``fused``, ``fused_stack`` and int8 ``fused_stack`` engines, logits and
caches within 3e-5, tokens equal, the lanes outside the mask bitwise; and
the port's speculative ``Scheduler`` against JAX's on the same trace, target
and draft, at k = 4 and async depth 2 under two engines: the same tokens,
every speculative counter equal, the traced logits rows within 3e-5.

Inside the port, the reference's own checks (JAX
``tests/test_speculative.py``): speculative == plain greedy for every engine,
k in {1, 2, 4, 8} and depth 1 and 2 (tokens equal, logits rows within
JAX's 2e-6 of the plain run's, whose rows come from decode steps, not from
the verify chunk); k = 1 is plain decode; the oracle draft accepts every
block; an adversarial draft rolls back and stays exact; an EOS inside a
block stops the stream there; spec and plain lanes side by side; the
metrics of a finish inside a block; the validation errors; the draft block
against k single draft steps; and the rollback round trip (verify, then
inject the pre-block snapshot) as a property. Under ``sequential`` a verify
chunk of k tokens equals k masked decode steps bit for bit here: at B = 3
PyTorch's CPU BLAS sums the B * k-row products of the chunk as it sums the
B-row products of a step (the one-row GEMV path of ROADMAP §C is not met).
"""
from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._hypothesis_compat import given, settings, strategies as st

from repro.configs.registry import get_config as jax_get_config
from repro.models import lm as jlm
from repro.serving import Request as JaxRequest
from repro.serving import Scheduler as JaxScheduler
from repro.training import steps as jsteps
from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.launch import serve
from repro_torch.models import lm, rnn
from repro_torch.serving import Request, Scheduler, clone_trace
from repro_torch.training import steps
from repro_torch.training.graphs import leaves

CPU = "cpu"
TOL = 3e-5          # a stack's logits and caches against JAX (tests/test_rnn_stack.py)
SPEC_ROW_TOL = 2e-6  # a verify row against the plain decode's row (JAX's bar)
SPEC_KS = [1, 2, 4, 8]
SPEC_COUNTERS = ("verify_steps", "draft_steps", "spec_cycles", "spec_proposed", "spec_accepted",
                 "spec_emitted_tokens", "spec_discarded_tokens", "spec_rollbacks", "decode_steps",
                 "prefill_chunks")

# (prompt_len, max_new_tokens): a sub-chunk tail, an exact chunk, chunks and
# a tail, and generations shorter than, spanning and far past a k = 8 block
# (JAX's ``_SHAPES``).
_SHAPES = [(4, 5), (6, 3), (15, 10), (12, 2), (5, 7)]


class FakeClock:
    """An engine clock that moves 1 ms at every read."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        self.t += 1e-3
        return self.t


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfgs(arch, engine):
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    if engine:
        jcfg, cfg = jcfg.with_(scan_engine=engine), cfg.with_(scan_engine=engine)
    return jcfg, cfg


def _bridged(arch, engine, seed):
    """(port cfg, port params, JAX cfg, JAX params): JAX's params, bridged."""
    jcfg, cfg = _cfgs(arch, engine)
    jparams = jlm.lm_init(jax.random.PRNGKey(seed), jcfg)
    return cfg, bridge.params_from_numpy(_np(jparams), device=CPU), jcfg, jparams


def _trace(vocab, shapes=_SHAPES, seed=0, **kw):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, vocab, size=p, dtype=np.int32),
                    max_new_tokens=g, **kw) for i, (p, g) in enumerate(shapes)]


# ---------------------------------------------------------------------------
# lm_verify and build_verify_step against JAX's
# ---------------------------------------------------------------------------

VERIFY_CASES = [
    ("sru-paper-small", "sequential"), ("qrnn-paper-small", "chunked"),
    ("sru-paper-small", "pallas"), ("qrnn-paper-large-fused", None),
    ("sru-paper-large-stacked", None), ("qrnn-paper-large-stacked-int8", None),
]
B_VERIFY = 3


def _close(got, want, what):
    for g, w in zip(jax.tree_util.tree_leaves(bridge.caches_to_numpy(got)),
                    jax.tree_util.tree_leaves(_np(want))):
        assert g.shape == w.shape, what
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL, err_msg=what)


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("arch,engine", VERIFY_CASES)
def test_verify_step_matches_jax(arch, engine, k):
    """A prefilled pool (random prompts), then one verify block of k tokens
    on lanes 0 and 2: ``lm_verify``'s logits and caches, and the step's
    per-position tokens, logits and merged caches, against JAX's; the step
    writes the pool in place and lane 1 keeps its bits."""
    cfg, params, jcfg, jparams = _bridged(arch, engine, seed=3)
    rng = np.random.default_rng(k)
    prompt = rng.integers(0, cfg.vocab, (B_VERIFY, 9))
    jcaches = jlm.lm_init_caches(jcfg, B_VERIFY, 1)
    _, jcaches = jlm.lm_prefill(jparams, jcfg, {"inputs": jnp.asarray(prompt, jnp.int32)},
                                jcaches)
    caches = bridge.caches_from_numpy(_np(jcaches), device=CPU)
    tokens = rng.integers(0, cfg.vocab, (B_VERIFY, k))
    mask = np.array([True, False, True])

    j_logits, j_new = jlm.lm_verify(jparams, jcfg, {"inputs": jnp.asarray(tokens, jnp.int32)},
                                    jcaches)
    with torch.inference_mode():
        logits, new = lm.lm_verify(params, cfg, {"inputs": torch.from_numpy(tokens)}, caches)
    assert logits.shape == (B_VERIFY, k, cfg.padded_vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), rtol=0, atol=TOL)
    _close(new, j_new, "lm_verify caches")

    want = jsteps.build_verify_step(jcfg, chunk=k)(
        jparams, jcaches, jnp.asarray(tokens, jnp.int32), jnp.asarray(mask))
    before = [t.clone() for t in leaves(caches)]
    ptrs = [t.data_ptr() for t in leaves(caches)]
    tok, logits, out = steps.build_verify_step(cfg, chunk=k)(
        params, caches, torch.from_numpy(tokens), torch.from_numpy(mask))
    assert out is caches and [t.data_ptr() for t in leaves(caches)] == ptrs
    assert tok.shape == (B_VERIFY, k) and np.array_equal(tok.numpy(), np.asarray(want[0]))
    assert torch.equal(tok, logits[..., : cfg.vocab].argmax(-1))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want[1]), rtol=0, atol=TOL)
    _close(caches, want[2], "verify step caches")
    for a, b in zip(leaves(caches), before):
        assert torch.equal(a[:, 1], b[:, 1])
    with pytest.raises(ValueError, match=f"chunk {k}"):
        steps.build_verify_step(cfg, chunk=k)(params, caches, torch.zeros((B_VERIFY, k + 1),
                                                                          dtype=torch.int64),
                                              torch.from_numpy(mask))


# ---------------------------------------------------------------------------
# The port's speculative Scheduler against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("draft", ["floor", "oracle"])
@pytest.mark.parametrize("arch,engine", [("sru-paper-small", "sequential"),
                                         ("qrnn-paper-large-stacked", None)])
def test_speculative_scheduler_matches_the_jax_scheduler(arch, engine, draft):
    """JAX's ``_SHAPES`` trace through both speculative Schedulers (B = 2,
    chunk 6, k = 4, async depth 2, each on a fake clock) with the same
    target and draft params (the floor: ``sru-paper-draft`` from key 1; the
    oracle: the target itself): the same tokens, every speculative counter
    equal, every emitted token's logits row within 3e-5."""
    cfg, params, jcfg, jparams = _bridged(arch, engine, seed=0)
    if draft == "floor":
        dcfg, dparams, jdcfg, jdparams = _bridged("sru-paper-draft", None, seed=1)
    else:
        dcfg, dparams, jdcfg, jdparams = cfg, params, jcfg, jparams
    trace = _trace(cfg.vocab)
    kw = dict(batch=2, chunk=6, trace_logits=True, async_depth=2, spec_k=4, clock=FakeClock())
    mine = Scheduler(cfg, params, draft_cfg=dcfg, draft_params=dparams, device=CPU, **kw)
    kw["clock"] = FakeClock()
    ref = JaxScheduler(jcfg, jparams, draft_cfg=jdcfg, draft_params=jdparams, **kw)
    got = {r.rid: r.tokens for r in mine.run(clone_trace(trace), max_ticks=800)}
    want = {r.rid: r.tokens for r in ref.run(
        [JaxRequest(rid=r.rid, prompt=r.prompt.copy(), max_new_tokens=r.max_new_tokens)
         for r in trace], max_ticks=800)}
    assert got == want and sorted(got) == list(range(len(trace)))
    mrep, rrep = mine.metrics.report(), ref.metrics.report()
    assert {c: mrep[c] for c in SPEC_COUNTERS} == {c: rrep[c] for c in SPEC_COUNTERS}
    assert mrep["verify_steps"] > 0
    assert (mrep["spec_rollbacks"] > 0) == (draft == "floor")
    for rid in got:
        assert len(mine.logit_trace[rid]) == len(ref.logit_trace[rid]) == len(got[rid])
        for a, b in zip(mine.logit_trace[rid], ref.logit_trace[rid]):
            np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=TOL)
    assert mine.cache_in_place and mine.idle


# ---------------------------------------------------------------------------
# The reference's checks, inside the port
# ---------------------------------------------------------------------------

ENGINE_CASES = [
    ("sru-paper-small", "sequential"),
    ("sru-paper-small", "fused"),
    ("sru-paper-large-stacked", "fused_stack"),
    ("qrnn-paper-small", "chunked"),
]
_MODELS, _BASELINES = {}, {}


def _model(arch, engine):
    if (arch, engine) not in _MODELS:
        cfg = get_config(arch).reduced().with_(scan_engine=engine)
        _MODELS[(arch, engine)] = (cfg, lm.lm_init(torch.Generator().manual_seed(0), cfg,
                                                   device=CPU))
    return _MODELS[(arch, engine)]


def _baseline(arch, engine):
    """The plain greedy run of ``_SHAPES`` (B = 2, chunk 6), once per module:
    what every speculative run must reproduce."""
    if (arch, engine) not in _BASELINES:
        cfg, params = _model(arch, engine)
        trace = _trace(cfg.vocab)
        eng = Scheduler(cfg, params, batch=2, chunk=6, trace_logits=True, device=CPU)
        done = eng.run(clone_trace(trace), max_ticks=500)
        assert sorted(r.rid for r in done) == list(range(len(trace)))
        _BASELINES[(arch, engine)] = (trace, {r.rid: list(r.tokens) for r in done},
                                      dict(eng.logit_trace))
    return _BASELINES[(arch, engine)]


def _draft(seed=1):
    dcfg = get_config("sru-paper-draft").reduced()
    return dcfg, lm.lm_init(torch.Generator().manual_seed(seed), dcfg, device=CPU)


def _spec(cfg, params, draft_cfg, draft_params, k, **kw):
    return Scheduler(cfg, params, batch=2, chunk=kw.pop("chunk", 6), draft_cfg=draft_cfg,
                     draft_params=draft_params, spec_k=k, device=CPU, **kw)


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("k", SPEC_KS)
@pytest.mark.parametrize("arch,engine", ENGINE_CASES)
def test_speculative_matches_plain_greedy(arch, engine, k, depth):
    """A random draft (rejection-heavy) gives the plain engine's greedy
    stream for every block width and both async depths; each emitted token's
    logits row (from the verify chunk) within 2e-6 of the plain row (from a
    decode step)."""
    cfg, params = _model(arch, engine)
    trace, ref_toks, ref_rows = _baseline(arch, engine)
    eng = _spec(cfg, params, *_draft(), k, trace_logits=True, async_depth=depth)
    done = eng.run(clone_trace(trace), max_ticks=800)
    assert sorted(r.rid for r in done) == list(range(len(trace)))
    for r in done:
        assert list(r.tokens) == ref_toks[r.rid], r.rid
        assert len(eng.logit_trace[r.rid]) == len(ref_rows[r.rid]) == len(r.tokens)
        for step, (a, b) in enumerate(zip(eng.logit_trace[r.rid], ref_rows[r.rid])):
            np.testing.assert_allclose(a, b, rtol=0, atol=SPEC_ROW_TOL,
                                       err_msg=f"rid {r.rid} step {step}")
    assert eng.metrics.verify_steps > 0 and eng.cache_in_place and eng.idle


def test_k1_degenerates_to_plain_decode():
    """k = 1 never proposes: every block replays the one queued token, so
    the verify chunk is the plain decode step and nothing rolls back."""
    cfg, params = _model("sru-paper-small", "fused")
    trace, ref_toks, _ = _baseline("sru-paper-small", "fused")
    eng = _spec(cfg, params, *_draft(), 1)
    done = eng.run(clone_trace(trace), max_ticks=800)
    assert {r.rid: list(r.tokens) for r in done} == ref_toks
    rep = eng.metrics.report()
    assert rep["spec_proposed"] == 0 and rep["spec_rollbacks"] == 0
    assert rep["spec_acceptance_rate"] == 0.0


def test_oracle_draft_accepts_every_block():
    """The target as its own draft (params shared, a pool of its own): every
    proposal is the target's argmax, so every block is accepted whole."""
    cfg, params = _model("sru-paper-small", "fused")
    trace, ref_toks, _ = _baseline("sru-paper-small", "fused")
    eng = _spec(cfg, params, cfg, params, 4)
    done = eng.run(clone_trace(trace), max_ticks=800)
    assert {r.rid: list(r.tokens) for r in done} == ref_toks
    rep = eng.metrics.report()
    assert rep["spec_rollbacks"] == 0 and rep["spec_acceptance_rate"] == 1.0
    assert rep["accepted_tokens_per_cycle"] > 1.0


def test_adversarial_draft_still_exact():
    """The target's own arch from another seed at k = 8: plausible, wrong,
    many rollbacks, and not one token changed."""
    cfg, params = _model("sru-paper-small", "fused")
    trace, ref_toks, _ = _baseline("sru-paper-small", "fused")
    wrong = lm.lm_init(torch.Generator().manual_seed(99), cfg, device=CPU)
    eng = _spec(cfg, params, cfg, wrong, 8)
    done = eng.run(clone_trace(trace), max_ticks=800)
    assert {r.rid: list(r.tokens) for r in done} == ref_toks
    rep = eng.metrics.report()
    assert rep["spec_rollbacks"] > 0 and rep["spec_acceptance_rate"] < 1.0


def test_eos_finish_inside_a_speculated_block():
    """An EOS sampled mid-block stops the stream AT the EOS (the block's
    later tokens are dropped), as the plain engine stops."""
    cfg, params = _model("sru-paper-small", "fused")
    trace = _trace(cfg.vocab, shapes=[(5, 12), (7, 12), (4, 12), (9, 12)], seed=3)
    probe = _spec(cfg, params, cfg, params, 4)
    eos = next(int(r.tokens[len(r.tokens) // 2])
               for r in probe.run(clone_trace(trace), max_ticks=800) if len(r.tokens) >= 3)
    plain = Scheduler(cfg, params, batch=2, chunk=6, eos_id=eos, device=CPU)
    ref = {r.rid: list(r.tokens) for r in plain.run(clone_trace(trace), max_ticks=800)}
    spec = _spec(cfg, params, cfg, params, 4, eos_id=eos)
    got = {r.rid: list(r.tokens) for r in spec.run(clone_trace(trace), max_ticks=800)}
    assert got == ref
    assert [t for t in got.values() if t and t[-1] == eos and len(t) < 12]
    assert not any(eos in t[:-1] for t in got.values())


def test_mixed_speculative_and_plain_streams():
    """Streams pinned plain (``speculative=False``) on a speculative engine
    decode as on a plain engine, beside speculating lanes."""
    cfg, params = _model("sru-paper-small", "fused")
    trace, ref_toks, _ = _baseline("sru-paper-small", "fused")
    mixed = clone_trace(trace)
    for r in mixed:
        if r.rid % 2:
            r.speculative = False
    eng = _spec(cfg, params, cfg, params, 4, async_depth=2)
    done = eng.run(mixed, max_ticks=800)
    assert {r.rid: list(r.tokens) for r in done} == ref_toks
    assert eng.metrics.verify_steps > 0 and eng.metrics.decode_steps > 0


def test_spec_metrics_finalize_on_mid_block_finish():
    """Two streams, oracle draft, k = 4, 4 new tokens each: one prefill
    token, then one accepted block of which 3 tokens fit; the 4th is counted
    in ``spec_discarded_tokens`` and nowhere else (JAX's hand count)."""
    cfg, params = _model("sru-paper-small", "fused")
    trace = _trace(cfg.vocab, shapes=[(4, 4), (4, 4)], seed=5)
    eng = _spec(cfg, params, cfg, params, 4, chunk=8)
    done = eng.run(trace, max_ticks=200)
    assert sorted(r.rid for r in done) == [0, 1] and all(len(r.tokens) == 4 for r in done)
    rep = eng.metrics.report()
    assert (rep["spec_cycles"], rep["spec_proposed"], rep["spec_accepted"],
            rep["spec_emitted_tokens"], rep["spec_discarded_tokens"],
            rep["spec_rollbacks"]) == (2, 6, 6, 6, 2, 0)
    assert rep["spec_acceptance_rate"] == 1.0 and rep["accepted_tokens_per_cycle"] == 3.0
    assert rep["emitted_tokens"] == rep["completed_tokens"] == 8
    for t in eng.metrics.requests.values():
        assert t.new_tokens == 4 and t.ttft is not None and t.tpot is not None


def test_engine_validation():
    cfg, params = _model("sru-paper-small", "fused")
    dcfg, dparams = _draft()
    with pytest.raises(ValueError, match="draft_params"):
        Scheduler(cfg, params, batch=2, draft_cfg=dcfg, device=CPU)
    with pytest.raises(ValueError, match="vocab"):
        Scheduler(cfg, params, batch=2, draft_cfg=dcfg.with_(vocab=7), draft_params=dparams,
                  device=CPU)
    with pytest.raises(ValueError, match="spec_k"):
        Scheduler(cfg, params, batch=2, draft_cfg=dcfg, draft_params=dparams, spec_k=0,
                  device=CPU)
    with pytest.raises(ValueError, match="mutually exclusive"):
        Scheduler(cfg, params, batch=2, draft_cfg=dcfg, draft_params=dparams,
                  prefix_cache_mb=4.0, device=CPU)
    with pytest.raises(ValueError, match="pure-RNN"):
        Scheduler(cfg, params, batch=2, draft_cfg=get_config("llama3-8b").reduced(),
                  draft_params={}, device=CPU)


def test_draft_block_equals_k_single_draft_steps():
    """The draft block step (one graph on the card) against k masked decode
    steps of the draft with the column chosen on the host: the same block,
    the same caches, bit for bit; lanes outside the mask keep their bits."""
    dcfg, dparams = _draft()
    k, B = 5, 3
    rng = np.random.default_rng(0)
    caches = lm.lm_init_caches(dcfg, B, 1, device=CPU)
    with torch.inference_mode():
        _, caches = lm.lm_prefill(dparams, dcfg, {"inputs": torch.from_numpy(
            rng.integers(0, dcfg.vocab, (B, 7)))}, caches)
    host_toks = torch.from_numpy(rng.integers(0, dcfg.vocab, (B, k)))
    host_src = torch.from_numpy(np.arange(k)[None, :] < np.array([[1], [3], [5]]))
    mask = torch.tensor([True, False, True])
    mine = rnn.tree_map(torch.clone, caches)
    block = steps.build_draft_block_step(dcfg, k=k)(dparams, mine, host_toks, host_src, mask)
    ref = rnn.tree_map(torch.clone, caches)
    decode = steps.build_masked_decode_step(dcfg)
    prev, cols = torch.zeros(B, dtype=torch.int64), []
    for p in range(k):
        col = torch.where(host_src[:, p], host_toks[:, p], prev)
        cols.append(col)
        prev, _, _ = decode(dparams, ref, col[:, None], mask)
    assert torch.equal(block, torch.stack(cols, 1))
    assert torch.equal(block[:, :1], host_toks[:, :1]) and torch.equal(block[2], host_toks[2])
    for a, b, c in zip(leaves(mine), leaves(ref), leaves(caches)):
        assert torch.equal(a, b) and torch.equal(a[:, 1], c[:, 1])


# ---------------------------------------------------------------------------
# Rollback property: verify, then inject the snapshot, is a bitwise no-op
# ---------------------------------------------------------------------------

_PROP = {}


def _prop_state():
    """A tiny SRU on ``sequential`` and a prefilled pool of 3 lanes."""
    if not _PROP:
        cfg = get_config("sru-paper-small").reduced().with_(scan_engine="sequential")
        params = lm.lm_init(torch.Generator().manual_seed(0), cfg, device=CPU)
        caches = lm.lm_init_caches(cfg, 3, 1, device=CPU)
        with torch.inference_mode():
            _, caches = lm.lm_prefill(params, cfg, {"inputs": torch.from_numpy(
                np.random.default_rng(0).integers(0, cfg.vocab, (3, 8)))}, caches)
        _PROP.update(cfg=cfg, params=params, caches=caches,
                     decode=steps.build_masked_decode_step(cfg), verify={})
    return _PROP


@settings(max_examples=10, deadline=None)
@given(st.integers(min_value=1, max_value=6), st.integers(min_value=0, max_value=2),
       st.integers(min_value=0, max_value=9999))
def test_verify_rollback_roundtrip_property(k, lane, seed):
    """For any k, lane and block: (a) the verify chunk advances only the
    masked lane; (b) its advanced state equals k masked decode steps bit for
    bit; (c) its tokens are its logits' argmax; (d) injecting the pre-block
    snapshot restores the whole pool bit for bit."""
    p = _prop_state()
    cfg, params = p["cfg"], p["params"]
    caches = rnn.tree_map(torch.clone, p["caches"])
    if k not in p["verify"]:
        p["verify"][k] = steps.build_verify_step(cfg, chunk=k)
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab, (3, k)))
    mask = torch.arange(3) == lane
    orig = [t.clone() for t in leaves(caches)]
    snap = rnn.rnn_cache_extract_lane(caches, lane)
    out, logits, advanced = p["verify"][k](params, caches, tokens, mask)
    assert torch.equal(out, logits[..., : cfg.vocab].argmax(-1))
    for leaf, o in zip(leaves(advanced), orig):
        for b in range(3):
            if b != lane:
                assert torch.equal(leaf[:, b], o[:, b])
    seq = rnn.tree_map(torch.clone, p["caches"])
    for i in range(k):
        p["decode"](params, seq, tokens[:, i: i + 1], mask)
    assert all(torch.equal(a, b) for a, b in zip(leaves(advanced), leaves(seq)))
    restored = rnn.rnn_cache_inject_lane(advanced, lane, snap)
    assert all(torch.equal(a, b) for a, b in zip(leaves(restored), orig))


# ---------------------------------------------------------------------------
# serve --speculative
# ---------------------------------------------------------------------------

def _stats(out: str) -> dict:
    line = next(x for x in out.splitlines() if x.startswith("continuous-stats "))
    return json.loads(line[len("continuous-stats "):])


def test_serve_speculative_gives_the_plain_tokens(capsys):
    """``serve --mode continuous --speculative`` (the reduced draft, seed +
    1) gives the plain run's tokens at k = 2 and 4, prints the speculative
    summary and reports the spec counters; the flags' checks exit."""
    base = ["--arch", "qrnn-paper-large-stacked", "--reduced", "--device", "cpu", "--mode",
            "continuous", "--requests", "6", "--prompt-len", "20", "--gen-len", "10",
            "--arrival-rate", "400"]
    assert serve.main(base) == 0
    plain = _stats(capsys.readouterr().out)
    assert plain["speculative"] is None and plain["verify_steps"] == 0
    for k in ("2", "4"):
        assert serve.main(base + ["--speculative", "--spec-k", k, "--async-depth", "2"]) == 0
        out = capsys.readouterr().out
        spec = _stats(out)
        assert "speculative: draft sru-paper-draft-smoke k=" + k in out
        assert spec["speculative"] == {"draft": "sru-paper-draft-smoke", "k": int(k)}
        assert spec["tokens"] == plain["tokens"] and spec["cache_in_place"]
        assert spec["verify_steps"] > 0 and spec["draft_steps"] >= int(k) * spec["verify_steps"]
    full = ["--arch", "sru-paper-small", "--device", "cpu", "--mode", "continuous"]
    for argv, why in ((base + ["--speculative", "--spec-k", "0"], None),
                      (base + ["--speculative", "--prefix-cache-mb", "4"], "mutually exclusive"),
                      (full + ["--speculative", "--draft-config", "llama3-8b"], "vocab 128256")):
        with pytest.raises(SystemExit) as exc:
            serve.main(argv)
        if why:
            assert why in str(exc.value)
    with pytest.raises(SystemExit):
        serve.main(["--arch", "sru-paper-small", "--reduced", "--device", "cpu",
                    "--speculative"])
