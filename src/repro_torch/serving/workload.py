"""Synthetic open-loop traffic for the serving engine, the port's copy of
``repro/serving/workload.py``: every generator is seed-pinned as there, so
both packages replay the identical request sequence.

Open-loop means arrival times are fixed *before* the run (a Poisson process at
``rate`` requests/second): requests keep arriving whether or not the engine
keeps up, so queueing — not just per-step speed — is what the trace measures
(Thakker et al.'s point that scheduling dominates RNN serving efficiency).

Generation lengths default to a bimodal mix (mostly short interactive turns,
a tail of long generations) because that mix is what lockstep batching is
worst at: every lane in a lockstep batch waits for the batch's longest
generation. The same trace replayed against the lockstep batch path is the
baseline in the JAX package's ``benchmarks/continuous_batching.py``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.queue import Request

# (length, weight) pairs: 80% short turns, 20% long-tail generations.
DEFAULT_GEN_MIX: Tuple[Tuple[int, float], ...] = ((8, 0.8), (96, 0.2))


def poisson_trace(
    n_requests: int,
    *,
    rate: float,
    prompt_lens: Sequence[int],
    gen_mix: Sequence[Tuple[int, float]] = DEFAULT_GEN_MIX,
    vocab: int,
    seed: int = 0,
    gen_cap: Optional[int] = None,
) -> List[Request]:
    """Sample an arrival-ordered list of Requests.

    ``rate`` <= 0 means all requests arrive at t=0 (a closed burst — the
    saturation case). ``prompt_lens`` is the set prompts are drawn from
    uniformly; ``gen_mix`` is a (length, weight) mixture for max_new_tokens.
    """
    rng = np.random.default_rng(seed)
    if rate > 0:
        arrivals = np.cumsum(rng.exponential(1.0 / rate, size=n_requests))
    else:
        arrivals = np.zeros(n_requests)
    lens, weights = zip(*gen_mix)
    weights = np.asarray(weights, dtype=np.float64)
    weights = weights / weights.sum()
    reqs = []
    for i in range(n_requests):
        p = int(rng.choice(np.asarray(prompt_lens)))
        g = int(rng.choice(np.asarray(lens), p=weights))
        if gen_cap:
            g = min(g, gen_cap)
        prompt = rng.integers(0, vocab, size=p, dtype=np.int32)
        reqs.append(
            Request(rid=i, prompt=prompt, max_new_tokens=g, arrival=float(arrivals[i]))
        )
    return reqs


def shared_prefix_trace(
    n_requests: int,
    *,
    rate: float,
    prefix_len: int,
    prompt_len: int,
    share: float,
    gen_mix: Sequence[Tuple[int, float]] = DEFAULT_GEN_MIX,
    vocab: int,
    seed: int = 0,
    gen_cap: Optional[int] = None,
) -> List[Request]:
    """Poisson arrivals where a ``share`` fraction of requests open with one
    common ``prefix_len``-token prefix (a system prompt / few-shot header —
    the workload the prefix cache exists for); the rest of each prompt, and
    all non-sharing prompts, are fresh random tokens. ``share`` = 0 degrades
    to ``poisson_trace``-like traffic, 1.0 means every prompt extends the
    shared prefix."""
    if not 0.0 <= share <= 1.0:
        raise ValueError("share must be in [0, 1]")
    if not 0 <= prefix_len <= prompt_len:
        raise ValueError("need 0 <= prefix_len <= prompt_len")
    rng = np.random.default_rng(seed)
    if rate > 0:
        arrivals = np.cumsum(rng.exponential(1.0 / rate, size=n_requests))
    else:
        arrivals = np.zeros(n_requests)
    lens, weights = zip(*gen_mix)
    weights = np.asarray(weights, dtype=np.float64)
    weights = weights / weights.sum()
    prefix = rng.integers(0, vocab, size=prefix_len, dtype=np.int32)
    reqs = []
    for i in range(n_requests):
        g = int(rng.choice(np.asarray(lens), p=weights))
        if gen_cap:
            g = min(g, gen_cap)
        shared = rng.random() < share
        tail = rng.integers(
            0, vocab, size=prompt_len - (prefix_len if shared else 0), dtype=np.int32
        )
        prompt = np.concatenate([prefix, tail]) if shared else tail
        reqs.append(
            Request(rid=i, prompt=prompt, max_new_tokens=g, arrival=float(arrivals[i]))
        )
    return reqs


def clone_trace(trace: Sequence[Request]) -> List[Request]:
    """Fresh Request objects for replaying one trace against another engine
    (Requests accumulate emitted tokens, so runs must not share them)."""
    return [
        Request(
            rid=r.rid,
            prompt=r.prompt.copy(),
            max_new_tokens=r.max_new_tokens,
            arrival=r.arrival,
            speculative=r.speculative,
        )
        for r in trace
    ]


# ---------------------------------------------------------------------------
# The shared headline trace
# ---------------------------------------------------------------------------

#: Full-mode workload of the JAX package's serving benchmarks. Both its
#: ``benchmarks/continuous_batching.py`` and ``benchmarks/speculative.py``
#: build their trace through ``headline_poisson_trace`` with these defaults,
#: so their numbers are measured on the IDENTICAL request sequence (same
#: arrivals, prompts, and generation budgets — every RNG below is an explicit
#: per-call ``default_rng(seed)``; there is deliberately no module-level RNG
#: anywhere in this file). ``tests/test_torch_engine.py`` asserts that the
#: port's copy replays the JAX package's trace.
HEADLINE_TRACE = dict(requests=128, rate=150.0, prompt_len=32, seed=0)


def headline_poisson_trace(
    vocab: int,
    *,
    requests: int = HEADLINE_TRACE["requests"],
    rate: float = HEADLINE_TRACE["rate"],
    prompt_len: int = HEADLINE_TRACE["prompt_len"],
    gen_mix: Sequence[Tuple[int, float]] = DEFAULT_GEN_MIX,
    seed: int = HEADLINE_TRACE["seed"],
) -> List[Request]:
    """The benchmark suite's shared Poisson trace (seed-pinned)."""
    return poisson_trace(
        requests,
        rate=rate,
        prompt_lens=[prompt_len],
        gen_mix=gen_mix,
        vocab=vocab,
        seed=seed,
    )
