"""Continuous-batching scheduler, from ``repro/serving/engine.py``:
slot-multiplexed single streams over the RNN cache, with prefix-sharing
admission and an async tick pipeline.

The paper speeds up ONE stream's math (MTS); this engine makes a system of
it: many independent request streams are multiplexed onto the batch lanes of
one persistent decode step. An RNN stream's whole serving state is a
fixed-size lane of the stacked cache (``models/rnn.py``'s lane ops), so
admission and eviction are lane writes of constant cost: no paging, no
fragmentation, no new shapes.

* **Prefix sharing** (``serving/prefix_cache.py``): a shared prompt prefix is
  one snapshot, so admitting a request that extends a cached prefix is one
  lane inject plus the chunk prefill of its uncached tail.
* **Async tick pipeline**: the host needs only the (B,) next-token array of
  a tick, and even that can wait. Decode feedback stays on the device (the
  next tick's input is composed from the previous step's output there), so
  with ``async_depth=2`` tick t+1's steps are enqueued before tick t's
  results are waited for.

One ``tick()`` is a dispatch, then a retire::

    dispatch (host -> device, no waits)
      1. recycle    DRAINING lanes -> FREE
      2. admission  arrival-ordered requests into FREE lanes; cold lanes
                    share one lane-masked reset; a prefix-cache hit injects
                    the cached snapshot instead and starts at its boundary
                    (empty prompts seed BOS and go straight to DECODING)
      3. prefill    every PREFILLING lane with >= chunk prompt tokens left
                    joins ONE (B, chunk) chunk-prefill step; lanes at a chunk
                    boundary the cache wants are snapshotted
      4. decode     DECODING lanes advance one token; a lane's input is
                    chosen ON THE DEVICE from {the previous decode's output,
                    this tick's prefill output, a host-known token};
                    sub-chunk prompt tails ride the same (B, 1) step
    retire (device -> host)
      5. fetch      wait for the tick's copies to the host (next tokens,
                    traced logit rows, snapshot states); emissions append
                    per stream, finished streams drain their lanes,
                    snapshots enter the trie

With ``async_depth=1`` a tick retires its own dispatch; with 2 the previous
tick retires after this tick's dispatch. Output streams are identical
either way: a stream's end by count is known at dispatch, and an ``eos_id``
finish discards the one step dispatched past it at retire.

**On the card** every step is a CUDA graph replay (``graphs=True``, the
default): ``warmup`` warms each step up eagerly on clones of the pool's
caches and captures it over the pool's live caches, each graph in a memory
pool of its own (the engine replays its five graphs in an order that
changes from tick to tick). A graph's outputs are overwritten by its next
replay, so every result the retire needs is copied out right after the
replay that made it, by an asynchronous copy into pinned host memory
enqueued behind it on the stream; an event recorded after the tick's last
copy is what retire waits on (``fetch_wait_s``). Host arrays go to the card
the same way, from pinned memory, so dispatch never waits for the device.
A capture that fails raises: there is no eager fallback on the card. On
the CPU the eager steps run.

Speculative decode (``draft_cfg``) comes with a later slice (ROADMAP §A3):
the Scheduler refuses it.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models import lm
from repro_torch.models.layers import resolve_device
from repro_torch.models.rnn import tree_map
from repro_torch.observability import NULL_TELEMETRY, Telemetry
from repro_torch.serving.metrics import EngineMetrics
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.queue import Request, RequestQueue
from repro_torch.serving.slots import Slot, SlotPool, SlotState
from repro_torch.training import graphs as step_graphs
from repro_torch.training.steps import (
    build_cache_init,
    build_chunk_prefill_step,
    build_lane_inject,
    build_lane_reset,
    build_lane_snapshot,
    build_masked_decode_step,
)

# Where a DECODING lane's next input token lives at dispatch time.
SRC_HOST = 0     # host-known int (prompt tail token, BOS seed, retired token)
SRC_DECODE = 1   # previous dispatched decode step's (B,) output, on the device
SRC_PREFILL = 2  # this tick's chunk-prefill (B,) output (prompt ended at chunk)


@dataclass
class _TickWork:
    """One dispatched tick's results on their way to the host.

    Emission entries are ``(slot, request, first)`` recorded at dispatch; the
    request is kept so retire can tell a still-resident stream from a lane
    that was recycled under it. ``serial`` is the tick that dispatched this
    work (the id of its ``inflight`` async span). The tensors are host
    copies (pinned, filled asynchronously on the card); ``event`` marks the
    end of the tick's copies (None on the CPU).
    """

    serial: int = 0
    prefill_nxt: Optional[torch.Tensor] = None
    prefill_emits: List[Tuple[Slot, Request, bool]] = field(default_factory=list)
    prefill_trace: Optional[torch.Tensor] = None
    decode_nxt: Optional[torch.Tensor] = None
    decode_emits: List[Tuple[Slot, Request, bool]] = field(default_factory=list)
    decode_trace: Optional[torch.Tensor] = None
    snapshots: List[Tuple[np.ndarray, object]] = field(default_factory=list)
    event: Optional[object] = None

    @property
    def retirable(self) -> bool:
        return bool(self.prefill_emits or self.decode_emits or self.snapshots)


class Scheduler:
    """Continuous-batching engine over ``batch`` slots, on ``device``.

    ``chunk`` is the prefill chunk length (default ``cfg.mts_block_size``, the
    MTS block). ``eos_id`` ends a stream early when sampled; ``bos_id`` seeds
    zero-length prompts (falling back to ``eos_id``, then 0).
    ``prefix_cache_mb`` > 0 turns on the prefix-sharing state cache with that
    LRU byte budget; ``async_depth`` is the number of dispatched ticks that
    may be in flight before the oldest retires (1 = synchronous, 2 = double
    buffered). ``trace_logits`` records each emitted token's logits row
    (gathered on the device, fetched with the tick). ``graphs`` runs the
    steps as CUDA graphs on a CUDA device (the eager steps otherwise, and
    always on the CPU). ``telemetry`` (an ``observability.Telemetry``) turns
    on the tick trace and rolling metrics; absent, every hook is a no-op.
    ``clock`` is the engine clock (injectable for tests). ``draft_cfg``,
    ``draft_params`` and ``spec_k`` are the JAX signature's speculative
    decode, refused until the speculative slice (ROADMAP §A3).
    """

    def __init__(
        self,
        cfg,
        params,
        *,
        batch: int,
        chunk: Optional[int] = None,
        queue_capacity: int = 64,
        eos_id: Optional[int] = None,
        bos_id: Optional[int] = None,
        prefix_cache_mb: float = 0.0,
        async_depth: int = 1,
        trace_logits: bool = False,
        draft_cfg=None,
        draft_params=None,
        spec_k: int = 4,
        telemetry: Optional[Telemetry] = None,
        clock=time.perf_counter,
        device="cuda",
        graphs: bool = True,
    ):
        if lm.block_kind(cfg) != "rnn" or cfg.attn_every:
            raise ValueError(
                "continuous batching requires O(1)-state RNN caches "
                f"({cfg.name!r} is not a pure-RNN stack); attention KV caches "
                "— including a hybrid's shared-attention cache — need paging "
                "machinery this engine deliberately avoids"
            )
        if cfg.frontend:
            raise ValueError("continuous batching serves token streams (no frontend)")
        if draft_cfg is not None:
            raise NotImplementedError(
                "speculative decode (draft_cfg) is not ported yet: ROADMAP.md §A3, the "
                "speculative slice (build_verify_step, lm_verify, the draft/verify "
                "Scheduler with sru-paper-draft)"
            )
        if batch < 1:
            raise ValueError("batch (slot count) must be >= 1")
        if async_depth < 1:
            raise ValueError("async_depth must be >= 1 (1 = synchronous)")
        self.cfg = cfg
        self.params = params
        self.batch = batch
        self.device = resolve_device(device)
        self.chunk = int(chunk or cfg.mts_block_size)
        if self.chunk < 1:
            raise ValueError("chunk must be >= 1")
        self.eos_id = eos_id
        self.bos_id = bos_id
        self.async_depth = int(async_depth)
        self.trace_logits = trace_logits
        self.logit_trace: Dict[int, List[np.ndarray]] = {}
        self._clock = clock
        self._t0: Optional[float] = None
        self.tel = telemetry if telemetry is not None else NULL_TELEMETRY
        self._tick_serial = 0

        self.queue = RequestQueue(queue_capacity)
        self.metrics = EngineMetrics(batch, trace=self.tel.trace, rolling=self.tel.rolling)
        self.pool = SlotPool(build_cache_init(cfg, batch=batch, device=self.device)(), batch)
        self.prefix_cache: Optional[PrefixCache] = (
            PrefixCache(chunk=self.chunk, budget_bytes=int(prefix_cache_mb * 2**20))
            if prefix_cache_mb > 0
            else None
        )
        self._inflight: deque = deque()
        self._fb_dec: Optional[torch.Tensor] = None  # last dispatched decode's next tokens
        self._lanes = torch.arange(batch, device=self.device)  # lane ids as device scalars
        # The fixed-shape steps, eager until ``warmup`` captures them (on a
        # CUDA device with ``graphs``). Each updates the pool's caches in
        # place; the snapshot only reads them.
        self.graphs = bool(graphs) and self.device.type == "cuda"
        self.captured = False
        self.capture_ms: Optional[float] = None
        self._reset = build_lane_reset(cfg)
        self._prefill = build_chunk_prefill_step(cfg, chunk=self.chunk)
        self._decode = build_masked_decode_step(cfg)
        self._snapshot = build_lane_snapshot(cfg)
        self._inject = build_lane_inject(cfg)
        self._storage = [t.data_ptr() for t in step_graphs.leaves(self.pool.caches)]

    # -- host <-> device -----------------------------------------------------

    def _to_device(self, arr) -> torch.Tensor:
        """A host array on the engine's device; on the card by an asynchronous
        copy from pinned memory, so the host does not wait for the stream."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        """A device result on its way to the host: on the card an asynchronous
        copy into fresh pinned memory, enqueued right behind the step that
        wrote ``t`` (a graph's next replay overwrites its outputs; the
        pinned block is not handed out again before the copy is done). The
        eager CPU steps return fresh tensors, taken as they are."""
        if self.device.type != "cuda":
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        return host

    @property
    def cache_in_place(self) -> bool:
        """Whether every pool cache leaf still lies where it was allocated
        (the graphs replay over these addresses)."""
        return [t.data_ptr() for t in step_graphs.leaves(self.pool.caches)] == self._storage

    # -- clock ---------------------------------------------------------------

    def start(self) -> None:
        """Pin t=0 of the engine clock (idempotent)."""
        if self._t0 is None:
            self._t0 = self._clock()
            self.metrics.start(0.0)

    def _now(self) -> float:
        self.start()
        return self._clock() - self._t0

    # -- public API ----------------------------------------------------------

    @property
    def _seed_token(self) -> int:
        """Decode seed for zero-length prompts: BOS, else EOS, else 0."""
        if self.bos_id is not None:
            return self.bos_id
        if self.eos_id is not None:
            return self.eos_id
        return 0

    def warmup(self) -> None:
        """Make every step ready before the first tick. Eager: each step runs
        once on the pool with all-False masks and a self round trip of lane 0
        (the cache bits stay). Graphs: each step is warmed up on clones of
        the pool's caches, then captured over the live caches
        (``capture_ms``). The warm-up's launches are not counted."""
        with self.tel.trace.span("warmup", tid="engine"), step_graphs.uncounted():
            if self.graphs:
                if not self.captured:
                    self._capture()
            else:
                self._warmup_eager()

    def _static_args(self):
        """Zero example arguments of the steps, on the device."""
        dev = self.device
        return (torch.zeros((self.batch,), dtype=torch.bool, device=dev),
                torch.zeros((self.batch, self.chunk), dtype=torch.int64, device=dev),
                torch.zeros((self.batch, 1), dtype=torch.int64, device=dev),
                torch.zeros((), dtype=torch.int64, device=dev))

    def _warmup_eager(self) -> None:
        mask, tokens, token, lane = self._static_args()
        caches = self._reset(self.pool.caches, mask)
        self._prefill(self.params, caches, tokens, mask)
        self._decode(self.params, caches, token, mask)
        if self.prefix_cache is not None:
            self._inject(caches, lane, self._snapshot(caches, lane))

    def _capture(self) -> None:
        torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        caches, params = self.pool.caches, self.params
        mask, tokens, token, lane = self._static_args()
        with torch.inference_mode():
            state = tree_map(torch.clone, self._snapshot(caches, lane))

        def no_params(step):
            return lambda _, *args: step(*args)

        step_graphs.warm_up(no_params(self._reset), None, caches, mask)
        step_graphs.warm_up(self._prefill, params, caches, tokens, mask)
        step_graphs.warm_up(self._decode, params, caches, token, mask)
        step_graphs.warm_up(no_params(self._snapshot), None, caches, lane)
        step_graphs.warm_up(no_params(self._inject), None, caches, lane, state)
        # Each graph gets a memory pool of its own: the engine replays them
        # in an order that changes from tick to tick, so no graph may
        # allocate where another's outputs live. The steps are replaced only
        # once all five are captured.
        capture = step_graphs.capture
        (self._reset, self._prefill, self._decode, self._snapshot, self._inject) = (
            capture(self._reset, caches, mask),
            capture(self._prefill, params, caches, tokens, mask),
            capture(self._decode, params, caches, token, mask),
            capture(self._snapshot, caches, lane),
            capture(self._inject, caches, lane, state))
        torch.cuda.synchronize(self.device)
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.captured = True

    def submit(self, req: Request) -> bool:
        """Queue a request; False = backpressure (queue at capacity)."""
        p = req.prompt  # numpy after Request.__post_init__: no device sync here
        if p.size and (int(p.max()) >= self.cfg.vocab or int(p.min()) < 0):
            raise ValueError(f"request {req.rid}: prompt token out of vocab range")
        ok = self.queue.push(req)
        if ok:
            self.metrics.on_submit(req)
        return ok

    def cancel(self, rid: int) -> bool:
        """Evict a resident stream mid-flight (its lane recycles next tick;
        an in-flight emission for it is discarded at retire), or withdraw a
        still-queued request before it ever takes a slot."""
        slot = self.pool.find(rid)
        if slot is not None and slot.busy:
            slot.req.cancelled = True
            slot.state = SlotState.DRAINING
            self.metrics.on_cancel(slot.req, self._now())
            return True
        req = self.queue.remove(rid)
        if req is not None:
            req.cancelled = True
            self.metrics.on_cancel(req, self._now())
            return True
        return False

    @property
    def idle(self) -> bool:
        return (
            len(self.queue) == 0
            and not self._inflight
            and all(s.state is SlotState.FREE for s in self.pool)
        )

    # -- the tick ------------------------------------------------------------

    def tick(self) -> List[Request]:
        """One scheduler step; returns requests whose finish retired this
        tick. Dispatch runs first; then the in-flight window drains to
        ``async_depth - 1`` entries (everything, when nothing was
        dispatched). On the card the steps are captured at the first tick if
        ``warmup`` was not called."""
        if self.graphs and not self.captured:
            self.warmup()
        tr = self.tel.trace
        serial = self._tick_serial
        self._tick_serial += 1
        t0 = self._clock()
        finished: List[Request] = []
        with tr.span("tick", serial=serial):
            work = self._dispatch()
            if work is not None:
                work.serial = serial
                self._inflight.append(work)
                tr.async_begin("inflight", "tick_inflight", id=serial)
            keep = self.async_depth - 1 if work is not None else 0
            while len(self._inflight) > keep:
                oldest = self._inflight.popleft()
                with tr.span("retire", serial=oldest.serial):
                    self._retire(oldest, finished)
                tr.async_end("inflight", "tick_inflight", id=oldest.serial)
        self._observe_tick(t0)
        return finished

    def _observe_tick(self, t0: float) -> None:
        """The tick's host time into ``busy_s`` and the rolling window; a
        metrics row every ``metrics_every`` ticks. (The straggler monitor
        comes with ROADMAP §A4.)"""
        tel = self.tel
        dt = self._clock() - t0
        self.metrics.busy_s += dt
        if tel.rolling is not None:
            tel.rolling.observe_tick_time(dt)
        if tel.metrics_every and tel.rolling is not None \
                and self.metrics.ticks % tel.metrics_every == 0:
            self._sample_metrics()

    def _sample_metrics(self) -> None:
        row = self.tel.rolling.sample(self._now())
        if self.tel.metrics_writer is not None:
            self.tel.metrics_writer.write(row)

    def _trace_rows(self, logits: torch.Tensor, emits) -> torch.Tensor:
        rows = self._to_device(np.asarray([s.lane for s, _, _ in emits], np.int64))
        return self._to_host(logits.index_select(0, rows)[:, -1].float())

    def _dispatch(self) -> Optional[_TickWork]:
        """Host -> device half of a tick: admission and step dispatch, no
        waits on the device. Returns the in-flight record, or None if nothing
        retirable was dispatched."""
        now = self._now()
        tr = self.tel.trace
        work = _TickWork()
        with tr.span("recycle"):
            self.pool.recycle()

        # admission: free lanes fill from the queue. Cold lanes share one
        # masked reset; prefix-cache hits inject their snapshot instead and
        # start prefill at the cached boundary. Zero-length prompts have
        # nothing to prefill: they seed with BOS and decode at once.
        admit_mask = np.zeros((self.batch,), bool)
        hits: List[Tuple[int, object]] = []
        with tr.span("admit") as admit_span:
            for lane in self.pool.free_lanes():
                req = self.queue.pop()
                if req is None:
                    break
                slot = self.pool.slots[lane]
                slot.assign(req)
                self.metrics.on_admit(req, now)
                boundary, state = 0, None
                if self.prefix_cache is not None and req.prompt_len:
                    boundary, state = self.prefix_cache.lookup(req.prompt)
                    if state is None:
                        self.metrics.prefix_misses += 1
                        tr.instant("prefix_miss", rid=req.rid)
                if state is not None:
                    hits.append((lane, state))
                    slot.pos = boundary
                    self.metrics.prefix_hits += 1
                    self.metrics.prefix_hit_tokens += boundary
                    tr.instant("prefix_hit", rid=req.rid, cached_tokens=boundary)
                else:
                    admit_mask[lane] = True
                if req.prompt_len == 0:
                    slot.state = SlotState.DECODING
                    slot.last_token = self._seed_token
                    slot.fb_src = SRC_HOST
            if admit_mask.any():
                admit_span.arg("cold", int(admit_mask.sum()))
                with self.tel.annotate("reset"):
                    self._reset(self.pool.caches, self._to_device(admit_mask))
        if hits:
            with tr.span("inject", lanes=len(hits)), self.tel.annotate("inject"):
                for lane, state in hits:
                    state_d = tree_map(
                        lambda t: t.to(self.device, non_blocking=True), state)
                    self._inject(self.pool.caches, self._lanes[lane], state_d)

        # chunked prefill: all lanes with a full chunk of prompt left share
        # one fixed-shape (B, chunk) step; boundaries the cache wants are
        # snapshotted from the merged caches and copied out at once
        chunk_slots = [
            s
            for s in self.pool.lanes_in(SlotState.PREFILLING)
            if s.prompt_remaining >= self.chunk
        ]
        pre_nxt = None
        if chunk_slots:
            snap_slots = []
            with tr.span("prefill", lanes=len(chunk_slots)):
                tokens = np.zeros((self.batch, self.chunk), np.int64)
                mask = np.zeros((self.batch,), bool)
                for s in chunk_slots:
                    tokens[s.lane] = s.req.prompt[s.pos : s.pos + self.chunk]
                    mask[s.lane] = True
                with self.tel.annotate("prefill"):
                    pre_nxt, logits, _ = self._prefill(
                        self.params, self.pool.caches, self._to_device(tokens),
                        self._to_device(mask))
                self.metrics.prefill_chunks += 1
                self.metrics.prefill_lane_chunks += len(chunk_slots)
                for s in chunk_slots:
                    s.pos += self.chunk
                    if self.prefix_cache is not None and self.prefix_cache.wants(
                        s.req.prompt[: s.pos]
                    ):
                        snap_slots.append(s)
                    if s.prompt_remaining == 0:
                        first = (len(s.req.tokens) + s.pending) == 0
                        work.prefill_emits.append((s, s.req, first))
                        s.pending += 1
                        s.state = SlotState.DECODING
                        s.fb_src = SRC_PREFILL
                if work.prefill_emits:
                    work.prefill_nxt = self._to_host(pre_nxt)
                    if self.trace_logits:
                        work.prefill_trace = self._trace_rows(logits, work.prefill_emits)
            if snap_slots:
                # each snapshot is copied out before the next replay of the
                # snapshot graph overwrites its output
                with tr.span("snapshot", lanes=len(snap_slots)):
                    with self.tel.annotate("snapshot"):
                        for s in snap_slots:
                            state = self._snapshot(self.pool.caches, self._lanes[s.lane])
                            work.snapshots.append(
                                (s.req.prompt[: s.pos].copy(), tree_map(self._to_host, state)))

        # decode: resident streams advance one token. A lane's input is
        # composed ON THE DEVICE from its source — the previous decode's
        # output (SRC_DECODE), this tick's prefill output (SRC_PREFILL), or a
        # host-known token (SRC_HOST: prompt tails, BOS seeds) — so decoding
        # never waits for a fetch. Streams whose every emission is already
        # in flight stop here; an EOS finish instead costs one step,
        # discarded at retire.
        tok_host = np.zeros((self.batch, 1), np.int64)
        src = np.zeros((self.batch,), np.int64)
        mask = np.zeros((self.batch,), bool)
        for s in self.pool:
            if s.state is SlotState.DECODING:
                if len(s.req.tokens) + s.pending >= s.req.max_new_tokens:
                    continue  # all remaining emissions already in flight
                mask[s.lane] = True
                if s.fb_src == SRC_HOST:
                    tok_host[s.lane, 0] = s.last_token
                else:
                    src[s.lane] = s.fb_src
                first = (len(s.req.tokens) + s.pending) == 0
                work.decode_emits.append((s, s.req, first))
                s.pending += 1
                s.fb_src = SRC_DECODE
            elif s.state is SlotState.PREFILLING and 0 < s.prompt_remaining < self.chunk:
                tok_host[s.lane, 0] = s.req.prompt[s.pos]
                s.pos += 1
                mask[s.lane] = True
                if s.prompt_remaining == 0:
                    # this tail token is the prompt's last: the step's output
                    # is the stream's first sample
                    first = (len(s.req.tokens) + s.pending) == 0
                    work.decode_emits.append((s, s.req, first))
                    s.pending += 1
                    s.state = SlotState.DECODING
                    s.fb_src = SRC_DECODE
        if mask.any():
            with tr.span("decode", lanes=int(mask.sum())):
                tok = self._to_device(tok_host)
                if (src != SRC_HOST).any():
                    src_d = self._to_device(src)
                    zeros = torch.zeros_like(src_d)
                    fb = self._fb_dec if self._fb_dec is not None else zeros
                    pre = pre_nxt if pre_nxt is not None else zeros
                    tok = torch.where(
                        src_d == SRC_DECODE, fb,
                        torch.where(src_d == SRC_PREFILL, pre, tok[:, 0]))[:, None]
                with self.tel.annotate("decode"):
                    nxt, logits, _ = self._decode(self.params, self.pool.caches, tok,
                                                  self._to_device(mask))
                self.metrics.decode_steps += 1
                self._fb_dec = nxt
                if work.decode_emits:
                    work.decode_nxt = self._to_host(nxt)
                    if self.trace_logits:
                        work.decode_trace = self._trace_rows(logits, work.decode_emits)

        self.metrics.on_tick(self.pool.occupancy(), len(self.queue))
        if not work.retirable:
            return None
        if self.device.type == "cuda":
            work.event = torch.cuda.Event()
            work.event.record()
        return work

    def _retire(self, work: _TickWork, finished: List[Request]) -> None:
        """Device -> host half of a tick: wait for the tick's copies, then
        host bookkeeping."""
        t0 = time.perf_counter()
        with self.tel.trace.span(
            "fetch",
            serial=work.serial,
            decode=len(work.decode_emits),
            prefill=len(work.prefill_emits),
            snapshots=len(work.snapshots),
        ):
            if work.event is not None:
                work.event.synchronize()
            pre_h = work.prefill_nxt.numpy() if work.prefill_emits else None
            dec_h = work.decode_nxt.numpy() if work.decode_emits else None
            pre_tr = work.prefill_trace.numpy() if work.prefill_trace is not None else None
            dec_tr = work.decode_trace.numpy() if work.decode_trace is not None else None
        self.metrics.fetch_wait_s += time.perf_counter() - t0
        for prefix, state in work.snapshots:
            self.prefix_cache.insert(prefix, state)
        self._apply_emits(work.prefill_emits, pre_h, pre_tr, finished)
        self._apply_emits(work.decode_emits, dec_h, dec_tr, finished)

    def _apply_emits(self, emits, nxt_h, trace_h, finished: List[Request]) -> None:
        now = self._now()
        for i, (slot, req, first) in enumerate(emits):
            if slot.req is not req:
                continue  # lane recycled under an in-flight step
            slot.pending -= 1
            if slot.state is not SlotState.DECODING:
                continue  # EOS/cancel landed at an earlier retire: discard
            tok = int(nxt_h[slot.lane])
            slot.last_token = tok
            req.tokens.append(tok)
            self.metrics.on_token(req, now, first)
            if trace_h is not None:
                self.logit_trace.setdefault(req.rid, []).append(trace_h[i])
            if len(req.tokens) >= req.max_new_tokens or tok == self.eos_id:
                slot.state = SlotState.DRAINING
                self.metrics.on_finish(req, now)
                finished.append(req)

    # -- run loop ------------------------------------------------------------

    def run(
        self,
        trace: Optional[Sequence[Request]] = None,
        *,
        max_ticks: Optional[int] = None,
        idle_sleep: float = 2e-4,
    ) -> List[Request]:
        """Replay an open-loop trace (arrival offsets from run start) to
        completion; also drains anything already submitted. Backpressured
        submissions retry each tick (arrival order is preserved)."""
        pending = deque(sorted(trace or [], key=lambda r: (r.arrival, r.rid)))
        self.start()
        finished: List[Request] = []
        ticks = 0
        while True:
            now = self._now()
            while pending and pending[0].arrival <= now:
                if self.submit(pending[0]):
                    pending.popleft()
                else:
                    self.metrics.on_backpressure()
                    break
            busy = not self.idle  # DRAINING lanes are not FREE: one more tick
            if not pending and not busy:
                break
            if not busy and pending:
                time.sleep(min(max(pending[0].arrival - now, 0.0), idle_sleep))
                continue
            finished.extend(self.tick())
            ticks += 1
            if max_ticks is not None and ticks > max_ticks:
                raise RuntimeError(f"scheduler exceeded max_ticks={max_ticks}")
        self.metrics.stop(self._now())
        if self.tel.rolling is not None:
            # the last window is never lost
            self._sample_metrics()
        return finished
