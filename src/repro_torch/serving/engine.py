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

**Speculative multi-token decode** (``draft_cfg``/``draft_params``/``spec_k``)
applies the paper's multi-time-step trick at decode time: a low-width draft
RNN proposes tokens one masked (B, 1) step at a time, and the target scores
the whole block in ONE (B, k) chunk (``build_verify_step``, the MTS path
prefill takes). Greedy output stays the plain decode's because acceptance
is exact: each lane keeps a queue of committed but unconsumed tokens
(``SpecLane``, r of them), the block replays those r tokens and then the
draft's proposals, and the per-position argmax yields the true next token
at position r - 1 plus one more committed token per matching draft
position. A fully matched block keeps the advanced lane state; any mismatch
restores both lanes (target and draft) to their pre-block state by one lane
inject each. The draft mirrors every token the target consumes (prompt
chunks, tails, the block), so both caches sit at "committed stream minus
queue". A lane starts a new block only once its previous block has
retired, so ``async_depth`` > 1 still overlaps the plain lanes' work with
the host. Speculative mode and the prefix cache exclude each other, and
``Request.speculative=False`` pins a stream to plain decode.

On the card the draft pool has its own five graphs, the k draft steps of a
block with their input composition are ONE graph (``build_draft_block_step``),
and the target's verify step is one more. The pre-block snapshots stay on
the device: each is copied, right behind the snapshot replay that made it,
into a rollback buffer allocated once per lane and per pool (at most one
block per lane is in flight), and a rollback injects from that buffer.

**On a mesh of ranks** (``mesh``, a live ``launch/mesh.py`` mesh, as JAX's
``Scheduler(..., mesh=mesh)``) every rank runs one Scheduler over its
shards: both pools are this rank's lanes over "data" and H / k of each
carry over "model" wherever the model axis divides H, every engine's and
the LSTM's (``fused_sharded.rank_cache_specs``; the default draft
``sru-paper-draft``, chunked, is sharded the same way; a draft whose width
the model axis does not divide is held and run whole on every model rank),
and every step is the mesh step of ``training/steps.py``. JAX's engine is
one controller; here every rank must take every decision (admission,
backpressure, retirement, acceptance, rollback) alike on the same tick, or
its next collective pairs with another step's. Two things make it so. The
clock: each pass of ``run`` reads rank 0's clock, broadcast on the host
(``Mesh.host_broadcast``), so admission by arrival time is rank 0's on
every rank (a tick's own reading feeds only the metrics). The tokens, by
construction: every step gathers its sampled tokens over "data", and every
model rank samples them from the same gathered residual stream with the
same head (its vocab columns gathered to the whole vocab before the
argmax), so the (B,) ids and the verify block's argmax that the host acts
on are the same bits on every rank; no token is broadcast. A
lane's snapshot is broadcast over "data" from the rank that holds it, so
the prefix cache and the rollback buffers are alike on every rank. The
steps run eagerly under a mesh (gloo steps cannot be captured): ``graphs``
is then off and the report says so.
"""
from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.distribution import fused_sharded
from repro_torch.distribution import sharding as shd
from repro_torch.models import lm
from repro_torch.models.layers import resolve_device
from repro_torch.models.rnn import tree_map
from repro_torch.observability import NULL_TELEMETRY, Telemetry
from repro_torch.serving.metrics import EngineMetrics
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.queue import Request, RequestQueue
from repro_torch.serving.slots import Slot, SlotPool, SlotState, SpecLane
from repro_torch.training import graphs as step_graphs
from repro_torch.training.steps import (
    build_cache_init,
    build_chunk_prefill_step,
    build_draft_block_step,
    build_lane_inject,
    build_lane_reset,
    build_lane_snapshot,
    build_masked_decode_step,
    build_verify_step,
)

# Where a DECODING lane's next input token lives at dispatch time.
SRC_HOST = 0     # host-known int (prompt tail token, BOS seed, retired token)
SRC_DECODE = 1   # previous dispatched decode step's (B,) output, on the device
SRC_PREFILL = 2  # this tick's chunk-prefill (B,) output (prompt ended at chunk)


def lane_state_shards(cfg, mesh, batch: int):
    """How many shards each leaf of one lane's state is split into on
    ``mesh`` (``rank_cache_specs`` without the batch dim), a tree shaped as
    the state: the prefix cache counts a snapshot's whole bytes, as JAX's
    counts a sharded array's, from this rank's shard."""
    whole = lm.lm_init_caches(cfg, batch, 1, device="meta")
    return shd.map_with_paths(
        lambda _, spec: math.prod(mesh.shape[a] for a in shd.spec_axes(spec[:1] + spec[2:])),
        fused_sharded.rank_cache_specs(cfg, whole, mesh))


@dataclass
class _TickWork:
    """One dispatched tick's results on their way to the host.

    Emission entries are ``(slot, request, first)`` recorded at dispatch; the
    request is kept so retire can tell a still-resident stream from a lane
    that was recycled under it. ``serial`` is the tick that dispatched this
    work (the id of its ``inflight`` async span). The tensors are host
    copies (pinned, filled asynchronously on the card); ``event`` marks the
    end of the tick's copies (None on the CPU). Speculative blocks add the
    per-position argmax and the composed block tokens, and per lane a
    ``(slot, request, r, first)`` record for acceptance at retire; their
    rollback states stay on the device, in the Scheduler's per-lane
    buffers.
    """

    serial: int = 0
    prefill_nxt: Optional[torch.Tensor] = None
    prefill_emits: List[Tuple[Slot, Request, bool]] = field(default_factory=list)
    prefill_trace: Optional[torch.Tensor] = None
    decode_nxt: Optional[torch.Tensor] = None
    decode_emits: List[Tuple[Slot, Request, bool]] = field(default_factory=list)
    decode_trace: Optional[torch.Tensor] = None
    snapshots: List[Tuple[np.ndarray, object]] = field(default_factory=list)
    spec_toks: Optional[torch.Tensor] = None
    spec_chunk: Optional[torch.Tensor] = None
    spec_trace: Optional[torch.Tensor] = None
    spec_emits: List[Tuple[Slot, Request, int, bool]] = field(default_factory=list)
    event: Optional[object] = None

    @property
    def retirable(self) -> bool:
        return bool(self.prefill_emits or self.decode_emits or self.snapshots
                    or self.spec_emits)


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
    on the tick trace, rolling metrics, the straggler monitor and the
    profiler's step annotations; absent, every hook is a no-op.
    ``clock`` is the engine clock (injectable for tests). ``draft_cfg`` and
    ``draft_params`` (a pure-RNN LM sharing the vocab) turn on speculative
    decode with blocks of ``spec_k`` tokens; requests opt out one by one
    with ``Request.speculative=False``.
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
        mesh=None,
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
        if batch < 1:
            raise ValueError("batch (slot count) must be >= 1")
        if async_depth < 1:
            raise ValueError("async_depth must be >= 1 (1 = synchronous)")
        self.cfg = cfg
        self.params = params
        self.batch = batch
        self.mesh = mesh
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
        # (tick, rid, lane) of every admission: under a mesh, equal on every rank
        self.admission_log: List[Tuple[int, int, int]] = []

        self.queue = RequestQueue(queue_capacity)
        self.metrics = EngineMetrics(batch, trace=self.tel.trace, rolling=self.tel.rolling)
        self.pool = SlotPool(build_cache_init(cfg, mesh, batch=batch, device=self.device)(),
                             batch)
        self.prefix_cache: Optional[PrefixCache] = (
            PrefixCache(chunk=self.chunk, budget_bytes=int(prefix_cache_mb * 2**20),
                        shards=None if mesh is None else lane_state_shards(cfg, mesh, batch))
            if prefix_cache_mb > 0
            else None
        )
        self._inflight: deque = deque()
        self._fb_dec: Optional[torch.Tensor] = None  # last dispatched decode's next tokens
        # Lane ids: device scalars, so one captured snapshot/inject serves
        # every lane; under a mesh host ints (the step reads the owner rank).
        self._lanes = (torch.arange(batch, device=self.device) if mesh is None
                       else list(range(batch)))
        # The fixed-shape steps, eager until ``warmup`` captures them (on a
        # CUDA device with ``graphs``, and no mesh). Each updates the pool's
        # caches in place; the snapshot only reads them.
        self.graphs = bool(graphs) and self.device.type == "cuda" and mesh is None
        self.captured = False
        self.capture_ms: Optional[float] = None
        self._reset = build_lane_reset(cfg, mesh)
        self._prefill = build_chunk_prefill_step(cfg, mesh, chunk=self.chunk)
        self._decode = build_masked_decode_step(cfg, mesh)
        self._snapshot = build_lane_snapshot(cfg, mesh, batch=batch)
        self._inject = build_lane_inject(cfg, mesh, batch=batch)

        # Speculative decode: a draft pool with its own fixed-shape steps (the
        # draft is another architecture; the oracle draft, the target as its
        # own draft, still gets steps of its own over its own pool), the
        # draft's k-step block, and the target's (B, spec_k) verify step.
        self.spec_enabled = draft_cfg is not None
        self.draft_cfg = draft_cfg
        self.draft_params = draft_params
        self.spec_k = int(spec_k)
        self.draft_caches = None
        if self.spec_enabled:
            if draft_params is None:
                raise ValueError("speculative decode needs draft_params")
            if lm.block_kind(draft_cfg) != "rnn" or draft_cfg.attn_every or draft_cfg.frontend:
                raise ValueError(
                    f"draft model {draft_cfg.name!r} must be a pure-RNN token "
                    "stack (same constraints as the target)"
                )
            if draft_cfg.vocab != cfg.vocab:
                raise ValueError(
                    f"draft vocab {draft_cfg.vocab} != target vocab "
                    f"{cfg.vocab}: speculative decode compares token ids"
                )
            if self.spec_k < 1:
                raise ValueError("spec_k must be >= 1")
            if self.prefix_cache is not None:
                raise ValueError(
                    "speculative decode and the prefix cache are mutually "
                    "exclusive: a hit-injected target state has no draft-side "
                    "counterpart, so the draft could not mirror the stream"
                )
            self.draft_caches = build_cache_init(draft_cfg, mesh, batch=batch,
                                                 device=self.device)()
            self._d_reset = build_lane_reset(draft_cfg, mesh)
            self._d_prefill = build_chunk_prefill_step(draft_cfg, mesh, chunk=self.chunk)
            self._d_decode = build_masked_decode_step(draft_cfg, mesh)
            self._d_snapshot = build_lane_snapshot(draft_cfg, mesh, batch=batch)
            self._d_inject = build_lane_inject(draft_cfg, mesh, batch=batch)
            self._d_block = build_draft_block_step(draft_cfg, mesh, k=self.spec_k)
            self._verify = build_verify_step(cfg, mesh, chunk=self.spec_k)
            # Rollback buffers: one pre-block state per lane and per pool,
            # written right behind each snapshot.
            self._rollback = [self._lane_buffer(self.pool.caches) for _ in range(batch)]
            self._d_rollback = [self._lane_buffer(self.draft_caches) for _ in range(batch)]
        self._storage = [t.data_ptr() for t in self._pool_leaves()]

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

    def _pool_leaves(self) -> List[torch.Tensor]:
        return step_graphs.leaves(self.pool.caches) + step_graphs.leaves(self.draft_caches)

    @property
    def cache_in_place(self) -> bool:
        """Whether every cache leaf of the pool (and of the draft's pool)
        still lies where it was allocated (the graphs replay over these
        addresses)."""
        return [t.data_ptr() for t in self._pool_leaves()] == self._storage

    @staticmethod
    def _lane_buffer(caches):
        """A tree shaped as one lane's state (``build_lane_snapshot``)."""
        return tree_map(lambda t: t.new_empty(t[:, 0].shape), caches)

    def _snapshot_into(self, snapshot, caches, lane: int, buffer) -> None:
        """Lane ``lane``'s state into ``buffer``, copied on the device right
        behind the snapshot (a graph's next replay overwrites its output)."""
        state = snapshot(caches, self._lanes[lane])
        with torch.inference_mode():
            tree_map(lambda dst, src: dst.copy_(src), buffer, state)

    # -- clock ---------------------------------------------------------------

    def start(self) -> None:
        """Pin t=0 of the engine clock (idempotent)."""
        if self._t0 is None:
            self._t0 = self._clock()
            self.metrics.start(0.0)

    def _now(self) -> float:
        self.start()
        return self._clock() - self._t0

    def _agreed_now(self) -> float:
        """The engine clock as every rank reads it: under a mesh, rank 0's
        reading, broadcast on the host (the decisions taken on it are then
        rank 0's on every rank)."""
        now = self._now()
        return now if self.mesh is None else self.mesh.host_broadcast(now)

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
        """Zero example arguments of the steps, on the device: the lane
        mask, a chunk, a token, a lane, and a block's tokens and sources."""
        dev = self.device
        return (torch.zeros((self.batch,), dtype=torch.bool, device=dev),
                torch.zeros((self.batch, self.chunk), dtype=torch.int64, device=dev),
                torch.zeros((self.batch, 1), dtype=torch.int64, device=dev),
                torch.zeros((), dtype=torch.int64, device=dev),
                torch.zeros((self.batch, self.spec_k), dtype=torch.int64, device=dev),
                torch.zeros((self.batch, self.spec_k), dtype=torch.bool, device=dev))

    def _pool_steps(self, draft: bool = False) -> tuple:
        """One pool's five steps (reset, prefill, decode, snapshot, inject)
        with its params and caches: the target's, or the draft's."""
        if draft:
            return ((self._d_reset, self._d_prefill, self._d_decode, self._d_snapshot,
                     self._d_inject), self.draft_params, self.draft_caches)
        return ((self._reset, self._prefill, self._decode, self._snapshot, self._inject),
                self.params, self.pool.caches)

    def _warmup_eager(self) -> None:
        mask, tokens, token, lane, block, src = self._static_args()
        for draft in ([False, True] if self.spec_enabled else [False]):
            (reset, prefill, decode, snapshot, inject), params, caches = self._pool_steps(draft)
            reset(caches, mask)
            prefill(params, caches, tokens, mask)
            decode(params, caches, token, mask)
            if self.prefix_cache is not None or self.spec_enabled:
                inject(caches, lane, snapshot(caches, lane))
        if self.spec_enabled:
            self._d_block(self.draft_params, self.draft_caches, block, src, mask)
            self._verify(self.params, self.pool.caches, block, mask)

    def _capture_pool(self, draft: bool) -> list:
        """Warm up, then capture, one pool's five steps; returns the
        captured steps in ``_pool_steps`` order."""
        (reset, prefill, decode, snapshot, inject), params, caches = self._pool_steps(draft)
        mask, tokens, token, lane, _, _ = self._static_args()
        with torch.inference_mode():
            state = tree_map(torch.clone, snapshot(caches, lane))

        def no_params(step):
            return lambda _, *args: step(*args)

        step_graphs.warm_up(no_params(reset), None, caches, mask)
        step_graphs.warm_up(prefill, params, caches, tokens, mask)
        step_graphs.warm_up(decode, params, caches, token, mask)
        step_graphs.warm_up(no_params(snapshot), None, caches, lane)
        step_graphs.warm_up(no_params(inject), None, caches, lane, state)
        capture = step_graphs.capture
        return [capture(reset, caches, mask), capture(prefill, params, caches, tokens, mask),
                capture(decode, params, caches, token, mask), capture(snapshot, caches, lane),
                capture(inject, caches, lane, state)]

    def _capture(self) -> None:
        """Each graph gets a memory pool of its own: the engine replays them
        in an order that changes from tick to tick, so no graph may allocate
        where another's outputs live. The steps are replaced only once every
        graph is captured."""
        torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        target = self._capture_pool(draft=False)
        if self.spec_enabled:
            mask, _, _, _, block, src = self._static_args()
            draft = self._capture_pool(draft=True)
            step_graphs.warm_up(self._d_block, self.draft_params, self.draft_caches, block, src,
                                mask)
            step_graphs.warm_up(self._verify, self.params, self.pool.caches, block, mask)
            d_block = step_graphs.capture(self._d_block, self.draft_params, self.draft_caches,
                                          block, src, mask)
            verify = step_graphs.capture(self._verify, self.params, self.pool.caches, block, mask)
            (self._d_reset, self._d_prefill, self._d_decode, self._d_snapshot,
             self._d_inject) = draft
            self._d_block, self._verify = d_block, verify
        (self._reset, self._prefill, self._decode, self._snapshot, self._inject) = target
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
            work = self._dispatch(self._now(), serial)
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
        self._observe_tick(serial, t0)
        return finished

    def _observe_tick(self, serial: int, t0: float) -> None:
        """The tick's host time into ``busy_s``, the rolling window and the
        straggler monitor (a flagged tick becomes a ``straggler`` instant on
        the engine track); a metrics row every ``metrics_every`` ticks. Host
        clock only: no device sync."""
        tel = self.tel
        dt = self._clock() - t0
        self.metrics.busy_s += dt
        if tel.rolling is not None:
            tel.rolling.observe_tick_time(dt)
        if tel.monitor is not None:
            res = tel.monitor.observe(serial, dt)
            if res["straggler"]:
                tel.trace.instant("straggler", tid="engine", tick=serial, dt_s=dt,
                                  z=res["z"], mean_s=res["mean"])
        if tel.metrics_every and tel.rolling is not None \
                and self.metrics.ticks % tel.metrics_every == 0:
            self._sample_metrics()

    def _sample_metrics(self) -> None:
        row = self.tel.rolling.sample(self._now())
        if self.tel.metrics_writer is not None:
            self.tel.metrics_writer.write(row)

    def _trace_rows(self, logits: torch.Tensor, emits, last: bool = True) -> torch.Tensor:
        """The emitting lanes' logits rows, on their way to the host: the
        last position's, or (``last=False``, a verify block) every one."""
        rows = self._to_device(np.asarray([e[0].lane for e in emits], np.int64))
        if self.mesh is not None and self.mesh.shape.get("data", 1) > 1 \
                and logits.shape[0] != self.batch:
            logits = self.mesh.axis("data").all_gather(logits, dim=0)  # every lane's rows
        picked = logits.index_select(0, rows)
        return self._to_host((picked[:, -1] if last else picked).float())

    def _dispatch(self, now: float, serial: int) -> Optional[_TickWork]:
        """Host -> device half of a tick: admission and step dispatch, no
        waits on the device. Returns the in-flight record, or None if nothing
        retirable was dispatched."""
        tr = self.tel.trace
        work = _TickWork()
        with tr.span("recycle"):
            self.pool.recycle()

        # admission: free lanes fill from the queue. Cold lanes share one
        # masked reset; prefix-cache hits inject their snapshot instead and
        # start prefill at the cached boundary. Zero-length prompts have
        # nothing to prefill: they seed with BOS and decode at once.
        admit_mask = np.zeros((self.batch,), bool)
        d_admit_mask = np.zeros((self.batch,), bool)
        hits: List[Tuple[int, object]] = []
        with tr.span("admit") as admit_span:
            for lane in self.pool.free_lanes():
                req = self.queue.pop()
                if req is None:
                    break
                slot = self.pool.slots[lane]
                slot.assign(req)
                self.metrics.on_admit(req, now)
                self.admission_log.append((serial, req.rid, lane))
                if self.spec_enabled and req.speculative is not False:
                    slot.spec = SpecLane()
                    d_admit_mask[lane] = True
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
                    if slot.spec is not None:
                        # the seed is committed (an input, not an emission)
                        # but unconsumed: the first verify block replays it
                        slot.spec.queue = [self._seed_token]
            if admit_mask.any():
                admit_span.arg("cold", int(admit_mask.sum()))
                with self.tel.annotate("reset"):
                    self._reset(self.pool.caches, self._to_device(admit_mask))
            if d_admit_mask.any():
                self._d_reset(self.draft_caches, self._to_device(d_admit_mask))
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
                tokens_d = self._to_device(tokens)
                with self.tel.annotate("prefill"):
                    pre_nxt, logits, _ = self._prefill(
                        self.params, self.pool.caches, tokens_d, self._to_device(mask))
                self.metrics.prefill_chunks += 1
                self.metrics.prefill_lane_chunks += len(chunk_slots)
                # the draft mirrors every prompt token a speculative lane
                # consumes (the same chunk, its lanes only), so both caches
                # stay at "committed stream minus queue"
                d_mask = np.zeros((self.batch,), bool)
                for s in chunk_slots:
                    d_mask[s.lane] = s.spec is not None
                if d_mask.any():
                    self._d_prefill(self.draft_params, self.draft_caches, tokens_d,
                                    self._to_device(d_mask))
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
        d_tail_mask = np.zeros((self.batch,), bool)
        for s in self.pool:
            if s.state is SlotState.DECODING:
                if s.spec is not None:
                    continue  # speculative lanes advance by draft/verify blocks
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
                d_tail_mask[s.lane] = s.spec is not None  # the draft mirrors the tail
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
                tok = tok_host_d = self._to_device(tok_host)
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
        if d_tail_mask.any():
            with tr.span("draft"), self.tel.annotate("draft"):
                self._d_decode(self.draft_params, self.draft_caches, tok_host_d,
                               self._to_device(d_tail_mask))
                self.metrics.draft_steps += 1

        self._dispatch_spec(work)
        self.metrics.on_tick(self.pool.occupancy(), len(self.queue))
        if not work.retirable:
            return None
        if self.device.type == "cuda":
            work.event = torch.cuda.Event()
            work.event.record()
        return work

    def _dispatch_spec(self, work: _TickWork) -> None:
        """Draft-propose and target-verify one speculative block per ready
        lane. A lane is ready when its previous block has retired
        (``pending == 0``: acceptance needs the block's argmax on the host
        before the next block's tokens can be composed). The block's k
        positions are the lane's queue (r committed tokens, known to the
        host) and then k - r draft proposals; the draft consumes the same k
        tokens the verify chunk does, so on a full accept both lanes advance
        in lockstep. The pre-block states are kept only where a rejection is
        possible (r < k; a pure replay always accepts)."""
        if not self.spec_enabled:
            return
        spec_slots = [
            s
            for s in self.pool
            if s.state is SlotState.DECODING
            and s.spec is not None
            and s.pending == 0
            and s.spec.queue
            and len(s.req.tokens) < s.req.max_new_tokens
        ]
        if not spec_slots:
            return
        tr = self.tel.trace
        k = self.spec_k
        host_toks = np.zeros((self.batch, k), np.int64)
        host_src = np.zeros((self.batch, k), bool)
        mask = np.zeros((self.batch,), bool)
        snap_lanes = []
        for s in spec_slots:
            r = len(s.spec.queue)
            host_toks[s.lane, :r] = s.spec.queue
            host_src[s.lane, :r] = True
            mask[s.lane] = True
            if r < k:
                snap_lanes.append(s.lane)
            work.spec_emits.append((s, s.req, r, len(s.req.tokens) == 0))
            s.pending += 1
            self.metrics.spec_cycles += 1
            self.metrics.spec_proposed += k - r
        if snap_lanes:
            # no trace span: JAX's Scheduler writes none for these snapshots,
            # and the port's traces follow its span catalog
            with self.tel.annotate("snapshot"):
                for lane in snap_lanes:
                    self._snapshot_into(self._snapshot, self.pool.caches, lane,
                                        self._rollback[lane])
                    self._snapshot_into(self._d_snapshot, self.draft_caches, lane,
                                        self._d_rollback[lane])
        mask_d = self._to_device(mask)
        with tr.span("draft", lanes=len(spec_slots), k=k), self.tel.annotate("draft"):
            block = self._d_block(self.draft_params, self.draft_caches,
                                  self._to_device(host_toks), self._to_device(host_src), mask_d)
            self.metrics.draft_steps += k
        with tr.span("verify", lanes=len(spec_slots), k=k), self.tel.annotate("verify"):
            v_toks, v_logits, _ = self._verify(self.params, self.pool.caches, block, mask_d)
            self.metrics.verify_steps += 1
            work.spec_toks = self._to_host(v_toks)
            work.spec_chunk = self._to_host(block)
            if self.trace_logits:
                work.spec_trace = self._trace_rows(v_logits, work.spec_emits, last=False)

    def _retire(self, work: _TickWork, finished: List[Request]) -> None:
        """Device -> host half of a tick: wait for the tick's copies, then
        host bookkeeping."""
        t0 = time.perf_counter()
        with self.tel.trace.span(
            "fetch",
            serial=work.serial,
            decode=len(work.decode_emits),
            prefill=len(work.prefill_emits),
            spec=len(work.spec_emits),
            snapshots=len(work.snapshots),
        ):
            if work.event is not None:
                work.event.synchronize()
            pre_h = work.prefill_nxt.numpy() if work.prefill_emits else None
            dec_h = work.decode_nxt.numpy() if work.decode_emits else None
            pre_tr = work.prefill_trace.numpy() if work.prefill_trace is not None else None
            dec_tr = work.decode_trace.numpy() if work.decode_trace is not None else None
            spec_h = work.spec_toks.numpy() if work.spec_emits else None
            spec_blk = work.spec_chunk.numpy() if work.spec_emits else None
            spec_tr = work.spec_trace.numpy() if work.spec_trace is not None else None
        self.metrics.fetch_wait_s += time.perf_counter() - t0
        for prefix, state in work.snapshots:
            self.prefix_cache.insert(prefix, state)
        self._apply_emits(work.prefill_emits, pre_h, pre_tr, finished)
        self._apply_emits(work.decode_emits, dec_h, dec_tr, finished)
        self._apply_spec_emits(work.spec_emits, spec_h, spec_blk, spec_tr, finished)

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
            if slot.spec is not None:
                # a first token from prefill or a tail: committed but not yet
                # consumed; the lane's first verify block replays it
                slot.spec.queue.append(tok)
            self.metrics.on_token(req, now, first)
            if trace_h is not None:
                self.logit_trace.setdefault(req.rid, []).append(trace_h[i])
            if len(req.tokens) >= req.max_new_tokens or tok == self.eos_id:
                slot.state = SlotState.DRAINING
                self.metrics.on_finish(req, now)
                finished.append(req)

    def _apply_spec_emits(self, emits, toks_h, block_h, trace_h,
                          finished: List[Request]) -> None:
        """Accept a retired speculative block per lane: emission 1 is the
        argmax at the last replayed position (always committed: its whole
        input prefix was), and each draft position matching the previous
        emission commits one more. A fully matched block keeps the advanced
        lane state; otherwise both lanes (target and draft) are restored
        from their rollback buffers and the new emissions join the replay
        queue. A finish (budget or EOS) inside a block drops the surplus
        emissions into ``spec_discarded_tokens``: they never reach the
        stream, its timings or goodput."""
        now = self._now()
        k = self.spec_k
        for i, (slot, req, r, first) in enumerate(emits):
            if slot.req is not req:
                continue  # lane recycled under the block
            slot.pending -= 1
            if slot.state is not SlotState.DECODING:
                continue  # cancel landed at an earlier retire: discard
            out = toks_h[slot.lane]
            blk = block_h[slot.lane]
            emitted = [int(out[r - 1])]
            for p in range(r, k):
                if int(blk[p]) != emitted[-1]:
                    break
                emitted.append(int(out[p]))
            full_accept = len(emitted) == k - r + 1
            self.metrics.spec_accepted += len(emitted) - 1
            self.tel.trace.instant("spec_accept", rid=req.rid, accepted=len(emitted) - 1,
                                   proposed=k - r, full=int(full_accept))
            kept = emitted[: req.max_new_tokens - len(req.tokens)]
            if self.eos_id is not None and self.eos_id in kept:
                kept = kept[: kept.index(self.eos_id) + 1]
            self.metrics.spec_discarded_tokens += len(emitted) - len(kept)
            for j, tok in enumerate(kept):
                slot.last_token = tok
                req.tokens.append(tok)
                self.metrics.on_token(req, now, first and j == 0)
                self.metrics.spec_emitted_tokens += 1
                if trace_h is not None:
                    self.logit_trace.setdefault(req.rid, []).append(trace_h[i, r - 1 + j])
            if len(req.tokens) >= req.max_new_tokens or (
                self.eos_id is not None and kept and kept[-1] == self.eos_id
            ):
                slot.state = SlotState.DRAINING
                self.metrics.on_finish(req, now)
                finished.append(req)
            elif full_accept:
                # the block the lanes consumed was all committed tokens: keep
                # the advanced state; only the bonus emission is pending
                slot.spec.queue = [emitted[-1]]
            else:
                # a draft token in the consumed block was wrong: restore both
                # lanes to their pre-block state and replay the grown queue
                # (r + new emissions <= k)
                self.metrics.spec_rollbacks += 1
                self.tel.trace.instant("spec_rollback", rid=req.rid)
                lane = self._lanes[slot.lane]
                self._inject(self.pool.caches, lane, self._rollback[slot.lane])
                self._d_inject(self.draft_caches, lane, self._d_rollback[slot.lane])
                slot.spec.queue = slot.spec.queue + kept

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
            now = self._agreed_now()
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
