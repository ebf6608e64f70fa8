"""Device meshes of the port (``repro/launch/mesh.py``) over
``torch.distributed``: one rank per shard.

A :class:`Mesh` has JAX's shape and axis names (``data``, ``model``;
``pod`` leads in the multi-pod production shape) and, for a mesh of live
ranks, this rank's coordinate on each axis and one :class:`AxisGroup` per
axis: the process group of the ranks that share every other coordinate.
The ranks lie on the mesh in JAX's ``make_mesh`` order, row-major:
rank = data index x model size + model index.

The collectives of JAX's ``shard_map`` bodies are methods of the axis group
(inside :func:`timed_collectives`, each is also timed):

  * ``lax.all_gather(.., tiled=True)`` -> :meth:`AxisGroup.all_gather`
    (``dist.all_gather``, the pieces put back in axis order along the last
    dim);
  * ``lax.psum`` -> :meth:`AxisGroup.all_reduce`;
  * ``lax.ppermute`` to the ring neighbour -> :meth:`AxisGroup.shift`
    (``dist.batch_isend_irecv``, started before the caller's compute and
    waited for after it);
  * ``lax.axis_index`` -> :attr:`AxisGroup.index`;
  * FSDP's gradient reduction -> :meth:`AxisGroup.reduce_scatter` (the sum
    over the axis, this rank's block along one dim);
  * one rank's tensor to the rest of the axis (a lane snapshot taken on the
    data rank that owns the lane) -> :meth:`AxisGroup.broadcast`.

The continuous-batching engine runs one ``Scheduler`` per rank, and every
rank must take the same decision on the same tick: :meth:`Mesh.host_broadcast`
gives every rank rank 0's reading of a host number (the tick's clock), as
:meth:`Mesh.host_all_reduce` reduces one, through gloo on the host.

Every process group the port starts has a timeout of ``GROUP_TIMEOUT``
(300 s): ranks that stop calling the same collectives fail with an error
instead of waiting for ever.

Two autograd Functions stand at the edges of a per-rank region (a
``shard_map`` body, whose backward JAX derives by transposing it): each
model rank computes its shard's part of the region from inputs replicated
over the axis, and every rank computes the same replicated loss from the
gathered outputs. :func:`enter` is the identity forward and sums the
cotangent over the axis backward (the rank's partial products of the
replicated input's gradient); :func:`gather` is the tiled ``all_gather``
forward and takes this rank's lane slice of the (replicated) cotangent
backward; :func:`combine` (a ``psum`` of partial outputs) passes the
cotangent through unchanged. FSDP's gather of a data-sharded weight where
a block uses it (:class:`FsdpPlan`) is the same all_gather over "data",
whose backward reduce-scatters the cotangent to the shard.

Sequence parallelism (Megatron-SP; the train step under ``use_rules(mesh,
sp=True)``) slices the residual stream (rows, S, d) along its sequence over
the model axis between blocks. Two autograd pairs move it:
:func:`seq_gather` (all_gather forward, reduce_scatter backward) and
:func:`seq_scatter` (reduce_scatter forward, all_gather backward), at the
edges of a region run under :func:`partial_cotangents`, where each rank's
cotangent of a replicated tensor is its own part (:func:`enter` is then
the identity and :func:`gather`'s backward reduce-scatters). A block that
runs on the whole sequence takes the gathered slices (:func:`gather` along
dim 1) and keeps its slice of the output (:func:`seq_slice`: all_gather
backward).

The data-parallel axes are ("pod", "data"), JAX's batch axes
(:func:`dp_axes`): :meth:`Mesh.dp_group` is the group of the ranks that
share this rank's model coordinate, over both, and the train step splits
its rows and sums its grads over it; FSDP gathers over "data" alone, as
JAX's ``fsdp`` rule shards over it. A mesh of live ranks has no "pod", and
its data-parallel group is its "data" group.

A virtual rank (:func:`virtual_mesh`) stands for one rank of a mesh of any
size, the production (16, 16) and (2, 16, 16) ones included, in one
process: its groups have JAX's ranks and this rank's ``index`` and run no
collective (:class:`VirtualAxisGroup`). Each returns a tensor of the shape
and dtype the live method returns, on the operand's device, filled from the
rank's own operand (the local piece tiled, or copied), so a step run on it
is shape-true and finite but its values are not the mesh's. The dry run
(``launch/dryrun.py``) runs a rank's step on it on meta tensors.

Inside :func:`recorded_collectives` every collective of live or virtual
groups is logged as a :class:`Collective`, ``(op, result bytes, entry)``
with the result's element count as ``elems``, under the names of JAX's
HLO (``all-gather``, ``all-reduce``, ``reduce-scatter``,
``collective-permute`` for ``shift``; ``broadcast`` apart, JAX has no such
op); ``entry`` is False for a collective inside :func:`loop_body`, the
port's per-layer and per-microbatch loops, which JAX scans (the backward
of an autograd collective keeps the flag of its forward).

Under the gloo backend a collective that gloo does not run on CUDA tensors
(``GLOO_STAGED``) goes through pinned host memory: the operand is copied
out, the collective runs on the copy, and the result is copied back to the
card. The kernels still run on the card, and :meth:`Mesh.describe` says
which collectives are staged. NCCL and CPU tensors are never staged.
"""
from __future__ import annotations

import contextlib
import contextvars
import datetime
import math
import os
import time
from typing import Dict, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.tree import tree_map

# The collectives gloo does not run on CUDA tensors. On the H100 machine
# (PyTorch 2.11, CUDA 12.8) gloo's all_reduce (sum and max), all_gather,
# broadcast, all_gather_into_tensor and reduce_scatter_tensor take CUDA
# tensors; a point-to-point send of one hands the device pointer to the
# socket and the process aborts.
GLOO_STAGED = ("shift",)
# The timeout of every process group the port starts (init_process_group,
# the mesh's axis groups): a collective that some rank never joins raises
# after it.
GROUP_TIMEOUT = datetime.timedelta(seconds=300)
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
# JAX's HLO names of the collectives, by method (``broadcast`` has none).
HLO_OPS = {"all_gather": "all-gather", "all_reduce": "all-reduce",
           "reduce_scatter": "reduce-scatter", "shift": "collective-permute",
           "broadcast": "broadcast"}


class Collective(tuple):
    """One logged collective: ``(op, result bytes, entry)``, and the result's
    element count as ``elems`` (the contract ledger's size classes count
    elements, as JAX's HLO fingerprints do)."""

    def __new__(cls, op: str, nbytes: int, entry: bool, elems: int):
        self = super().__new__(cls, (op, nbytes, entry))
        self.elems = elems
        return self

    def __getnewargs__(self):
        return (*self, self.elems)


# Depth of the enclosing per-layer / per-microbatch loops (:func:`loop_body`).
_LOOP: contextvars.ContextVar[int] = contextvars.ContextVar("collective_loop", default=0)


@contextlib.contextmanager
def _at_loop_depth(depth: int):
    tok = _LOOP.set(depth)
    try:
        yield
    finally:
        _LOOP.reset(tok)


def loop_body():
    """Mark the enclosed collectives as inside a loop body (a layer of the
    stack, a microbatch): JAX scans these, so its entry computation holds
    only the collectives outside them."""
    return _at_loop_depth(_LOOP.get() + 1)


class AxisGroup:
    """One mesh axis seen from this rank: ``ranks`` (global, in axis order),
    this rank's ``index`` on the axis, and the process group (None for an
    axis of one rank, whose collectives are the identity)."""

    def __init__(self, ranks: Sequence[int], index: int, group, staged=()):
        self.ranks = tuple(ranks)
        self.index = index
        self.group = group
        self.staged = frozenset(staged)
        self.clock = None  # op -> seconds, inside timed_collectives
        self.log = None    # Collective list, inside recorded_collectives

    def _record(self, op: str, out: torch.Tensor) -> torch.Tensor:
        """Log ``out``, the result of ``op``, when recording; returns it."""
        if self.log is not None:
            self.log.append(Collective(HLO_OPS[op], out.numel() * out.element_size(),
                                       _LOOP.get() == 0, out.numel()))
        return out

    @contextlib.contextmanager
    def _timed(self, op: str, x: torch.Tensor):
        """Add the enclosed host time to ``clock[op]`` when timing, with the
        card's queued work finished before and after."""
        if self.clock is None:
            yield
            return
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        t0 = time.perf_counter()
        yield
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        self.clock[op] = self.clock.get(op, 0.0) + time.perf_counter() - t0

    @property
    def size(self) -> int:
        return len(self.ranks)

    def _stage(self, op: str, x: torch.Tensor) -> torch.Tensor:
        """``x`` itself, or its copy in pinned host memory where ``op`` is
        staged and ``x`` lies on the card."""
        if op in self.staged and x.is_cuda:
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            return host.copy_(x)
        return x.contiguous()

    def all_gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The axis's pieces of ``x`` side by side along ``dim`` (default the
        last), in axis order: JAX's ``all_gather(x, axis, axis=dim,
        tiled=True)``."""
        if self.size == 1:
            return x
        with self._timed("all_gather", x):
            src = self._stage("all_gather", x)
            parts = [torch.empty_like(src) for _ in self.ranks]
            dist.all_gather(parts, src, group=self.group)
            return self._record("all_gather", torch.cat(parts, dim=dim).to(x.device))

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The sum (``op="max"``: the maximum) of ``x`` over the axis (JAX's
        ``psum`` / ``pmax``), a new tensor."""
        if self.size == 1:
            return x
        with self._timed("all_reduce", x):
            buf = self._stage("all_reduce", x)
            buf = buf.clone() if buf is x else buf
            dist.all_reduce(buf, op=_OPS[op], group=self.group)
            return self._record("all_reduce", buf.to(x.device))

    def reduce_scatter(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The sum of ``x`` over the axis, of which this rank keeps its block
        along ``dim`` (``x.shape[dim]`` divides by the axis size): FSDP's
        gradient reduction, a new tensor."""
        if self.size == 1:
            return x
        with self._timed("reduce_scatter", x):
            src = self._stage("reduce_scatter", x.movedim(dim, 0))
            out = torch.empty((src.shape[0] // self.size,) + src.shape[1:], dtype=src.dtype,
                              device=src.device, pin_memory=src.is_pinned())
            dist.reduce_scatter_tensor(out, src, group=self.group)
            return self._record("reduce_scatter", out.to(x.device).movedim(0, dim).contiguous())

    def broadcast(self, x: Optional[torch.Tensor], src: int, like: torch.Tensor = None
                  ) -> torch.Tensor:
        """Rank ``src``'s (an axis index) ``x`` on every rank of the axis: the
        source passes its tensor, the others None and ``like``, a tensor of
        the shape and dtype to receive (on the device it is wanted on). A
        new tensor on the source too (on an axis of one rank, ``x``
        itself)."""
        if self.size == 1:
            return x
        ref = x if self.index == src else like
        with self._timed("broadcast", ref):
            buf = (self._stage("broadcast", x).clone() if self.index == src else
                   self._stage("broadcast", torch.empty_like(like)))
            dist.broadcast(buf, src=self.ranks[src], group=self.group)
            return self._record("broadcast", buf.to(ref.device))

    def shift(self, x: torch.Tensor):
        """Send ``x`` to the next rank on the ring and receive the previous
        rank's (JAX's ``ppermute`` with pairs ``(i, i + 1 mod k)``). The
        transfer starts now; the returned function waits for it and gives
        the received tensor, so the caller computes in between."""
        if self.size == 1:
            return lambda: x
        with self._timed("shift", x):
            self._record("shift", x)
            src = self._stage("shift", x)
            dst = torch.empty_like(src)
            k = self.size
            ops = [dist.P2POp(dist.isend, src, self.ranks[(self.index + 1) % k],
                              group=self.group),
                   dist.P2POp(dist.irecv, dst, self.ranks[(self.index - 1) % k],
                              group=self.group)]
            works = dist.batch_isend_irecv(ops)

        def wait() -> torch.Tensor:
            with self._timed("shift_wait", x):
                for w in works:
                    w.wait()
                return dst.to(x.device)

        return wait


class VirtualAxisGroup(AxisGroup):
    """One axis of a virtual rank (:func:`virtual_mesh`): JAX's ranks on the
    axis and this rank's ``index``, no process group. Each collective runs
    no communication and returns what the live one would in shape, dtype
    and device, made from this rank's operand: ``all_gather`` the operand
    tiled along ``dim``, ``all_reduce`` and ``broadcast`` a copy of the
    operand (of ``like`` on a rank that is not the source), ``reduce_scatter``
    a copy of the rank's block of it, ``shift`` a copy. An axis of one rank
    is the identity, as a live one is."""

    def all_gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        if self.size == 1:
            return x
        return self._record("all_gather", torch.cat([x] * self.size, dim=dim))

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        if self.size == 1:
            return x
        return self._record("all_reduce", x.clone(memory_format=torch.contiguous_format))

    def reduce_scatter(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        if self.size == 1:
            return x
        n = x.shape[dim] // self.size
        block = x.narrow(dim, self.index * n, n)
        return self._record("reduce_scatter", block.clone(memory_format=torch.contiguous_format))

    def broadcast(self, x: Optional[torch.Tensor], src: int, like: torch.Tensor = None
                  ) -> torch.Tensor:
        if self.size == 1:
            return x
        ref = x if self.index == src else like
        return self._record("broadcast", ref.clone(memory_format=torch.contiguous_format))

    def shift(self, x: torch.Tensor):
        if self.size == 1:
            return lambda: x
        out = self._record("shift", x.clone(memory_format=torch.contiguous_format))
        return lambda: out


# Whether the enclosed region's replicated tensors carry partial cotangents
# (:func:`partial_cotangents`): read by :func:`enter` and :func:`gather` in
# the forward, so the backward needs no context.
_PARTIAL: contextvars.ContextVar[bool] = contextvars.ContextVar("partial_cotangents",
                                                                default=False)


@contextlib.contextmanager
def partial_cotangents(on: bool = True):
    """Inside a Megatron sequence-parallel region (between :func:`seq_gather`
    and :func:`seq_scatter`) each model rank's cotangent of a replicated
    tensor is its own part only, and their sum over the axis is the whole:
    :func:`enter` is then the identity both ways (the sum waits for the
    region's :func:`seq_gather`, a reduce-scatter), and :func:`gather`'s
    backward reduce-scatters the parts. A leaf held whole over the axis and
    used in the region gets its rank's part of the gradient, which the train
    step sums over "model". ``on`` False leaves the mode as it is."""
    if not on:
        yield
        return
    tok = _PARTIAL.set(True)
    try:
        yield
    finally:
        _PARTIAL.reset(tok)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.loop = group, _LOOP.get()
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        with _at_loop_depth(ctx.loop):
            return ctx.group.all_reduce(g.contiguous()), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, reduce):
        ctx.group, ctx.dim, ctx.reduce, ctx.width = group, dim, reduce, x.shape[dim]
        ctx.loop = _LOOP.get()
        return group.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce:
            with _at_loop_depth(ctx.loop):
                return ctx.group.reduce_scatter(g.contiguous(), ctx.dim), None, None, None
        lane0 = ctx.group.index * ctx.width
        return g.narrow(ctx.dim, lane0, ctx.width).contiguous(), None, None, None


class _Combine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return group.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


def enter(x: Optional[torch.Tensor], group: Optional[AxisGroup]) -> Optional[torch.Tensor]:
    """``x``, replicated over ``group``'s axis, as read inside a per-rank
    region: the identity forward, the cotangent summed over the axis
    backward (each rank's is its own partial product). None passes; no
    group (one device) and :func:`partial_cotangents` are the identity."""
    if x is None or group is None or group.size == 1 or _PARTIAL.get():
        return x
    return _Enter.apply(x, group)


def gather(x: torch.Tensor, group: Optional[AxisGroup], dim: int = -1) -> torch.Tensor:
    """This rank's lanes of a region's output gathered to full width along
    ``dim``, default the last (:meth:`AxisGroup.all_gather`); backward,
    this rank's lane slice of the cotangent, which every rank holds whole:
    no collective (under :func:`partial_cotangents` the parts
    reduce-scattered). No group (one device) is the identity."""
    if group is None or group.size == 1:
        return x
    return _Gather.apply(x, group, dim, _PARTIAL.get())


def combine(x: torch.Tensor, group: Optional[AxisGroup]) -> torch.Tensor:
    """The sum of the ranks' partial outputs over the axis; backward, the
    (replicated) cotangent unchanged. No group (one device) is the
    identity."""
    return x if group is None or group.size == 1 else _Combine.apply(x, group)


class _SeqScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.loop = group, _LOOP.get()
        return group.reduce_scatter(x, 1)

    @staticmethod
    def backward(ctx, g):
        with _at_loop_depth(ctx.loop):
            return ctx.group.all_gather(g.contiguous(), 1), None


class _SeqSlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.loop = group, _LOOP.get()
        n = x.shape[1] // group.size
        return x.narrow(1, group.index * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        with _at_loop_depth(ctx.loop):
            return ctx.group.all_gather(g.contiguous(), 1), None


# Sequence parallelism (Megatron-SP): between blocks the residual stream
# (rows, S, d) is the rank's slice (rows, S / k, d) along the sequence.

def seq_gather(x: torch.Tensor, group: Optional[AxisGroup]) -> torch.Tensor:
    """The ranks' sequence slices of ``x`` (rows, S / k, ...) whole along dim
    1 (an all-gather), entering a :func:`partial_cotangents` region; backward,
    the ranks' parts of the cotangent summed and this rank's slice kept (a
    reduce-scatter). No group is the identity."""
    return x if group is None or group.size == 1 else _Gather.apply(x, group, 1, True)


def seq_scatter(x: torch.Tensor, group: Optional[AxisGroup]) -> torch.Tensor:
    """The sum over the axis of the ranks' partial outputs (rows, S, ...),
    of which this rank keeps its sequence slice (a reduce-scatter along dim
    1): the row-parallel product's exit under sequence parallelism, in place
    of :func:`combine`'s all-reduce; backward, the slices' cotangents
    gathered whole (an all-gather). No group is the identity."""
    return x if group is None or group.size == 1 else _SeqScatter.apply(x, group)


def seq_slice(x: torch.Tensor, group: Optional[AxisGroup]) -> torch.Tensor:
    """This rank's sequence slice of ``x`` (rows, S, ...), replicated over the
    axis: backward, the slices' cotangents gathered whole (an all-gather),
    so the region before it computed on whole cotangents; under
    :func:`partial_cotangents` the slice's cotangent alone, zero elsewhere:
    no collective. No group is the identity."""
    if group is None or group.size == 1:
        return x
    if _PARTIAL.get():
        n = x.shape[1] // group.size
        return x.narrow(1, group.index * n, n).contiguous()
    return _SeqSlice.apply(x, group)


class FsdpPlan(NamedTuple):
    """The train step's FSDP gathers (JAX's per-layer all-gather inside its
    scanned layers): ``dims``, a tree like the params holding each leaf's
    dim over "data" (None: the leaf is whole on every data rank); ``group``,
    the data axis; ``reduce``, whether the data ranks computed different
    rows of the microbatch. :meth:`gather` makes a subtree whole where it is
    used. Its backward takes the rank's block of the cotangent along the
    same dim: with ``reduce`` summed over "data" first (a reduce-scatter:
    the data-parallel sum of the shard's grad), else as it is (every data
    rank computed the whole microbatch: ``mb % D``, JAX's divisibility
    fallback)."""
    dims: Dict
    group: AxisGroup
    reduce: bool

    def gather(self, tree, path: str, layer: bool = False):
        """``tree``, the params' subtree at ``path`` (``/``-joined keys), or
        with ``layer`` one layer's slice of the stacked subtree, with each
        data-sharded leaf gathered whole over "data"."""
        dims = self.dims
        for k in path.split("/"):
            dims = dims[k]
        return tree_map(lambda x, d: x if d is None else
                        _Gather.apply(x, self.group, d - layer, self.reduce), tree, dims)


class Mesh:
    """``shape``: axis name -> size, in mesh order. A mesh of live ranks
    also has this rank's ``coords`` and an :class:`AxisGroup` per axis
    (``axis(name)``); a spec-only mesh (``make_production_mesh``) has
    neither, and serves ``distribution/sharding.py``'s spec functions."""

    def __init__(self, shape: Dict[str, int], coords: Optional[Dict[str, int]] = None,
                 groups: Optional[Dict[str, AxisGroup]] = None, backend: Optional[str] = None,
                 host_group=None, dp: Optional[AxisGroup] = None):
        self.shape = dict(shape)
        self.coords = coords
        self.groups = groups or {}
        self.backend = backend
        self.host_group = host_group  # gloo group of every rank (None: the world's)
        self.dp = dp  # the group over ("pod", "data") where both are axes

    @property
    def virtual(self) -> bool:
        """True for a virtual rank (:func:`virtual_mesh`)."""
        return self.backend == "virtual"

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def axis(self, name: str) -> AxisGroup:
        if name not in self.groups:
            raise ValueError(f"mesh {self.shape} has no live axis {name!r}")
        return self.groups[name]

    def dp_group(self) -> AxisGroup:
        """The data-parallel group of this rank: the ranks that share its
        model coordinate, over ("pod", "data") in JAX's order (pod major),
        or the "data" group where the mesh has no "pod"."""
        return self.dp if self.dp is not None else self.axis("data")

    def host_all_reduce(self, value: float, op: str = "sum") -> float:
        """A host number (a flag, a count) reduced over every rank of the
        mesh, as a CPU tensor through gloo: the world group under gloo, a
        gloo group of the same ranks under NCCL. No card work is waited for.
        A virtual rank returns its own reading."""
        if self.size == 1 or self.virtual:
            return value
        t = torch.tensor([value], dtype=torch.float64)
        dist.all_reduce(t, op=_OPS[op], group=self.host_group)
        return float(t[0])

    def host_broadcast(self, value: float, src: int = 0) -> float:
        """Rank ``src``'s host number on every rank of the mesh (through
        gloo on the host, as :meth:`host_all_reduce`): what lets the ranks'
        engines take every decision on one clock reading."""
        if self.size == 1 or self.virtual:
            return value
        t = torch.tensor([value], dtype=torch.float64)
        dist.broadcast(t, src=src, group=self.host_group)
        return float(t[0])

    def describe(self) -> str:
        """The startup line of a live mesh: backend, ranks and the
        collectives staged through host memory."""
        if self.virtual:
            return (f"dist: virtual rank {self.coords} of mesh {self.shape}: no collective "
                    "runs; each returns the rank's own operand tiled or copied (shape-true, "
                    "not the mesh's values)")
        staged = sorted(set().union(*(g.staged for g in self.groups.values())))
        return (f"dist: backend {self.backend}, {self.size} ranks on mesh {self.shape}"
                + (f"; CUDA tensors staged through pinned host memory for: {', '.join(staged)}"
                   if staged else ""))


@contextlib.contextmanager
def timed_collectives(mesh: Mesh):
    """Time every collective of ``mesh``'s axes while inside: the host
    seconds of each, by name (``shift_wait``: the wait for a ring shift
    after the compute it overlaps), add up in the dict this yields. Each
    timed collective first waits for the card's queued work, so its time is
    its own (staging included) and none of the compute before it; the waits
    serialise compute and communication, so a timed step splits the time
    but is not the step's own time."""
    clock: Dict[str, float] = {}
    for g in mesh.groups.values():
        g.clock = clock
    try:
        yield clock
    finally:
        for g in mesh.groups.values():
            g.clock = None


@contextlib.contextmanager
def recorded_collectives(mesh: Mesh):
    """Log every collective of ``mesh``'s groups while inside: the list this
    yields gets a :class:`Collective` per call, in call order (the module
    docstring)."""
    log: list = []
    groups = list(mesh.groups.values()) + ([mesh.dp] if mesh.dp is not None else [])
    for g in groups:
        g.log = log
    try:
        yield log
    finally:
        for g in groups:
            g.log = None


def _ranks_along(shape: Dict[str, int], coords: Dict[str, int], axes: Sequence[str]) -> list:
    """The global ranks (row-major over ``shape``'s axes) that share every
    coordinate of ``coords`` but those on ``axes``, in the order of those
    axes' coordinates (the first axis major)."""
    names = list(shape)
    out = []
    for flat in range(math.prod(shape[a] for a in axes)):
        c = dict(coords)
        for a in reversed(axes):
            c[a], flat = flat % shape[a], flat // shape[a]
        rank = 0
        for a in names:
            rank = rank * shape[a] + c[a]
        out.append(rank)
    return out


def virtual_mesh(shape: Dict[str, int], coords: Optional[Dict[str, int]] = None) -> Mesh:
    """One rank of a mesh of ``shape`` (axis name -> size, in mesh order) at
    ``coords`` (default every coordinate 0), in this process: a
    :class:`VirtualAxisGroup` per axis with JAX's ranks (row-major, as
    ``make_mesh`` lays them) and this rank's index, and the data-parallel
    group over ("pod", "data") where the mesh has both. No process group is
    made and no collective runs (the module docstring)."""
    coords = {a: 0 for a in shape} if coords is None else dict(coords)
    if set(coords) != set(shape) or any(not 0 <= coords[a] < n for a, n in shape.items()):
        raise ValueError(f"coords {coords} are no rank of mesh {shape}")

    def group(axes):
        ranks = _ranks_along(shape, coords, axes)
        index = 0
        for a in axes:
            index = index * shape[a] + coords[a]
        return VirtualAxisGroup(ranks, index, None)

    groups = {a: group((a,)) for a in shape}
    dp = group(dp_axes(Mesh(shape))) if len(dp_axes(Mesh(shape))) > 1 else None
    return Mesh(shape, coords, groups, "virtual", dp=dp)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """JAX's production shape, spec-only: (data 16, model 16), or with
    ``multi_pod`` (pod 2, data 16, model 16)."""
    if multi_pod:
        return Mesh({"pod": 2, "data": 16, "model": 16})
    return Mesh({"data": 16, "model": 16})


def make_local_mesh(model_axis: int = 1, *, device: Optional[torch.device] = None) -> Mesh:
    """The (data, model) mesh over the ranks of the initialised process
    group (one rank without one): ``model_axis`` ranks per model group, the
    rest along ``data``. Every rank must call it: each creates every axis
    group, in the same order. ``device``: where the collectives' operands
    lie (under gloo, CUDA operands of ``GLOO_STAGED`` collectives are
    staged)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if model_axis < 1 or world % model_axis:
        raise ValueError(f"model axis {model_axis} does not divide the {world} ranks")
    data = world // model_axis
    backend = dist.get_backend() if dist.is_initialized() else None
    staged = GLOO_STAGED if backend == "gloo" and (device is None or device.type == "cuda") else ()
    coords = {"data": rank // model_axis, "model": rank % model_axis}
    lines = {"model": [[d * model_axis + j for j in range(model_axis)] for d in range(data)],
             "data": [[i * model_axis + j for i in range(data)] for j in range(model_axis)]}
    groups = {}
    for name in ("data", "model"):
        for ranks in lines[name]:
            pg = dist.new_group(ranks, timeout=GROUP_TIMEOUT) if len(ranks) > 1 else None
            if rank in ranks:
                groups[name] = AxisGroup(ranks, ranks.index(rank), pg, staged)
    host = (dist.new_group(backend="gloo", timeout=GROUP_TIMEOUT)
            if backend not in (None, "gloo") else None)
    return Mesh({"data": data, "model": model_axis}, coords, groups, backend, host)


def torchrun_world() -> int:
    """The world size ``torchrun`` gave this process (1 outside it)."""
    return int(os.environ.get("WORLD_SIZE", "1")) if "RANK" in os.environ else 1


def dp_axes(mesh: Mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)
