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
  * ``lax.axis_index`` -> :attr:`AxisGroup.index`.

Under the gloo backend a collective that gloo does not run on CUDA tensors
(``GLOO_STAGED``) goes through pinned host memory: the operand is copied
out, the collective runs on the copy, and the result is copied back to the
card. The kernels still run on the card, and :meth:`Mesh.describe` says
which collectives are staged. NCCL and CPU tensors are never staged.
"""
from __future__ import annotations

import contextlib
import math
import time
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

# The collectives gloo does not run on CUDA tensors. On the H100 machine
# (PyTorch 2.11, CUDA 12.8) gloo's all_reduce, all_gather, broadcast and
# all_gather_into_tensor take CUDA tensors; a point-to-point send of one
# hands the device pointer to the socket and the process aborts.
GLOO_STAGED = ("shift",)


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

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """The axis's pieces of ``x`` side by side along the last dim, in
        axis order: JAX's ``all_gather(x, axis, axis=-1, tiled=True)``."""
        if self.size == 1:
            return x
        with self._timed("all_gather", x):
            src = self._stage("all_gather", x)
            parts = [torch.empty_like(src) for _ in self.ranks]
            dist.all_gather(parts, src, group=self.group)
            return torch.cat(parts, dim=-1).to(x.device)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the axis (JAX's ``psum``), a new tensor."""
        if self.size == 1:
            return x
        with self._timed("all_reduce", x):
            buf = self._stage("all_reduce", x)
            buf = buf.clone() if buf is x else buf
            dist.all_reduce(buf, group=self.group)
            return buf.to(x.device)

    def shift(self, x: torch.Tensor):
        """Send ``x`` to the next rank on the ring and receive the previous
        rank's (JAX's ``ppermute`` with pairs ``(i, i + 1 mod k)``). The
        transfer starts now; the returned function waits for it and gives
        the received tensor, so the caller computes in between."""
        if self.size == 1:
            return lambda: x
        with self._timed("shift", x):
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


class Mesh:
    """``shape``: axis name -> size, in mesh order. A mesh of live ranks
    also has this rank's ``coords`` and an :class:`AxisGroup` per axis
    (``axis(name)``); a spec-only mesh (``make_production_mesh``) has
    neither, and serves ``distribution/sharding.py``'s spec functions."""

    def __init__(self, shape: Dict[str, int], coords: Optional[Dict[str, int]] = None,
                 groups: Optional[Dict[str, AxisGroup]] = None, backend: Optional[str] = None):
        self.shape = dict(shape)
        self.coords = coords
        self.groups = groups or {}
        self.backend = backend

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

    def describe(self) -> str:
        """The startup line of a live mesh: backend, ranks and the
        collectives staged through host memory."""
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
            pg = dist.new_group(ranks) if len(ranks) > 1 else None
            if rank in ranks:
                groups[name] = AxisGroup(ranks, ranks.index(rank), pg, staged)
    return Mesh({"data": data, "model": model_axis}, coords, groups, backend)


def dp_axes(mesh: Mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)
