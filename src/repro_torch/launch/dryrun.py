"""The dry run of the port (``repro/launch/dryrun.py``): one rank's step of
every (arch x shape x mesh) cell over the production meshes, (16, 16) and
(2, 16, 16), from stand-ins that hold no data.

What "compiles" means here. PyTorch has no lowering to prove, so a cell is
``ok`` when one rank's whole train, prefill or decode step ran on the meta
device at the rank's local shapes: every op of the step ran on tensors of
the shapes and dtypes the rank holds (params and moments under JAX's
``param_specs`` with the config's ``fsdp``, the caches under its
``cache_specs``, the inputs under its ``batch_specs``), and every
collective the step called was shape-consistent on a virtual rank of the
mesh (``launch/mesh.py::virtual_mesh``: JAX's ranks and this rank's index,
no communication; each collective returns the rank's own operand tiled or
copied, so the run is shape-true, not numerically meaningful). The kernels
take their meta branches (``kernels/common.py``): the outputs and workspace
their CUDA wrappers allocate, no launch. ``chip_smoke.py``'s ``dryrun``
phase runs the same rank's step of two cells on the H100 at the same local
shapes and holds it to this run's shapes, collectives, kernel calls and
memory. Not proven: NCCL (no collective crossed a process here), the other
ranks' data (one rank per class of local shapes runs; the others' shapes are
checked from the specs alone), and any overlap of the ranks.

Per cell the record (``--out``, one JSON file a cell) has JAX's keys:

  * ``full_step``: ``wall_s`` (the meta run's host seconds, in place of
    JAX's ``lower_s`` / ``compile_s``); ``memory``: ``argument_bytes`` (JAX's
    meaning: the rank's shards of every input; the port's train step takes
    the global batch on every rank, whose bytes are ``held_batch_bytes``
    apart), ``output_bytes`` (the outputs under JAX's out_shardings: the loss
    and logits replicated, the state and caches as the rank's shards),
    ``temp_bytes`` (the peak of the live meta bytes made during the step,
    beyond the arguments, tracked storage by storage), ``alias_bytes`` (the
    outputs that are arguments updated in place, JAX's donated buffers),
    ``peak_tensors`` (the ``PEAK_TENSORS`` largest storages live at the
    peak: bytes, the op that made each, its shape and dtype);
    ``cost``: ``flops`` (``torch.utils.flop_counter``'s matmul FLOPs plus
    the kernels' operations by their bounds' formula, ``matmul_flops`` and
    ``kernel_flops`` apart), ``bytes_accessed`` (every op's tensor operands
    and results, views excepted, and the kernels' bytes: an upper bound, as
    XLA's); ``collectives_total`` and ``collectives_entry`` (result bytes by
    JAX's op names, ``count``, and ``counts`` by op; ``broadcast`` apart;
    the total counts every collective the step ran, each layer's, where
    JAX's HLO text holds a loop body once; the entry ones are outside the
    per-layer and per-microbatch loops); ``kernels``: launches, operations
    and bytes by kernel;
  * ``probes`` (single-pod mesh only, as JAX's): train ``block_cost`` (one
    block forward and backward, attention in one block), ``block_mem``
    (the production chunking), ``attn_block_cost`` (a hybrid's shared
    block) and ``head``; decode ``block`` and ``head``; prefill ``block``;
    each measured as the full step is;
  * ``trips`` (JAX's: microbatches and layers), ``ranks`` (the ranks whose
    local shapes were checked, the classes of equal shapes and the ranks
    run), ``wall_s``.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k --mesh pod
  python -m repro_torch.launch.dryrun --all --out artifacts/dryrun_torch [--skip-existing]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
import weakref
from typing import Callable, Dict, NamedTuple, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import shapes as shp
from repro_torch.configs.registry import assigned_names, get_config
from repro_torch.distribution import fused_sharded
from repro_torch.distribution import sharding as shd
from repro_torch.distribution import tensor_parallel
from repro_torch.kernels.common import recorded_kernel_calls
from repro_torch.kernels.fused_rnn import layout
from repro_torch.launch.mesh import Mesh, recorded_collectives, virtual_mesh
from repro_torch.models import attention, lm, rnn
from repro_torch.models.layers import _dtype
from repro_torch.optim.adamw import adamw_init
from repro_torch.training import steps
from repro_torch.tree import flatten_with_paths, tree_leaves, tree_map, unflatten_like

COLLECTIVE_OPS = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute",
)
# What a mis-specified cell can raise while its rank's step runs: shape or
# spec mismatches (ValueError, TypeError, RuntimeError), missing config keys
# (KeyError), unsupported combinations (NotImplementedError): JAX's
# _CELL_ERRORS. Anything else (a NameError in our code) raises.
_CELL_ERRORS = (
    ValueError, TypeError, KeyError, NotImplementedError, RuntimeError,
)
PEAK_TENSORS = 8  # the largest storages live at a step's peak that a record names
MESHES = {"pod": {"data": 16, "model": 16}, "multipod": {"pod": 2, "data": 16, "model": 16}}


# ---------------------------------------------------------------------------
# Measuring one meta run
# ---------------------------------------------------------------------------

class _LiveBytes(TorchDispatchMode):
    """The bytes of the storages the enclosed ops make, live and at their
    peak (a storage is freed when its last tensor is), every op's operand
    and result bytes (views excepted), and which storages of ``args`` some
    op read. Storages of ``args`` and those made before entering are not
    counted as made. ``block``: each storage counts its bytes rounded up to
    a multiple of it (1; the CUDA caching allocator's blocks are 512).
    ``at_peak``: the storages live at the peak, as ``(bytes, op, shape,
    dtype)`` of the op result that made each."""

    def __init__(self, args, block: int = 1):
        super().__init__()
        self.block = block  # bytes a storage is rounded up to (the card's allocator: 512)
        self.args = {t.untyped_storage()._cdata for t in _tensors(args)}
        self.known = set(self.args)
        self.read = set()  # the storages of ``args`` some op read
        self.live = self.peak = self.accessed = 0
        self.shapes = {}  # (op, operands' metadata) -> its results' (``_call``)
        self.made = {}  # storage -> (bytes, op, shape, dtype) of the storages made, while live
        self.at_peak = []

    def _track(self, t: torch.Tensor, func) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.known:
            return
        self.known.add(key)
        n = -(-st.nbytes() // self.block) * self.block
        self.live += n
        self.made[key] = (n, str(func.overloadpacket), tuple(t.shape), str(t.dtype))
        if self.live > self.peak:
            self.peak = self.live
            self.at_peak = list(self.made.values())
        weakref.finalize(st, self._forget, key, n)

    def _forget(self, key: int, n: int) -> None:
        self.known.discard(key)
        self.made.pop(key, None)
        self.live -= n

    def peak_tensors(self, top: int) -> list:
        """The ``top`` largest storages live at the peak."""
        return [{"bytes": n, "op": op, "shape": list(shape), "dtype": dtype}
                for n, op, shape, dtype in sorted(self.at_peak, reverse=True)[:top]]

    def _call(self, func, args, kwargs, operands):
        """``func(*args, **kwargs)`` on meta tensors, its results' shapes
        remembered: a later call with operands of the same metadata gets
        new tensors of those shapes, strides and dtypes without running the
        op's meta kernel again (many are Python, and a long sequence's
        attention repeats one block's ops a thousand times a layer). Views,
        in-place and ``out=`` ops, results that alias an operand and
        operands off meta always run."""
        try:
            key = None if func.is_view or func._schema.is_mutable else \
                (func, _signature(args), _signature(kwargs))
        except _Unkeyed:
            key = None
        if key is not None and key in self.shapes:
            made = self.shapes[key]
            if made is not None:
                return _make(made)
        out = func(*args, **kwargs)
        if key is not None:
            self.shapes[key] = _made_of(out, {t.untyped_storage()._cdata for t in operands})
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        operands = _tensors((args, kwargs))
        out = self._call(func, args, kwargs or {}, operands)
        results = _tensors(out)
        self.read.update(self.args.intersection(t.untyped_storage()._cdata for t in operands))
        if not func.is_view:
            self.accessed += sum(_nbytes(t) for t in operands + results)
        for t in results:
            self._track(t, func)
        return out


class _Unkeyed(Exception):
    """An operand that cannot key the shape memo."""


_SCALARS = (int, float, bool, str, type(None), torch.dtype, torch.device, torch.layout,
            torch.memory_format)


def _signature(x):
    """A hashable key of an op's operands: each meta tensor's shape, strides
    and dtype, each scalar's type and value."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "meta":
            raise _Unkeyed
        return (tuple(x.shape), x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return (type(x), tuple(_signature(v) for v in x))
    if isinstance(x, dict):
        return tuple(sorted((k, _signature(v)) for k, v in x.items()))
    if isinstance(x, _SCALARS):
        return (type(x), x)
    raise _Unkeyed


def _made_of(out, inputs):
    """How to make ``out`` anew (shapes, strides, dtypes), or None where it
    holds anything but fresh meta tensors."""
    if isinstance(out, torch.Tensor):
        if out.device.type != "meta" or out.untyped_storage()._cdata in inputs:
            return None
        return (tuple(out.shape), out.stride(), out.dtype)
    if isinstance(out, (list, tuple)) and out:
        parts = [_made_of(t, inputs) for t in out]
        return None if any(p is None for p in parts) else (type(out), parts)
    return None


def _make(made):
    if isinstance(made[0], type):
        return made[0](_make(p) for p in made[1])
    shape, stride, dtype = made
    return torch.empty_strided(shape, stride, dtype=dtype, device="meta")


def _tensors(tree) -> list:
    """The tensors in nested tuples, lists and dicts (an op's operands and
    results, a step's inputs and outputs), in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (list, tuple)):
        return []
    return [t for x in tree for t in _tensors(x)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _coll(log, entry_only: bool) -> Dict:
    """JAX's ``collective_bytes`` of a recorded log, with ``broadcast`` and
    the count of each op."""
    out: Dict = {op: 0 for op in COLLECTIVE_OPS + ("broadcast",)}
    out["count"], counts = 0, {}
    for op, n, entry in log:
        if entry_only and not entry:
            continue
        out[op] += n
        out["count"] += 1
        counts[op] = counts.get(op, 0) + 1
    out["counts"] = counts
    return out


def measure(fn: Callable, args: tuple, mesh: Mesh, *, arg_bytes: Optional[Dict] = None,
            output_bytes: Optional[Callable] = None, block: int = 1) -> Dict:
    """Run ``fn(*args)`` on ``mesh`` (a virtual rank) and record it as the
    module docstring says: wall seconds, memory, cost, collectives (total
    and entry) and the kernels' calls. ``argument_bytes`` sums the bytes of
    the tensors of ``args`` the step read (as jit drops an argument its
    program never reads), a tensor's taken from ``arg_bytes`` (by ``id``)
    where it has an entry; ``output_bytes(out)`` defaults to the outputs'
    bytes; ``block``: the live bytes' rounding (``_LiveBytes``)."""
    tensors = _tensors(args)
    arg_bytes = [(arg_bytes or {}).get(id(t), _nbytes(t)) for t in tensors]
    live = _LiveBytes(args, block)
    t0 = time.perf_counter()
    # The flop counter above the tracker: it sees every op, the shape memo's too.
    with recorded_collectives(mesh) as log, recorded_kernel_calls() as calls, live, \
            FlopCounterMode(display=False) as flops:
        out = fn(*args)
    wall = time.perf_counter() - t0
    outs = _tensors(out)
    alias = sum(_nbytes(t) for t in outs if t.untyped_storage()._cdata in live.args)
    kernels: Dict = {}
    for c in calls:
        k = kernels.setdefault(c["name"], {"launches": 0, "ops": 0.0, "bytes": 0})
        k["launches"] += c["launches"]
        k["ops"] += c["ops"]
        k["bytes"] += c["bytes"]
    mm = float(flops.get_total_flops())
    kflops = sum(k["ops"] for k in kernels.values())
    record = {
        "wall_s": round(wall, 3),
        "memory": {
            "argument_bytes": sum(n for t, n in zip(tensors, arg_bytes)
                                  if t.untyped_storage()._cdata in live.read),
            "output_bytes": (sum(_nbytes(t) for t in outs) if output_bytes is None
                             else output_bytes(out)),
            "temp_bytes": live.peak,
            "alias_bytes": alias,
            "peak_tensors": live.peak_tensors(PEAK_TENSORS),
        },
        "cost": {"flops": mm + kflops, "matmul_flops": mm, "kernel_flops": kflops,
                 "bytes_accessed": float(live.accessed + sum(k["bytes"]
                                                               for k in kernels.values()))},
        "collectives_total": _coll(log, False),
        "collectives_entry": _coll(log, True),
        "kernels": kernels,
    }
    return record


# ---------------------------------------------------------------------------
# A rank's inputs
# ---------------------------------------------------------------------------

def meta_fill(like: torch.Tensor, role: str) -> torch.Tensor:
    """A stand-in for ``like`` (a meta tensor at the rank's local shape):
    ``like`` itself. A filler for real data (the card's, a test's) reads
    ``role``: what the tensor is (``param/<path>``, ``moment/<path>``,
    ``step``, ``cache/<path>``, ``inputs/<key>``) and makes it on its
    device."""
    return like


def _local_like(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    return torch.empty(shd.local_shape(x.shape, spec, mesh), dtype=x.dtype, device="meta")


def _local(whole, specs, mesh, fill, role: str):
    """``fill`` of the rank's local shape of each leaf of ``whole`` (meta)
    under ``specs``, told ``role/<the leaf's path>``."""
    return shd.map_with_paths(
        lambda path, x: fill(_local_like(x, shd._at(specs, path), mesh), f"{role}/{path}"), whole)


def _bytes(tree) -> int:
    return sum(_nbytes(t) for t in tree_leaves(tree) if t is not None)


def serving_cfg(cfg):
    """The deployment dtype of the serving cells, as JAX's dry run takes it."""
    return cfg.with_(param_dtype="bfloat16")


def serving_specs(cfg, whole, mesh):
    """The specs a serving rank holds ``whole``'s params under: JAX's
    ``param_specs`` with the config's ``fsdp`` (``rank_specs``: the same on
    every leaf of the assigned configs)."""
    return fused_sharded.rank_specs(cfg, shd.param_specs(whole, mesh, fsdp=cfg.fsdp), mesh)


class Step(NamedTuple):
    """One rank's step of a cell: the function, its inputs at the rank's
    local shapes, the bytes in JAX's meaning of the inputs the rank holds
    otherwise (by ``id``: the train step's global batch, whose shard JAX
    holds), the global batch the port's train step holds besides (0 for
    serving) and the outputs' bytes under JAX's out_shardings."""
    fn: Callable
    args: tuple
    arg_bytes: Optional[Dict]
    held_batch_bytes: int
    output_bytes: Callable


def _with_tuple(out, data_bytes: int) -> int:
    """``data_bytes`` plus XLA's output tuple: a step's results are one flat
    tuple whose index table holds 8 bytes a leaf, counted in JAX's
    ``output_size_in_bytes``."""
    return data_bytes + 8 * len(_tensors(out))


def _replicated_logits_bytes(logits: torch.Tensor, batch: int) -> int:
    """The bytes of the whole (replicated) logits of which the rank holds
    its batch rows."""
    return logits.numel() // logits.shape[0] * batch * logits.element_size()


def train_step(cfg, shape, mesh, fill=meta_fill) -> Step:
    """The rank's train step: its shards of the state under
    ``steps.train_param_specs(fsdp=cfg.fsdp)`` (params, both moments, the
    step), the global batch, ``build_train_step``; outputs the state and
    the loss, as JAX's dry run jits ``(state, loss)``."""
    specs = steps.train_param_specs(cfg, mesh, fsdp=cfg.fsdp)
    whole = shp.param_shapes(cfg)
    whole_state = steps.TrainState(params=whole, opt=adamw_init(whole, cfg.moment_dtype), ef=None)
    state = unflatten_like(whole_state, [
        fill(_local_like(x, s, mesh), "step" if path == "opt/step" else
             path.replace("params/", "param/", 1).replace("opt/", "moment/", 1))
        for (path, x), s in zip(flatten_with_paths(whole_state),
                                tree_leaves(steps.train_state_specs(specs)))])
    batch_whole = shp.train_input_specs(cfg, shape)
    batch = {k: fill(v, f"inputs/{k}") for k, v in batch_whole.items()}
    bspecs = shd.batch_specs(batch_whole, mesh)
    shard_bytes = {id(batch[k]): _nbytes(_local_like(v, bspecs[k], mesh))
                   for k, v in batch_whole.items()}
    step_fn = steps.build_train_step(cfg, mesh, specs=specs)

    def fn(state, batch):
        new, metrics = step_fn(state, batch)
        return new, metrics["loss"]

    return Step(fn, (state, batch), shard_bytes, _bytes(batch),
                lambda out: _with_tuple(out, _bytes(out[0]) + _nbytes(out[1])))


def _serving_inputs(cfg, shape, mesh, fill):
    whole = shp.param_shapes(cfg)
    specs = serving_specs(cfg, whole, mesh)
    return specs, _local(whole, specs, mesh, fill, "param")


def _cache_inputs(cfg, shape, mesh, fill):
    whole = shp.cache_specs(cfg, shape)
    return _local(whole, fused_sharded.rank_cache_specs(cfg, whole, mesh), mesh, fill, "cache")


def prefill_step(cfg, shape, mesh, fill=meta_fill) -> Step:
    """The rank's prefill: bf16 params as the rank holds them, its rows of
    the prompt, ``build_prefill_step(..., specs=)``; outputs the logits
    (whole, as JAX's) and the caches (the rank's shards)."""
    cfg = serving_cfg(cfg)
    specs, params = _serving_inputs(cfg, shape, mesh, fill)
    inputs_whole = shp.prefill_input_specs(cfg, shape)
    inputs = _local(inputs_whole, shd.batch_specs(inputs_whole, mesh), mesh, fill, "inputs")
    fn = steps.build_prefill_step(cfg, mesh, batch=shape.global_batch, max_len=shape.seq_len,
                                  device=tree_leaves(params)[0].device, specs=specs)
    return Step(fn, (params, inputs), None, 0,
                lambda out: _with_tuple(out, _replicated_logits_bytes(out[0], shape.global_batch)
                                        + _bytes(out[1])))


def decode_step(cfg, shape, mesh, fill=meta_fill) -> Step:
    """The rank's decode step: bf16 params as the rank holds them, its
    shards of the caches and its rows of the token,
    ``build_decode_step(..., max_len=, specs=)``; outputs the logits (whole,
    as JAX's) and the caches, updated in place."""
    cfg = serving_cfg(cfg)
    specs, params = _serving_inputs(cfg, shape, mesh, fill)
    caches = _cache_inputs(cfg, shape, mesh, fill)
    token_whole = shp.decode_token_spec(cfg, shape)
    token = _local({"t": token_whole}, shd.batch_specs({"t": token_whole}, mesh), mesh, fill,
                   "inputs")["t"]
    fn = steps.build_decode_step(cfg, mesh, max_len=shape.seq_len, specs=specs)
    return Step(fn, (params, caches, token), None, 0,
                lambda out: _with_tuple(out, _replicated_logits_bytes(out[0], shape.global_batch)
                                        + _bytes(out[1])))


STEPS = {"train": train_step, "prefill": prefill_step, "decode": decode_step}


def run_step(cfg, shape, mesh) -> Dict:
    """The rank's full step of a cell, measured on meta."""
    st = STEPS[shape.kind](cfg, shape, mesh)
    rec = measure(st.fn, st.args, mesh, arg_bytes=st.arg_bytes, output_bytes=st.output_bytes)
    rec["memory"]["held_batch_bytes"] = st.held_batch_bytes
    return rec


# ---------------------------------------------------------------------------
# Probes
# ---------------------------------------------------------------------------

def _layer0(tree):
    """The spec (or whole leaf) of one layer of a stacked tree."""
    return tree_map(lambda x: x[1:] if isinstance(x, tuple) else x[0], tree)


def _probe_rows(mesh, rows: int) -> int:
    """The rows a rank computes of ``rows``: its share over ("pod",
    "data") where they divide, else all of them (the steps' rule)."""
    span = steps._rank_rows(mesh, rows)
    return rows if span is None else span[1] - span[0]


def _grad_fn(body: Callable):
    """``fn(params, h, *rest)`` returning the gradients of ``body(params,
    h, *rest)`` (a scalar) with respect to every leaf of ``params`` and
    ``h``: JAX's ``jax.grad(f, argnums=(0, 1))``."""

    def fn(params, h, *rest):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        hh = h.detach().requires_grad_()
        loss = body(unflatten_like(params, leaves), hh, *rest)
        return torch.autograd.grad(loss, leaves + [hh], allow_unused=True)

    return fn


def _train_probes(cfg, shape, mesh) -> Dict:
    """JAX's train probes on the rank: ``block_cost`` and ``block_mem``
    (one block forward and backward under the model's remat, its layer
    gathered by the FSDP plan inside the remat region as ``lm.lm_hidden``
    does), ``attn_block_cost`` (a hybrid's shared block) and ``head``."""
    out = {}
    cfg_cost = cfg.with_(attn_chunk=max(cfg.attn_chunk, shape.seq_len))
    for name, vcfg in (("block_cost", cfg_cost), ("block_mem", cfg)):
        out[name] = _train_block_probe(vcfg, shape, mesh, "layers")
    if cfg.attn_every:
        out["attn_block_cost"] = _train_block_probe(cfg_cost, shape, mesh, "shared_attn")
    out["head"] = _train_head_probe(cfg, shape, mesh)
    return out


def _train_probe_inputs(cfg, shape, mesh):
    """(the train specs, the rows a rank computes of a microbatch, the FSDP
    plan, its hidden states) of a train probe."""
    specs = steps.train_param_specs(cfg, mesh, fsdp=cfg.fsdp)
    rows = shape.global_batch // cfg.microbatches
    local = _probe_rows(mesh, rows)
    fsdp = steps.fsdp_plan(mesh, specs, local < rows)
    h = torch.empty((local, shape.seq_len, cfg.d_model), dtype=_dtype(cfg.compute_dtype),
                    device="meta")
    return specs, local, fsdp, h


def _train_block_probe(cfg, shape, mesh, which: str) -> Dict:
    specs, local, fsdp, h = _train_probe_inputs(cfg, shape, mesh)
    whole = shp.param_shapes(cfg)[which]
    if which == "layers":
        whole, pspecs = _layer0(whole), _layer0(specs[which])
    else:
        pspecs = specs[which]
    params = _local(whole, pspecs, mesh, meta_fill, "param")
    positions = torch.empty((local, shape.seq_len), dtype=torch.int32, device="meta")
    compute = h.dtype

    def body(lp, hh, pos):
        if which == "layers":
            if cfg.cast_params_once:
                lp = layout.cast_params(lp, compute)

            def inner(lp, x):
                lp = lm._whole(fsdp, lp, "layers", layer=True)
                return lm._block_apply(layout.cast_params(lp, compute), cfg, x, pos)

            inner = lm.maybe_remat(inner, cfg.remat)
        else:
            lp = layout.cast_params(lp, compute)

            def inner(sp, x):
                return lm._attn_block_apply(lm._whole(fsdp, sp, "shared_attn"), cfg, x, pos)

            if cfg.remat == "block":
                inner = lm.maybe_remat(inner, "block")
        return torch.sum(inner(lp, hh).float())

    fn = _grad_fn(body)
    with steps._under(mesh, cfg.sequence_parallel):
        return measure(fn, (params, h, positions), mesh)


def _train_head_probe(cfg, shape, mesh) -> Dict:
    specs, local, fsdp, h = _train_probe_inputs(cfg, shape, mesh)
    embed = _local(shp.param_shapes(cfg)["embed"], specs["embed"], mesh, meta_fill, "param")
    targets = torch.empty((local, shape.seq_len), dtype=torch.int32, device="meta")
    mask = torch.empty((local, shape.seq_len), dtype=torch.float32, device="meta")

    def body(ep, hh, tg, mk):
        return lm.head_nll({"embed": ep}, cfg, hh, tg, mk, fsdp) / hh.shape[0]

    with steps._under(mesh, cfg.sequence_parallel):
        return measure(_grad_fn(body), (embed, h, targets, mask), mesh)


def _serve_block_fn(cfg, decode: bool):
    kind = lm.block_kind(cfg)
    if kind == "attn":
        return lm._attn_block_decode if decode else lm._attn_block_prefill
    if kind == "mamba":
        return lm._mamba_block_decode if decode else lm._mamba_block_prefill
    return rnn.rnn_block_decode if decode else rnn.rnn_block_prefill


def _serve_probe_inputs(cfg, shape, mesh, seq: int):
    """(the serving specs, the rank's hidden states, the FSDP plan) of a
    serving probe."""
    specs = serving_specs(cfg, shp.param_shapes(cfg), mesh)
    rows = _probe_rows(mesh, shape.global_batch)
    h = torch.empty((rows, seq, cfg.d_model), dtype=_dtype(cfg.compute_dtype), device="meta")
    return specs, h, steps.fsdp_plan(mesh, specs, False)


def _serve_block_probe(cfg, shape, mesh, decode: bool) -> Dict:
    """One layer's decode (prefill) step on the rank: its params gathered
    by the FSDP plan, its slice of the caches."""
    specs, h, fsdp = _serve_probe_inputs(cfg, shape, mesh, 1 if decode else shape.seq_len)
    whole = shp.param_shapes(cfg)
    params = _local(_layer0(whole["layers"]), _layer0(specs["layers"]), mesh, meta_fill, "param")
    caches_whole = shp.cache_specs(cfg, shape)
    cspecs = fused_sharded.rank_cache_specs(cfg, caches_whole, mesh)
    cache = _local(_layer0(caches_whole["layers"]), _layer0(cspecs["layers"]), mesh, meta_fill,
                   "cache")
    block = _serve_block_fn(cfg, decode)

    def fn(lp, hh, cache):
        with torch.inference_mode(), attention.cache_length(shape.seq_len):
            lp = lm._whole(fsdp, layout.cast_params(lp, hh.dtype), "layers", layer=True)
            return block(lp, cfg, hh, cache)

    with steps._under(mesh):
        return measure(fn, (params, h, cache), mesh)


def _decode_head_probe(cfg, shape, mesh) -> Dict:
    """The head on the rank: hidden states -> logits (JAX's ``logits_apply``)."""
    specs, h, fsdp = _serve_probe_inputs(cfg, shape, mesh, 1)
    embed = _local(shp.param_shapes(cfg)["embed"], specs["embed"], mesh, meta_fill, "param")

    def fn(ep, hh):
        with torch.inference_mode():
            head = layout.cast_params(lm._head_params({"embed": ep}, fsdp), hh.dtype)
            return tensor_parallel.logits(head, hh, tensor_parallel.vocab_group(cfg))

    with steps._under(mesh):
        return measure(fn, (embed, h), mesh)


def _decode_probes(cfg, shape, mesh) -> Dict:
    return {"block": _serve_block_probe(cfg, shape, mesh, True),
            "head": _decode_head_probe(cfg, shape, mesh)}


def _prefill_probes(cfg, shape, mesh) -> Dict:
    return {"block": _serve_block_probe(cfg, shape, mesh, False)}


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------

def _trips(cfg, shape) -> Dict:
    t = {"microbatches": cfg.microbatches if shape.kind == "train" else 1}
    if cfg.attn_every:
        t["layers_mamba"] = cfg.n_layers
        t["layers_attn"] = cfg.n_layers // cfg.attn_every
    else:
        t["layers"] = cfg.n_layers
    return t


def _arg_specs(cfg, shape, mesh) -> list:
    """(whole meta leaf, spec) of every input of a cell's step on ``mesh``:
    what a rank's local shapes are computed from."""
    if shape.kind == "train":
        whole = shp.param_shapes(cfg)
        specs = steps.train_param_specs(cfg, mesh, fsdp=cfg.fsdp)
        batch = shp.train_input_specs(cfg, shape)
        pairs = list(zip(tree_leaves(whole), tree_leaves(specs))) * 3  # params, m, v
        return pairs + list(zip(tree_leaves(batch), tree_leaves(shd.batch_specs(batch, mesh))))
    scfg = serving_cfg(cfg)
    whole = shp.param_shapes(scfg)
    pairs = list(zip(tree_leaves(whole), tree_leaves(serving_specs(scfg, whole, mesh))))
    caches = shp.cache_specs(scfg, shape)
    pairs += zip(tree_leaves(caches),
                 tree_leaves(fused_sharded.rank_cache_specs(scfg, caches, mesh)))
    inputs = ({"t": shp.decode_token_spec(scfg, shape)} if shape.kind == "decode"
              else shp.prefill_input_specs(scfg, shape))
    return pairs + list(zip(tree_leaves(inputs), tree_leaves(shd.batch_specs(inputs, mesh))))


def rank_classes(cfg, shape, mesh_shape: Dict[str, int]) -> list:
    """The ranks of a mesh of ``mesh_shape`` grouped by the local shapes of
    every input of the cell's step (from the specs alone): ``[(coords of
    the class's first rank, ranks in the class)]``."""
    pairs = _arg_specs(cfg, shape, Mesh(mesh_shape))
    names = list(mesh_shape)
    classes: Dict = {}
    for rank in range(math.prod(mesh_shape.values())):
        coords, r = {}, rank
        for a in reversed(names):  # row-major: the last axis varies fastest
            coords[a], r = r % mesh_shape[a], r // mesh_shape[a]
        coords = {a: coords[a] for a in names}
        at = Mesh(mesh_shape, coords)
        sig = tuple(shd.local_shape(x.shape, s, at) for x, s in pairs)
        classes.setdefault(sig, [coords, 0])[1] += 1
    return [tuple(v) for v in classes.values()]


def run_train_cell(cfg, shape, mesh, probes: bool) -> Dict:
    res = {"full_step": run_step(cfg, shape, mesh), "trips": _trips(cfg, shape)}
    if probes:
        res["probes"] = _train_probes(cfg, shape, mesh)
    return res


def run_prefill_cell(cfg, shape, mesh, probes: bool) -> Dict:
    res = {"full_step": run_step(cfg, shape, mesh), "trips": _trips(cfg, shape)}
    if probes:
        res["probes"] = _prefill_probes(serving_cfg(cfg), shape, mesh)
    return res


def run_decode_cell(cfg, shape, mesh, probes: bool) -> Dict:
    res = {"full_step": run_step(cfg, shape, mesh), "trips": _trips(cfg, shape)}
    if probes:
        res["probes"] = _decode_probes(serving_cfg(cfg), shape, mesh)
    return res


RUNNERS = {"train": run_train_cell, "prefill": run_prefill_cell, "decode": run_decode_cell}


def _parse_overrides(pairs):
    out = {}
    for p in pairs or []:
        k, v = p.split("=", 1)
        if v in ("true", "True"):
            out[k] = True
        elif v in ("false", "False"):
            out[k] = False
        else:
            try:
                out[k] = int(v)
            except ValueError:
                try:
                    out[k] = float(v)
                except ValueError:
                    out[k] = v
    return out


def run_cell(arch: str, shape_name: str, mesh_kind: str, probes: bool = True,
             overrides: Optional[Dict] = None) -> Dict:
    """One cell's record: ``skip(...)`` where the shape does not apply
    (``shapes.applicability``), else one rank of each class of local shapes
    run (the first class's record at the top, the others under
    ``other_classes``), ``ok``, or ``error`` for a step that raised one of
    ``_CELL_ERRORS``."""
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.with_(**overrides)
    shape = shp.SHAPES[shape_name]
    skip = shp.applicability(cfg, shape)
    meta = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "params": cfg.num_params(), "active_params": cfg.num_active_params(),
    }
    if skip:
        return {**meta, "status": skip}
    mesh_shape = MESHES[mesh_kind]
    try:
        classes = rank_classes(cfg, shape, mesh_shape)
        runs = []
        for coords, _ in classes:
            mesh = virtual_mesh(mesh_shape, coords)
            runs.append(RUNNERS[shape.kind](cfg, shape, mesh, probes and not runs))
        res = runs[0]
        if len(runs) > 1:
            res["other_classes"] = [r["full_step"] for r in runs[1:]]
        res["ranks"] = {"checked": sum(n for _, n in classes),
                        "classes": [{"coords": c, "ranks": n} for c, n in classes]}
        res["virtual"] = mesh.describe()
        return {**meta, "status": "ok", **res}
    except _CELL_ERRORS as e:
        # A cell the port cannot run as specified: recorded so --all goes on.
        return {**meta, "status": "error", "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--no-probes", action="store_true")
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    help="config override key=value (repeatable; perf iterations)")
    ap.add_argument("--tag", default="", help="artifact filename suffix")
    args = ap.parse_args(argv)
    overrides = _parse_overrides(args.overrides)
    if not args.all and (args.arch is None or args.shape is None):
        ap.error("--arch and --shape, or --all")

    os.makedirs(args.out, exist_ok=True)
    cells = []
    if args.all:
        for a in assigned_names():
            for s in shp.SHAPES:
                for m in ("pod", "multipod"):
                    cells.append((a, s, m))
    else:
        cells.append((args.arch, args.shape, args.mesh))

    for arch, shape_name, mesh_kind in cells:
        tag = f"__{args.tag}" if args.tag else ""
        path = os.path.join(args.out, f"{arch}__{shape_name}__{mesh_kind}{tag}.json")
        if args.skip_existing and os.path.exists(path):
            print(f"[skip existing] {path}")
            continue
        t0 = time.perf_counter()
        # probes only on the single-pod mesh (the roofline table is single-pod)
        probes = (mesh_kind == "pod") and not args.no_probes
        res = run_cell(arch, shape_name, mesh_kind, probes=probes, overrides=overrides)
        res["wall_s"] = round(time.perf_counter() - t0, 1)
        with open(path, "w") as f:
            json.dump(res, f, indent=1)
        mem = res.get("full_step", {}).get("memory", {})
        print(f"[{res['status']:40s}] {arch:24s} {shape_name:12s} {mesh_kind:8s} "
              f"wall={res['wall_s']}s temp={mem.get('temp_bytes', 0) / 2**30:.1f}GiB "
              "(virtual rank on meta: shapes, no values)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
