"""The fused MTS path over a mesh of ranks (``repro/distribution/
fused_sharded.py``): multi-GPU serving of the whole-layer fused RNN kernel.

Each rank of the ``"model"`` axis runs the same kernel (B1,
``kernels/fused_rnn``) over its ``H / k`` slice of the gate slabs, carry and
highway width, as JAX's ``shard_map`` bodies do. The recurrence
``c_t = f_t * c_{t-1} + (1 - f_t) * x_hat_t`` is elementwise in H, so a
shard's carry lanes never read another shard's; the gate GEMM contracts over
the input width d, which every rank holds whole. Two couplings cross the
width and are handled between kernels: the residual width (each layer's
output slice is gathered to full width, :meth:`AxisGroup.all_gather`) and,
in the ring schedule, the pre-norm's mean of squares (a scalar
``all_reduce``). The carry stays sharded: only the next call's kernel reads
it.

The depth-fused stack cannot stay one kernel per token under width
partitioning (layer l + 1 contracts over lanes other ranks hold), so the
sharded stack is L per-layer evaluations, in one of two schedules:

  * ``barrier``: per layer, the norm of the replicated fp32 residual stream,
    the rank's B1 on its slab slice, then a blocking gather of its output;
    the stream stays replicated and equal to the single-device stream's.
    B1 runs in fp32 IO at every compute dtype, as JAX's body does: the
    normed stream goes in unrounded, the slabs as held (bf16 ones widened in
    the kernel), and its fp32 output is added to the stream.
  * ``ring``: the residual stream stays chunk-resident (each rank keeps its
    Hl lanes in fp32), the norm's mean of squares is a scalar
    ``all_reduce``, and the gate GEMM is ``core/overlap.py``'s ring
    all-gather matmul, which gathers the previous layer's output chunk by
    chunk inside the GEMM; each chunk meets its rows of each tap in place,
    widened to fp32 a chunk at a time. The recurrence (JAX's ``lax.scan``,
    in XLA there) runs on the linear-scan kernel (B3,
    ``ops.linear_scan_recurrence``), one launch a layer, so this schedule
    launches no B1. One gather remains, at the stack exit.

Params and caches are this rank's shards at rest (:func:`rank_specs`,
:func:`rank_cache_specs`, JAX's specs for every leaf the port computes per
rank): each gate slab, bias and ``w_skip`` holds its lanes ``[j H/k, (j+1)
H/k)`` of every gate, the (L, B, H) carries their lanes, so no weight
crosses ranks in a step. The compact int8 scales ``wq_scale`` (3 x
ceil(H/128) fp32 a layer) are the one leaf held otherwise than JAX's specs:
whole, since a shard's lanes may start inside a scale block (H = 1000 over 8
ranks), and the kernel takes the shard's blocks with its offset into the
first (``scale_lane0``). The other engines' cells, the LSTM and the vocab
leaves are sharded as JAX shards them too, and run per rank in
``distribution/tensor_parallel.py``; the attention, dense MLP and Mamba
leaves and their caches in ``models/attention.py``, ``lm._mlp`` and
``models/mamba.py``; the MoE experts in ``models/moe.py``, by
:func:`moe_layout`.

Dispatch: ``models/rnn.py`` decides once a call, by :func:`sharding_mesh`
(the mesh installed by ``sharding.use_rules``, which the step builders
enter, when the config's cells shard there: :func:`can_shard_fused` for the
fused engines, ``tensor_parallel.lane_sharded`` for the others), and routes
here or there: the stack itself, the layer through ``core/mts.py``'s
``mesh`` argument. With no mesh, a model axis of 1 or an indivisible width
they run the unsharded kernels on whole params.

Differentiable, as JAX's cores are ``custom_vjp``s whose backward is the
global reference's VJP, which GSPMD partitions. Without GSPMD each rank
computes its shard's part of that VJP, and the model axis sums the partial
products: the same math in another summation order. The layer is
:func:`launch.mesh.enter` on its whole inputs, B1 through
``fused_ops.fused_layer`` (backward: the shard's plain layer recomputed, its
recurrence on B3) and :func:`launch.mesh.gather` of the output. The stack is
one Function (``_ShardedStackCore``) whose forward is either schedule and
whose backward, shared by both, recomputes the rank's shard of the plain
stack: the barrier schedule on the plain layer, with ``enter`` / ``gather``
at each layer's edges (:func:`_stack_barrier`). Int8 slabs are
straight-through, as JAX's ``_layer_bwd_rule_q`` / ``_stack_bwd_rule_q``:
the slab gets no cotangent, the whole ``wq_scale`` gets the reference's
(summed over the model axis). The gradients of replicated inputs come out
equal on every model rank; each slab, bias and ``w_skip`` shard gets its
own lanes'.
"""
from __future__ import annotations

import functools
import re
from typing import Optional

import torch

from repro_torch.core import overlap
from repro_torch.distribution import sharding as shd
from repro_torch.distribution import tensor_parallel as tp
from repro_torch.distribution.sharding import MODEL_AXIS, active_mesh, model_shards
from repro_torch.kernels.common import recompute_grads
from repro_torch.kernels.fused_rnn import layout
from repro_torch.kernels.fused_rnn import ops as fused_ops
from repro_torch.kernels.fused_rnn.fused_rnn import fused_rnn_layer_plain
from repro_torch.launch import mesh as mesh_lib

_EPS = 1e-6  # matches models/layers.py rmsnorm and the stacked kernel


# ---------------------------------------------------------------------------
# Dispatch predicates
# ---------------------------------------------------------------------------

def can_shard_fused(hidden: int, mesh) -> bool:
    """True when the fused path runs per rank on ``mesh``: a model axis
    above 1 that divides the hidden width (else the unsharded kernel runs
    whole on every rank: the divisibility fallback of ``sharding._resolve``)."""
    k = model_shards(mesh)
    return k > 1 and hidden % k == 0


def _batch_spec(mesh, batch: int):
    """The batch dim's spec entry: the DP axes when they divide it, else
    replicated (``sharding._resolve``)."""
    return shd._resolve(mesh, {"batch": ("pod", "data")}, ["batch"], [batch])[0]


# ---------------------------------------------------------------------------
# At-rest layout for serving
# ---------------------------------------------------------------------------

def serving_param_specs(params, mesh, *, fsdp: bool = False):
    """Param specs for fused serving: JAX's standard rules, whose lane-major
    gate slabs shard ``(None, None, "model")``, which is the kernel's own
    per-gate lane sharding."""
    return shd.param_specs(params, mesh, fsdp=fsdp)


# The one leaf held otherwise than JAX's specs give it: the compact int8
# scales (whole; ``scale_lane0``).
_SCALE_LEAF = re.compile(r"(^|.*/)wq_scale$")


def _without_model(spec) -> tuple:
    def one(e):
        if e is None or e == MODEL_AXIS:
            return None
        if isinstance(e, tuple):
            rest = tuple(a for a in e if a != MODEL_AXIS)
            return rest if len(rest) > 1 else (rest[0] if rest else None)
        return e

    return tuple(one(e) for e in spec)


def _fused_sharded(cfg, mesh) -> bool:
    return (cfg.cell in ("sru", "qrnn") and cfg.scan_engine in ("fused", "fused_stack")
            and can_shard_fused(cfg.rnn_hidden, mesh))


def sharding_mesh(cfg):
    """The mesh ``cfg``'s RNN layers run per rank on: the active mesh when
    its cells shard there (the fused engines: :func:`can_shard_fused` of the
    whole hidden width; the others and the LSTM:
    ``tensor_parallel.lane_sharded``), else None (whole params)."""
    mesh = active_mesh()
    return mesh if _fused_sharded(cfg, mesh) or tp.lane_sharded(cfg, mesh) else None


def moe_layout(cfg, mesh) -> Optional[str]:
    """How ``cfg``'s expert leaves lie over ``mesh``'s model axis, read off
    JAX's spec of ``e_up`` (``sharding.param_specs``: ``experts_opt``, then
    ``ff_moe``): ``"experts"`` (each rank holds ``E / m`` whole experts:
    the count divides the axis), ``"ff"`` (each rank holds ``f / m`` of
    every expert's ff columns, and of ``e_down``'s rows), or None (whole:
    no MoE, a model axis of one rank, or neither dim divides). The same in
    every schedule; ``models/moe.py`` computes by it."""
    if not cfg.moe or model_shards(mesh) <= 1:
        return None
    spec = shd.spec_for_path("moe/e_up", (cfg.n_experts, cfg.d_model, cfg.d_ff), mesh,
                             shd._param_logical(False), stacked=False)
    if MODEL_AXIS in shd.spec_axes(spec[:1]):
        return "experts"
    return "ff" if MODEL_AXIS in shd.spec_axes(spec[2:]) else None


def rank_specs(cfg, specs, mesh):
    """The specs the port holds params at rest by: ``specs``
    (:func:`serving_param_specs`, JAX's ``param_specs``) with the model axis
    kept on every leaf, since the port computes every leaf per rank as JAX
    places it: the RNN cell leaves of every engine and the LSTM's, ``embed``
    / ``unembed`` over the padded vocab, the attention projections
    (``w_q``, ``w_kv``, ``w_o``), the dense MLP's and the Mamba mixer's
    ``ff`` leaves (``models/attention.py``, ``mamba.py``) and the MoE
    experts in every schedule (over the experts where their count divides
    the axis, else the ``ff_moe`` columns and rows: :func:`moe_layout`).
    Each already falls back to whole where its dim does not divide, as the
    per-rank code does. One leaf is held whole where JAX shards it:
    ``wq_scale``. A model axis of one rank is dropped everywhere: it
    shards nothing."""
    split = model_shards(mesh) > 1

    def one(path, spec):
        return _without_model(spec) if not split or _SCALE_LEAF.match(path) else spec

    return shd.map_with_paths(one, specs)


def rank_cache_specs(cfg, caches, mesh):
    """The decode caches' specs at rest: JAX's ``sharding.cache_specs``
    (the RNN carries ``c`` / ``h`` over their lanes, the KV caches over
    their heads, or their sequence where the heads do not divide, the SSM
    state over its heads and the ``conv_x`` tail over its channels), with a
    model axis of one rank dropped."""
    specs = shd.cache_specs(caches, mesh)
    return specs if model_shards(mesh) > 1 else shd.map_with_paths(
        lambda path, spec: _without_model(spec), specs)


# ---------------------------------------------------------------------------
# One layer per rank (engine="fused")
# ---------------------------------------------------------------------------

def _scale_shard(scale: torch.Tensor, lane0: int, Hl: int):
    """The shard's blocks of the whole compact scales ``(..., 3, nb)`` and
    the offset of its lane 0 in the first of them."""
    b0 = lane0 // layout.SCALE_BLOCK
    b1 = layout.n_scale_blocks(lane0 + Hl)
    return scale[..., b0:b1].contiguous(), lane0 - b0 * layout.SCALE_BLOCK


def _layer(u, taps, b3, c0, *, mode, mesh, block_t, tail=None, wskip=None, scale=None):
    """This rank's B1 on its lanes (``fused_ops.fused_layer``, whose
    backward recomputes the shard's plain layer), between :func:`enter` on
    what every model rank reads whole and :func:`gather` of the output to
    full width. Returns ``(h (T, B, H), c_last (B, Hl))``."""
    group = mesh.axis(MODEL_AXIS)
    Hl = taps[0].shape[-1]
    lane0 = group.index * Hl
    u, tail, scale = (mesh_lib.enter(t, group) for t in (u, tail, scale))
    # The highway skip is the rank's own lane slice of the whole input.
    skip = u[..., lane0:lane0 + Hl].contiguous() if mode == "sru_identity" else None
    scale_l, off = (None, 0) if scale is None else _scale_shard(scale, lane0, Hl)
    h_l, c_l = fused_ops.fused_layer(
        u, taps, b3, c0, mode=mode, tail=tail, wskip=wskip, block_t=block_t,
        scale=scale_l, skip=skip, scale_lane0=off)
    return mesh_lib.gather(h_l, group), c_l


def sharded_fused_sru(params, x: torch.Tensor, c0: torch.Tensor, *, mesh, block_t: int = 128):
    """Whole SRU layer, fused and model-sharded: ``params`` this rank's
    shards (fp ``w``, or int8 ``wq`` with the whole ``wq_scale``), ``x``
    (T, B, d) whole, ``c0`` (B, Hl). Returns ``(h (T, B, H), c_last (B, Hl))``.
    Differentiable (int8 slabs: straight-through)."""
    if layout.is_quantized(params):
        taps, scale, b3, mode, wskip = layout.sru_slabs_q(params)
    else:
        (taps, b3, mode, wskip), scale = layout.sru_slabs(params), None
    return _layer(x, taps, b3, c0, mode=mode, mesh=mesh, block_t=block_t, wskip=wskip,
                  scale=scale)


def sharded_fused_qrnn(params, x: torch.Tensor, x_prev_tail: Optional[torch.Tensor],
                       c0: torch.Tensor, *, mesh, block_t: int = 128):
    """Whole QRNN layer, fused and model-sharded (the shifted-input GEMM:
    the kernel builds the shifted rows from ``x`` and ``x_prev_tail``
    (1, B, d), zeros when None). See :func:`sharded_fused_sru`."""
    if layout.is_quantized(params):
        taps, scale, b3 = layout.qrnn_slabs_q(params)
    else:
        (taps, b3), scale = layout.qrnn_slabs(params), None
    return _layer(x, taps, b3, c0, mode="qrnn", mesh=mesh, block_t=block_t, tail=x_prev_tail,
                  scale=scale)


# ---------------------------------------------------------------------------
# The depth-fused stack per rank (engine="fused_stack")
# ---------------------------------------------------------------------------

def _stack_ring(x, taps, b3L, lnL, c0L, tailsL, sL, *, qrnn, group):
    """The chunk-resident stream: scalar all_reduce norms, ring gate GEMMs,
    B3's recurrence; one gather at the exit."""
    L, Hl, d = taps[0].shape[0], taps[0].shape[-1], x.shape[-1]
    lane0 = group.index * Hl
    own = slice(lane0, lane0 + Hl)
    s_loc = None if sL is None else layout.expand_scales(sL, lane0 + Hl)[..., own].float()
    x_loc = x[..., own].float()                               # (T, B, Hl)
    c_lasts, new_tails = [], []
    for l in range(L):
        ms = group.all_reduce(torch.sum(x_loc * x_loc, dim=-1, keepdim=True)) / d
        u_loc = x_loc * torch.rsqrt(ms + _EPS) * lnL[l][own].float()
        if qrnn:
            u_prev = torch.cat([tailsL[l][..., own].float()[None], u_loc[:-1]], dim=0)
            new_tails.append(u_loc[-1])
            ring_in = torch.cat([u_loc, u_prev], dim=-1)      # (T, B, 2Hl)
        else:
            ring_in = u_loc
        taps_l = tuple(t[l] for t in taps)                    # each (d, 3, Hl)

        def chunk_product(buf, j, taps_l=taps_l):
            # Ring chunk j carries [u_j ; u_prev_j]: rows j of each tap (d = H).
            rows = slice(j * Hl, (j + 1) * Hl)
            z = 0.0
            for i, t in enumerate(taps_l):
                z = z + buf[..., i * Hl:(i + 1) * Hl] @ t[rows].reshape(Hl, 3 * Hl).float()
            return z

        z = overlap.ring_ag_contract(ring_in, chunk_product, group)
        z = z.reshape(z.shape[:-1] + (3, Hl))
        if s_loc is not None:  # the kernel's order: scale the sum, then the bias
            z = z * s_loc[l]
        z = z + b3L[l].float()
        x_hat = torch.tanh(z[..., 0, :]) if qrnn else z[..., 0, :]
        h_loc, c_last = fused_ops.linear_scan_recurrence(
            x_hat, torch.sigmoid(z[..., 1, :]), torch.sigmoid(z[..., 2, :]),
            None if qrnn else u_loc, c0L[l])
        c_lasts.append(c_last)
        x_loc = x_loc + h_loc
    y = group.all_gather(x_loc.to(x.dtype))
    tails = group.all_gather(torch.stack(new_tails).to(x.dtype)) if qrnn else None
    return y, torch.stack(c_lasts).to(x.dtype), tails


def _stack_barrier(x, b3L, lnL, c0L, tailsL, sL, *taps, group, layer):
    """L x (norm of the replicated fp32 stream, ``layer`` on the rank's
    lanes in fp32 IO, gather of its fp32 output into the stream). Forward,
    ``layer`` is B1 (``fused_ops.run_layer``); in the backward it is the
    plain layer, its recurrence on B3, and this is the rank's shard of the
    stack's plain version, differentiable: :func:`enter` on what the rank
    reads whole (each layer's normed input, the conv tails, the scales),
    :func:`gather` of each layer's output, so the model ranks' gradients of
    the replicated inputs come out equal and each slab shard gets its own."""
    qrnn = len(taps) == 2
    L, Hl, d = taps[0].shape[0], taps[0].shape[-1], x.shape[-1]
    lane0 = group.index * Hl
    tailsL, sL = mesh_lib.enter(tailsL, group), mesh_lib.enter(sL, group)
    xf = x.float()
    c_lasts, new_tails = [], []
    for l in range(L):
        # Pre-norm over the full width: local, the stream is replicated.
        ms = torch.sum(xf * xf, dim=-1, keepdim=True) / d
        u = xf * torch.rsqrt(ms + _EPS) * lnL[l].float()
        if qrnn:
            new_tails.append(u[-1])
        u_r = mesh_lib.enter(u, group)
        scale, off = (None, 0) if sL is None else _scale_shard(sL[l], lane0, Hl)
        if qrnn:
            kw = {"mode": "qrnn", "tail": tailsL[l][None].float()}
        else:
            kw = {"mode": "sru_identity", "skip": u_r[..., lane0:lane0 + Hl].contiguous()}
        h_l, c_l = layer(u_r, tuple(t[l] for t in taps), b3L[l].float(), c0L[l].float(),
                         scale=scale, scale_lane0=off, **kw)
        xf = xf + mesh_lib.gather(h_l, group)
        c_lasts.append(c_l)
    tails = torch.stack(new_tails).to(x.dtype) if qrnn else None
    return xf.to(x.dtype), torch.stack(c_lasts).to(x.dtype), tails


class _ShardedStackCore(torch.autograd.Function):
    """The sharded stack: ``apply(schedule, group, block_t, x, b3L, lnL, c0L,
    tailsL, sL, *taps) -> (y, c_last[, tails_last])``. Forward: the
    schedule's kernels (B1 a layer in the barrier, the ring's GEMMs and B3).
    Backward, shared by both schedules as JAX's ``defvjp`` to the one
    global reference: the barrier on the plain layer evaluated again on the
    saved inputs and differentiated. Int8 slabs are straight-through."""

    @staticmethod
    def forward(ctx, schedule, group, block_t, x, b3L, lnL, c0L, tailsL, sL, *taps):
        ctx.group = group
        ctx.save_for_backward(x, b3L, lnL, c0L, tailsL, sL, *taps)
        qrnn = len(taps) == 2
        if schedule == "ring":
            y, c_last, tails = _stack_ring(x, taps, b3L, lnL, c0L, tailsL, sL, qrnn=qrnn,
                                           group=group)
        else:
            y, c_last, tails = _stack_barrier(x, b3L, lnL, c0L, tailsL, sL, *taps, group=group,
                                              layer=functools.partial(fused_ops.run_layer,
                                                                      block_t=block_t))
        return (y, c_last) if tails is None else (y, c_last, tails)

    @staticmethod
    def backward(ctx, *grad_outs):
        plain_layer = functools.partial(fused_rnn_layer_plain,
                                        scan=fused_ops.linear_scan_recurrence)

        def plain(*inputs):
            return _stack_barrier(*inputs, group=ctx.group, layer=plain_layer)

        grads = recompute_grads(plain, ctx.saved_tensors, ctx.needs_input_grad[3:], grad_outs)
        return (None, None, None, *grads)


def _stack(x, taps, b3L, lnL, c0L, tailsL, sL, *, mesh, block_t, schedule):
    if schedule not in ("barrier", "ring"):
        raise ValueError(f"unknown schedule {schedule!r}")
    if x.shape[-1] != taps[0].shape[-1] * model_shards(mesh):
        raise ValueError("the stack's residual needs d_model == hidden")
    out = _ShardedStackCore.apply(schedule, mesh.axis(MODEL_AXIS), block_t, x, b3L, lnL, c0L,
                                  tailsL, sL, *taps)
    return out if len(out) == 3 else (*out, None)


def sharded_fused_sru_stack(params, ln_g: torch.Tensor, x: torch.Tensor, c0: torch.Tensor, *,
                            mesh, block_t: int = 128, schedule: str = "barrier"):
    """Model-sharded depth-fused SRU stack: ``params`` this rank's stacked
    shards (``w`` (L, d, 3, Hl) or int8 ``wq`` with the whole ``wq_scale``),
    ``ln_g`` (L, d), ``x`` (T, B, d), ``c0`` (L, B, Hl). Returns
    ``(y (T, B, d), c_last (L, B, Hl))``. ``schedule``: ``barrier`` or
    ``ring`` (module docstring)."""
    if params.get("w_skip") is not None:
        raise ValueError("stack residual requires d_model == hidden")
    if layout.is_quantized(params):
        taps, sL, b3L, _, _ = layout.sru_slabs_q(params)
    else:
        (taps, b3L, _, _), sL = layout.sru_slabs(params), None
    y, c_last, _ = _stack(x, taps, b3L, ln_g, c0, None, sL, mesh=mesh, block_t=block_t,
                          schedule=schedule)
    return y, c_last


def sharded_fused_qrnn_stack(params, ln_g: torch.Tensor, x: torch.Tensor, tails: torch.Tensor,
                             c0: torch.Tensor, *, mesh, block_t: int = 128,
                             schedule: str = "barrier"):
    """Model-sharded depth-fused QRNN stack; ``tails`` (L, B, d) the
    per-layer conv carries (normed inputs), whole. Returns ``(y, c_last,
    tails_last)``. See :func:`sharded_fused_sru_stack`."""
    if layout.is_quantized(params):
        taps, sL, b3L = layout.qrnn_slabs_q(params)
    else:
        (taps, b3L), sL = layout.qrnn_slabs(params), None
    return _stack(x, taps, b3L, ln_g, c0, tails, sL, mesh=mesh, block_t=block_t,
                  schedule=schedule)
