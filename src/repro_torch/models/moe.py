"""Mixture-of-Experts FFN, from ``repro/models/moe.py``, with its dispatch
schedules (``cfg.moe_impl``):

  * ``dense``     — every expert on every token, masked combine (tests only);
  * ``einsum``    — GShard one-hot dispatch and combine products, slot-major
                    priority;
  * ``sorted``    — sort-based capacity dispatch: assignments sorted stably by
                    expert, ranked, gathered into an (E, C, d) buffer per
                    sequence, the combine inverting the sort;
  * ``shard_map`` — JAX's expert-parallel schedule (``_moe_shard_map``):
                    under an active mesh whose model axis divides E, each
                    model rank holds E / m experts, routes its tokens
                    against the whole router, computes its own experts'
                    assignments and adds its partial output to the others'
                    with one ``all_reduce``. Without a mesh, with a model
                    axis of 1 or an indivisible E it runs ``sorted``, as
                    JAX's does.

Under a model axis (the step builders' ``sharding.use_rules``) every
schedule runs on the rank's expert leaves as JAX's ``param_specs`` place
them (``fused_sharded.moe_layout``): the dispatch, capacity and combine run
on whole routing, and only :func:`_expert_ffn` is per rank, so no schedule
has a mesh branch of its own (``shard_map`` keeps its own region, in which
the expert GEMMs see no model axis).

Capacity C = round_up_4(S * k * capacity_factor / E), at least 4, tokens per
expert per sequence; overflow assignments are dropped, in JAX's order. The
expert GEMMs are one batched product over the experts, ``(E, N, d) @ (E, d,
f)``, so no expert weight is broadcast over the batch. Every shape is fixed
by the config and the input's shape, and nothing reads a value back to the
host, so the serving steps capture as CUDA graphs.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.distribution import fused_sharded
from repro_torch.distribution.sharding import (activation_rules, active_mesh, model_group,
                                               suppress_hints)
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.layers import dense_init

_EXPERT_LEAVES = ("e_gate", "e_up", "e_down")


def moe_init(gen, cfg, dtype, device) -> Dict:
    """``router`` (d, E); ``e_gate`` (swiglu only) and ``e_up`` (E, d, f);
    ``e_down`` (E, f, d), each ``normal * fan_in**-0.5`` drawn in fp32 on
    ``gen``'s device and cast as it is made."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": dense_init(gen, d, E, dtype, device)}
    if cfg.mlp_type == "swiglu":
        p["e_gate"] = _experts_init(gen, (E, d, f), dtype, device)
    p["e_up"] = _experts_init(gen, (E, d, f), dtype, device)
    p["e_down"] = _experts_init(gen, (E, f, d), dtype, device)
    return p


def _experts_init(gen, shape, dtype, device):
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return w.mul_(shape[1] ** -0.5).to(device=device, dtype=dtype)


def _route(params, cfg, x):
    """x: (B, S, d) -> (weights (B, S, k) fp32, ids (B, S, k) int64, probs).
    The router product runs in x's dtype and is then cast to fp32, as in JAX."""
    logits = (x @ params["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    w, ids = torch.topk(probs, cfg.top_k, dim=-1)
    if cfg.renorm_topk:
        w = w / torch.sum(w, dim=-1, keepdim=True)
    return w, ids, probs


def _ffn_rows(params, cfg, rows):
    """rows: (E, N, d) -> (E, N, d) through each expert's MLP: batched
    products over E; the nonlinearity is elementwise per ff column."""
    if cfg.mlp_type == "swiglu":
        h = F.silu(torch.bmm(rows, params["e_gate"])) * torch.bmm(rows, params["e_up"])
    elif cfg.mlp_type == "squared_relu":
        h = torch.square(torch.relu(torch.bmm(rows, params["e_up"])))
    else:
        h = F.gelu(torch.bmm(rows, params["e_up"]), approximate="tanh")
    return torch.bmm(h, params["e_down"])


def _expert_ffn(params, cfg, xs):
    """xs: (..., E, C, d) -> (..., E, C, d): the rows of every expert in one
    batched product over E. Under a model axis (``sharding.model_group()``)
    the leaves are the rank's, as ``fused_sharded.moe_layout`` places them:
    ``"experts"``, the rank's ``E / m`` experts run on their rows of the
    buffer and the outputs are gathered over the expert dim (rank order:
    JAX's block layout); ``"ff"``, every expert on the rank's ``f / m``
    columns of ``e_gate`` / ``e_up`` and rows of ``e_down``, the partial
    outputs summed over the axis (GSPMD's partition of JAX's
    ``("batch", "experts", None, "ff")`` hint). ``xs``, whole on every rank,
    enters through ``launch/mesh.py::enter``. A leaf whose shape is not the
    layout's raises."""
    *lead, E, C, d = xs.shape
    group = model_group()
    layout = None if group is None else fused_sharded.moe_layout(cfg, active_mesh())
    m = 1 if layout is None else group.size
    E_l = E // m if layout == "experts" else E
    f_l = cfg.d_ff // m if layout == "ff" else cfg.d_ff
    if params["e_up"].shape != (E_l, d, f_l) or params["e_down"].shape != (E_l, f_l, d):
        raise ValueError(
            f"{cfg.name}: expert leaves {tuple(params['e_up'].shape)} / "
            f"{tuple(params['e_down'].shape)} are not a rank's under the {layout or 'whole'} "
            f"layout on {m} model ranks (want {(E_l, d, f_l)}); shard them by "
            "fused_sharded.rank_specs")
    if layout is not None:
        xs = mesh_lib.enter(xs, group)
    if layout == "experts":
        xs = xs.narrow(-3, group.index * E_l, E_l)
    rows = xs.movedim(-3, 0).reshape(E_l, -1, d)
    ys = _ffn_rows(params, cfg, rows).reshape(E_l, *lead, C, d).movedim(0, -3)
    if layout == "experts":
        return mesh_lib.gather(ys, group, dim=-3)
    return mesh_lib.combine(ys, group) if layout == "ff" else ys


def moe_apply(params, cfg, x: torch.Tensor) -> torch.Tensor:
    impl = cfg.moe_impl
    if impl == "dense":
        return _moe_dense(params, cfg, x)
    if impl == "einsum":
        return _moe_einsum(params, cfg, x)
    if impl == "sorted":
        return _moe_sorted(params, cfg, x)
    if impl == "shard_map":
        return _moe_shard_map(params, cfg, x)
    raise ValueError(f"unknown moe_impl {impl!r}")


def _moe_dense(params, cfg, x):
    """All experts on all tokens; combine with the top-k weights."""
    w, ids, _ = _route(params, cfg, x)
    E = cfg.n_experts
    comb = torch.sum(F.one_hot(ids, E).float() * w[..., None], dim=-2)  # (B, S, E)
    B, S, d = x.shape
    ys = _expert_ffn(params, cfg, x[:, None].expand(B, E, S, d))       # (B, E, S, d)
    y = torch.einsum("besd,bse->bsd", ys.float(), comb)
    return y.to(x.dtype)


def _capacity(cfg, S: int) -> int:
    c = int(S * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(4, -(-c // 4) * 4)  # round up to 4


def _moe_einsum(params, cfg, x):
    """GShard dispatch: one-hot products only (small-E models)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = _capacity(cfg, S)
    w, ids, _ = _route(params, cfg, x)

    onehot = F.one_hot(ids, E).float()                        # (B, S, k, E)
    # slot-major priority: slot 0 assignments claim capacity first
    oh = onehot.movedim(2, 1).reshape(B, k * S, E)
    pos = torch.cumsum(oh, dim=1) * oh - 1.0                  # (B, kS, E)
    keep = (pos >= 0) & (pos < C)
    # one_hot of a position outside [0, C) is all zeros, as jax.nn.one_hot's
    pos_oh = (pos.long()[..., None] == torch.arange(C, device=x.device)).float()
    disp_flat = torch.where(keep[..., None], oh[..., None] * pos_oh, 0.0)
    disp = disp_flat.reshape(B, k, S, E, C)
    w_km = w.movedim(2, 1)                                    # (B, k, S)
    dispatch = torch.sum(disp, dim=1)                         # (B, S, E, C)
    combine = torch.sum(disp * w_km[..., None, None], dim=1)  # (B, S, E, C)

    xs = torch.einsum("bsec,bsd->becd", dispatch, x.float()).to(x.dtype)
    ys = _expert_ffn(params, cfg, xs)
    y = torch.einsum("bsec,becd->bsd", combine, ys.float())
    return y.to(x.dtype)


def _moe_sorted(params, cfg, x):
    """Sort-based capacity dispatch (exact active FLOPs but for the dropped
    and empty slots)."""
    w, ids, _ = _route(params, cfg, x)
    return _dispatch_compute(params, cfg, x, w, ids)


def _dispatch_compute(params, cfg, x, w, ids):
    """Sort, capacity dispatch, expert GEMMs and combine, given the routing.
    ``ids`` may hold the sentinel ``E``: those assignments sort last and are
    dropped (the expert-parallel schedule's non-local assignments). JAX's
    scatters with ``mode="drop"`` write into a buffer one slot wider here,
    whose last slot (the sentinel slot ``E*C``, where every dropped
    assignment goes) is sliced off."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = _capacity(cfg, S)
    dev = x.device

    A = S * k  # assignments per sequence, token-major
    eid = ids.reshape(B, A)
    wgt = w.reshape(B, A)
    tok = torch.arange(S, device=dev)[:, None].expand(S, k).reshape(1, A).expand(B, A)

    order = torch.argsort(eid, dim=-1, stable=True)          # sort by expert
    eid_s = torch.gather(eid, 1, order)
    # rank within expert: index minus the position of the group start (cummax)
    idx = torch.arange(A, device=dev)[None, :].expand(B, A)
    change = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=dev),
                        eid_s[:, 1:] != eid_s[:, :-1]], dim=1)
    group_start = torch.cummax(torch.where(change, idx, 0), dim=1).values
    rank = idx - group_start
    slot_s = torch.where((rank < C) & (eid_s < E), eid_s * C + rank, E * C)  # E*C: dropped

    tok_s = torch.gather(tok, 1, order)
    token_for_slot = torch.zeros((B, E * C + 1), dtype=torch.long, device=dev).scatter_(
        1, slot_s, tok_s)[:, :E * C]
    slot_filled = torch.zeros((B, E * C + 1), dtype=torch.bool, device=dev).scatter_(
        1, slot_s, True)
    slot_filled[:, E * C] = False  # the sentinel holds no token

    # gather the tokens into the expert buffer (batch-row local)
    xs = torch.gather(x, 1, token_for_slot[..., None].expand(B, E * C, d))
    xs = torch.where(slot_filled[:, :E * C, None], xs, 0)
    ys = _expert_ffn(params, cfg, xs.reshape(B, E, C, d)).to(x.dtype).reshape(B, E * C, d)

    # combine: invert the sort to find each assignment's slot
    slot_for_a = torch.zeros((B, A), dtype=torch.long, device=dev).scatter_(1, order, slot_s)
    a_valid = torch.gather(slot_filled, 1, slot_for_a)
    y_a = torch.gather(ys, 1, slot_for_a.clamp(max=E * C - 1)[..., None].expand(B, A, d))
    y_a = torch.where(a_valid[..., None], y_a, 0)
    # combine in fp32 (JAX: preferred_element_type=float32)
    y = torch.einsum("bskd,bsk->bsd", y_a.reshape(B, S, k, d).float(), wgt.reshape(B, S, k))
    return y.to(x.dtype)


def _moe_shard_map(params, cfg, x):
    """JAX's expert-parallel schedule: the tokens are whole on every model
    rank, so each routes them against the full router, keeps its own
    experts' assignments (the rest take the sentinel ``E_loc``, sort last
    and use no local capacity), runs ``sorted`` over its ``E_loc`` experts
    at the global per-expert capacity (local capacity factor ``cf / (E /
    E_loc)``) and contributes a partial (B, S, d); one ``all_reduce`` of
    that token-shaped output is the only collective. ``params``' experts
    are this rank's (``fused_sharded.rank_specs``).

    Differentiable as a per-rank region: ``x`` and the router, read whole
    by every model rank, pass :func:`launch.mesh.enter` (their gradients are
    summed over the axis), and the output's ``all_reduce`` is
    :func:`launch.mesh.combine` (the cotangent passes back unchanged), so
    each rank's expert leaves get their own experts' gradients and the rest
    the single-device ones on every rank."""
    rules = activation_rules()
    E = cfg.n_experts
    if rules is None:
        return _moe_sorted(params, cfg, x)
    mesh = rules["mesh"]
    m = int(mesh.shape.get("model", 1))
    if m <= 1 or E % m != 0:
        return _moe_sorted(params, cfg, x)
    group = mesh.axis("model")
    E_loc = params["e_up"].shape[0]
    lo = group.index * E_loc
    cfg_loc = cfg.with_(n_experts=E_loc, moe_impl="sorted",
                        capacity_factor=cfg.capacity_factor / (E // E_loc))
    x = mesh_lib.enter(x, group)
    params = {k: v if k in _EXPERT_LEAVES else mesh_lib.enter(v, group)
              for k, v in params.items()}
    with suppress_hints():  # a per-rank region, as JAX's manual shard_map region
        w, ids, _ = _route(params, cfg, x)
        mine = (ids >= lo) & (ids < lo + E_loc)
        w = torch.where(mine, w, 0.0)
        ids = torch.where(mine, ids - lo, E_loc)
        y_part = _dispatch_compute(params, cfg_loc, x, w, ids)
    return mesh_lib.combine(y_part, group)
