"""Tensor parallelism of the leaves JAX shards through GSPMD, written out
per rank: the paper RNNs' own engines and the vocab leaves.

JAX places these leaves by ``param_specs`` (``repro/distribution/
sharding.py``) and lets GSPMD partition every computation that reads them;
it has no module of its own for this. The port holds the same shards at rest
(``fused_sharded.rank_specs`` / ``rank_cache_specs``) and runs the
partitioned program explicitly, one model rank a shard, through
``launch/mesh.py``'s autograd collectives, so the train step's backward
comes with the forward:

  * **SRU/QRNN under the non-fused engines** (``sequential``, ``chunked``,
    ``associative``, ``pallas``; :func:`lane_sharded`): each rank holds lanes
    ``[j H/k, (j+1) H/k)`` of every gate of the lane-major slabs
    ``(d, 3, H)``, the biases, ``w_skip`` and the carry. The layer is
    :func:`launch.mesh.enter` on the replicated normed input (and QRNN's
    replicated conv tail), the gate GEMM on the rank's ``(d, 3, Hl)`` slab,
    the recurrence on the engine asked for over the rank's lanes (under
    ``pallas`` the linear-scan kernel, B3), the highway with the rank's skip
    lanes (``x[..., lane0:lane0 + Hl]`` when d == H, the ``w_skip`` shard's
    product otherwise), and :func:`launch.mesh.gather` of the output to full
    width for the residual: the pattern of ``fused_sharded._stack_barrier``.
  * **LSTM** (:func:`lstm_layer`): JAX's flat gate-major ``wx (d, 4H)``,
    ``uh (H, 4H)`` and ``b (4H,)`` shard their 4H columns, which do not
    align with the gates (on two ranks rank 0 holds f and i). The recurrent
    product contracts over all of H every step, so the schedule is: each
    rank computes its columns of ``z_t = x_t W + b + h_{t-1} U``, one
    ``all_gather`` of ``z_t (B, 4H/k)`` a step, and the gate update on the
    whole ``z_t``, the same on every rank; ``c`` and ``h`` are computed whole
    and a rank keeps its lanes of the carries at rest when H divides.
  * **Vocab leaves** (:func:`vocab_sharded`): ``embed (V, d)`` and
    ``unembed (d, V)`` hold the rank's block of the padded vocab. The lookup
    masks the ids outside the rank's rows, takes its rows, zeroes the
    others and sums over the axis (:func:`launch.mesh.combine`: one row is
    nonzero, so the sum is the row bit for bit); the logits are the rank's
    columns (tied: ``h @ embed.T``) gathered along the vocab, so every rank
    takes the same greedy token from the same logits. The loss never
    gathers them (:func:`ce_terms`): as XLA partitions it over the vocab
    shards, each rank reduces its own columns and the axis sums the terms.

Without a model axis, or where the width does not divide it (JAX's
divisibility fallback, ``sharding._resolve``), the leaves are whole: the
layers here run with ``mesh`` None (they are ``core/mts.py``'s non-fused
layers on one device too) and the vocab functions with ``group`` None.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import cells
from repro_torch.core.scan import linear_scan
from repro_torch.distribution.sharding import MODEL_AXIS, active_mesh, model_shards
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.layers import embed_apply, logits_apply

_FUSED = ("fused", "fused_stack")


# ---------------------------------------------------------------------------
# Predicates
# ---------------------------------------------------------------------------

def lane_sharded(cfg, mesh) -> bool:
    """True when ``cfg``'s RNN cells run per rank here on ``mesh``: SRU/QRNN
    under a non-fused engine with ``rnn_hidden`` divisible by the model
    axis, or an LSTM whose 4H columns divide by it (the fused engines are
    ``fused_sharded``'s)."""
    k = model_shards(mesh)
    if k == 1 or cfg.cell is None:
        return False
    if cfg.cell == "lstm":
        return 4 * cfg.rnn_hidden % k == 0
    return cfg.scan_engine not in _FUSED and cfg.rnn_hidden % k == 0


def vocab_sharded(cfg, mesh) -> bool:
    """True when ``embed`` / ``unembed`` hold a block of the padded vocab a
    model rank on ``mesh`` (the model axis divides it)."""
    k = model_shards(mesh)
    return k > 1 and cfg.padded_vocab % k == 0


def vocab_group(cfg, mesh=None):
    """The model axis the vocab leaves are sharded over on ``mesh`` (default
    the active mesh), or None (whole leaves)."""
    mesh = active_mesh() if mesh is None else mesh
    return mesh.axis(MODEL_AXIS) if vocab_sharded(cfg, mesh) else None


# ---------------------------------------------------------------------------
# Vocab leaves
# ---------------------------------------------------------------------------

def embed(params, ids: torch.Tensor, group, seq=None) -> torch.Tensor:
    """The embedding rows of ``ids``: ``params["embed"]`` whole (``group``
    None) or this rank's block of rows, looked up vocab-parallel. ``seq``:
    the sequence-parallel axis; the rows are then the rank's sequence slice
    (vocab-parallel: the ranks' partial rows reduce-scattered)."""
    if group is None:
        return mesh_lib.seq_slice(embed_apply(params, ids), seq)
    table = params["embed"]
    rows = table.shape[0]
    local = ids - group.index * rows
    inside = (local >= 0) & (local < rows)
    picked = table[torch.where(inside, local, torch.zeros_like(local))]
    picked = torch.where(inside[..., None], picked, torch.zeros_like(picked))
    if seq is not None:
        return mesh_lib.seq_scatter(picked, seq)
    return mesh_lib.combine(picked, group)


def logits(params, h: torch.Tensor, group) -> torch.Tensor:
    """The head's logits (..., V) of ``h``: the whole product, or this rank's
    vocab columns (tied: its rows of ``embed``) gathered along the vocab."""
    if group is None:
        return logits_apply(params, h)
    return mesh_lib.gather(logits_apply(params, mesh_lib.enter(h, group)), group)


def ce_terms(params, h: torch.Tensor, targets: torch.Tensor, group,
             vocab: int) -> tuple:
    """``(logz, ll)`` per token in fp32: the log-sum-exp of the head's logits
    of ``h`` and the logit of ``targets``, the padded vocab's columns (from
    ``vocab`` on) excluded. With ``group``, each rank takes only its block
    of columns, and the (tokens, V) logits never exist: the maximum over the
    axis (a shift, so no gradient flows through it), then the sum of the
    shifted exponentials and the target's logit (its owner's, 0 on the other
    ranks) each summed over the axis (:func:`launch.mesh.combine`)."""
    if group is None:
        z = _valid(logits_apply(params, h).float(), 0, vocab)
        return torch.logsumexp(z, dim=-1), torch.gather(z, -1, targets.long()[..., None])[..., 0]
    z = logits_apply(params, mesh_lib.enter(h, group)).float()
    cols = z.shape[-1]
    z = _valid(z, group.index * cols, vocab)
    m = group.all_reduce(z.detach().amax(dim=-1), op="max")
    logz = torch.log(mesh_lib.combine(torch.sum(torch.exp(z - m[..., None]), dim=-1), group)) + m
    local = targets.long() - group.index * cols
    inside = (local >= 0) & (local < cols)
    picked = torch.gather(z, -1, torch.where(inside, local, 0)[..., None])[..., 0]
    return logz, mesh_lib.combine(torch.where(inside, picked, 0.0), group)


def _valid(z: torch.Tensor, col0: int, vocab: int) -> torch.Tensor:
    """``z``, whose last axis holds the vocab columns from ``col0`` on, with
    the padded vocab's columns (from ``vocab`` on) set to -1e30."""
    if col0 + z.shape[-1] <= vocab:
        return z
    col = col0 + torch.arange(z.shape[-1], device=z.device)
    return torch.where(col < vocab, z, -1e30)


# ---------------------------------------------------------------------------
# SRU / QRNN on a lane shard (the non-fused engines) and the LSTM on column
# shards. With ``mesh`` None each is the whole layer, as on one device.
# ---------------------------------------------------------------------------

def _axis(mesh):
    return None if mesh is None else mesh.axis(MODEL_AXIS)


def _zeros(like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(like.shape[1:], dtype=like.dtype, device=like.device)


def own_lanes(x: torch.Tensor, width: int, mesh) -> torch.Tensor:
    """This model rank's ``width`` lanes of the whole ``x`` (..., H): ``x``
    itself when the rank holds every lane."""
    if width == x.shape[-1]:
        return x
    j = mesh.axis(MODEL_AXIS).index
    return x[..., j * width:(j + 1) * width]


def sru_layer(params, x: torch.Tensor, c0: Optional[torch.Tensor], *, engine: str,
              block_size: int, mesh=None):
    """One SRU layer: all gate products as one GEMM over the T steps (paper
    Eq. 4), then the recurrence on ``engine``. ``x`` (T, B, d) time-major.
    Under ``mesh`` on this rank's lanes: ``params`` its shards (``w`` (d, 3,
    Hl), ``b`` (2, Hl), ``w_skip`` (d, Hl) or None), ``x`` whole, ``c0``
    (B, Hl) or None. Returns ``(h (T, B, H), c_last (B, Hl))``."""
    group = _axis(mesh)
    x = mesh_lib.enter(x, group)
    x_hat, f, r = cells.sru_gates(params, x)
    a, b = cells.sru_recurrence_coeffs(x_hat, f)
    c = linear_scan(a, b, _zeros(x_hat) if c0 is None else c0, engine=engine,
                    block_size=block_size)
    skip = x if params["w_skip"] is not None else own_lanes(x, c.shape[-1], mesh)
    return mesh_lib.gather(cells.sru_output(params, r, c, skip), group), c[-1]


def qrnn_layer(params, x: torch.Tensor, c0: Optional[torch.Tensor],
               x_prev_tail: Optional[torch.Tensor], *, engine: str, block_size: int, mesh=None):
    """One QRNN layer (``w0``/``w1`` (d, 3, Hl), ``b`` (3, Hl) under
    ``mesh``); ``x_prev_tail`` (1, B, d) the conv carry, replicated as in
    JAX. See :func:`sru_layer`."""
    group = _axis(mesh)
    x, x_prev_tail = mesh_lib.enter(x, group), mesh_lib.enter(x_prev_tail, group)
    x_hat, f, o = cells.qrnn_gates(params, x, x_prev_tail)
    c = linear_scan(f, (1.0 - f) * x_hat, _zeros(x_hat) if c0 is None else c0, engine=engine,
                    block_size=block_size)
    return mesh_lib.gather(cells.qrnn_output(params, o, c), group), c[-1]


def lstm_layer(params, x: torch.Tensor, h0: Optional[torch.Tensor],
               c0: Optional[torch.Tensor], *, mesh=None, precompute: bool = True):
    """The LSTM, ``x`` (T, B, d) time-major: ``W x + b`` one GEMM over the T
    steps (``precompute=False``: one a step, the naive baseline), ``U h``
    strictly sequential. Under ``mesh`` on this rank's 4H / k columns of
    ``wx``, ``uh`` and ``b``, ``x`` whole, ``h0`` / ``c0`` (B, H) whole or
    this rank's lanes (gathered first) or None; each step gathers ``z_t``
    and updates ``c``, ``h`` whole. Returns ``(h (T, B, H), c_last (B,
    H))``, whole."""
    group = _axis(mesh)
    H = params["uh"].shape[0]
    B = x.shape[1]
    x = mesh_lib.enter(x, group)

    def whole(s):
        if s is None:
            return torch.zeros((B, H), dtype=x.dtype, device=x.device)
        return s if s.shape[-1] == H else mesh_lib.gather(s, group)

    h, c = whole(h0), whole(c0)
    xproj = cells.lstm_x_proj(params, x) if precompute else None  # (T, B, 4H/k)
    hs = []
    for t in range(x.shape[0]):
        xp_t = xproj[t] if precompute else cells.lstm_x_proj(params, x[t][None])[0]
        z = mesh_lib.gather(xp_t + mesh_lib.enter(h, group) @ params["uh"], group)
        h, c = cells.lstm_update(z, c)
        hs.append(h)
    return torch.stack(hs), c
