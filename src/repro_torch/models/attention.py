"""GQA attention, from ``repro/models/attention.py``: chunked prefill, cached
decode, SWA, on one device or on a rank's shards under a model axis.

Prefill runs the JAX package's flash schedule in plain PyTorch: a q-block
outer loop with an online softmax over KV blocks in fp32, so the (S, S)
score matrix is never materialized; the JAX package computes it outside any
Pallas kernel. Decode attends over the cache through ``gqa_decode``: the
CUDA port of the TPU kernel on the card, its plain version on the CPU.

The KV cache is ``{"k", "v": (B, size, Hkv, Dh), "pos": () int32}`` per
layer, as in JAX; sliding-window attention (SWA) keeps a ring buffer of
``size = window`` slots (RoPE is applied before caching, so ring overwrite is
sound). Unlike JAX, prefill and decode write the cache IN PLACE: decode
writes its one new K/V row into the slot and advances ``pos``; nothing of
the cache is copied. Slots and lengths are computed on the device from
``pos``: no host sync per layer or step. ``attn_train``, the training
forward, runs ``chunked_attention`` and is differentiated by autograd; the
decode kernel is never on the training path (JAX has no VJP for it).

Under a mesh's model axis (the step builders' ``sharding.use_rules``) each
function runs the rank's shards of what JAX's GSPMD partitions under the
rules of ``repro/distribution/sharding.py`` (``w_q`` / ``w_o`` over the
flat heads, ``w_kv`` over its flat columns) and of the cache as its
``cache_specs`` places it, through ``launch/mesh.py``'s autograd
collectives, which are the identity with no model axis: one device runs the
same functions with every leaf and slot its own. Which leaves are sharded is
read off their shapes: a dim that does not divide the axis is whole (JAX's
divisibility fallback, ``sharding._resolve``), and a mix of sharded and
whole leaves works.

  * **Projections.** A column block whose columns do not fall on heads is
    multiplied and gathered: ``w_kv (d, 2 Hkv Dh)`` is laid out ``(2, Hkv,
    Dh)``, so on two ranks rank 0's block is all of K; ``w_q`` shards the
    flat ``He Dh``, which splits a head where ``He`` does not divide. K and
    V are always the gathered ``x @ w_kv`` (small: ``2 Hkv Dh`` numbers a
    token), q the rank's heads where ``He`` divides (``[j He/k, (j+1)
    He/k)``), else gathered. ``w_o`` shards its rows: the rank's rows of
    the attention output (its own heads, or its slice of the whole output)
    times its rows of ``w_o``, summed over the axis (``combine``). Padded
    heads (``pad_heads_to``) stay zero.
  * **Prefill and training** run :func:`chunked_attention` on the rank's q
    heads against the KV heads they read (JAX's ``_maybe_repeat_kv``: one
    KV head per q head where the KV heads do not divide the axis or the
    heads are padded, else the grouped form).
  * **Decode, KV heads over the axis** (``Hkv % k == 0``): the rank holds
    KV heads ``[j Hkv/k, (j+1) Hkv/k)``, writes its new row in place and
    runs B5 (``gqa_decode``) unchanged on the q heads that read them.
  * **Decode, sequence over the axis** (the KV heads do not divide, the
    cache length does): flash decoding across ranks. Rank j holds slots
    ``[j S/k, (j+1) S/k)`` of every KV head; the prompt's rows and each new
    row are written only on the rank that holds their slot, B5 runs over the
    rank's slots with lengths ``clamp(n_valid - j S/k, 0, S/k)`` in its
    log-sum-exp form (a length of 0 gives a zero output and ``-inf``), and
    the ranks combine their partials by log-sum-exp weights (one ``max`` and
    one sum over the axis), where JAX leaves the combine to GSPMD. The
    cache's whole length is the step builders' ``max_len``
    (:func:`cache_length`, :func:`needs_cache_length`): a rank's slice does
    not show it.

Autograd: a tensor every rank holds alike (the normed input, the whole
K / V) enters a rank's region through :func:`launch.mesh.enter` (backward:
the ranks' partial cotangents summed), so each whole leaf gets the same full
gradient on every rank and each sharded leaf its own shard's.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distribution.sharding import model_group, model_shards
from repro_torch.kernels.gqa_decode.ops import gqa_decode
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.layers import dense_init, rmsnorm, rmsnorm_init, rope

NEG_INF = -1e30
_KV_LEN: contextvars.ContextVar[Optional[int]] = contextvars.ContextVar("kv_len", default=None)


@contextlib.contextmanager
def cache_length(max_len: Optional[int]):
    """The whole length the enclosed steps' KV caches were made for (the
    step builders' ``max_len``), from which a rank finds whether its cache
    holds a slice of the sequence."""
    tok = _KV_LEN.set(max_len)
    try:
        yield
    finally:
        _KV_LEN.reset(tok)


def needs_cache_length(cfg, mesh) -> bool:
    """True when a rank's KV cache under ``mesh`` may hold a slice of its
    sequence, which its shape does not tell apart from a whole cache: the
    config has KV heads and they do not divide the model axis."""
    k = model_shards(mesh)
    return k > 1 and cfg.n_kv_heads > 0 and cfg.n_kv_heads % k != 0


def _eff_heads(cfg) -> int:
    """Q head count inside attention (>= n_heads when pad_heads_to is set)."""
    return max(cfg.pad_heads_to, cfg.n_heads) if cfg.pad_heads_to else cfg.n_heads


def _kv_index_for_heads(cfg, device) -> torch.Tensor:
    """KV head feeding each (possibly padded) Q head: grouped GQA mapping."""
    Hq, Hkv, He = cfg.n_heads, cfg.n_kv_heads, _eff_heads(cfg)
    return torch.clamp(torch.arange(He, device=device) * Hkv // Hq, max=Hkv - 1)


def attn_init(gen, cfg, dtype, device) -> Dict:
    d, Hkv, Dh = cfg.d_model, cfg.n_kv_heads, cfg.d_head
    He = _eff_heads(cfg)
    p = {
        "w_q": dense_init(gen, d, He * Dh, dtype, device),
        "w_kv": dense_init(gen, d, 2 * Hkv * Dh, dtype, device),
        "w_o": dense_init(gen, He * Dh, d, dtype, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(Dh, dtype, device)
        p["k_norm"] = rmsnorm_init(Dh, dtype, device)
    return p


def _block_size(n: int, chunk: int) -> int:
    c = min(chunk, n)
    while n % c:
        c -= 1
    return c


def chunked_attention(
    q: torch.Tensor,      # (B, Sq, Hq, Dh)
    k: torch.Tensor,      # (B, Sk, Hkv, Dh)
    v: torch.Tensor,      # (B, Sk, Hkv, Dh)
    q_pos: torch.Tensor,  # (B, Sq)
    k_pos: torch.Tensor,  # (B, Sk)
    *,
    window: Optional[int],
    chunk_q: int,
    chunk_k: int,
) -> torch.Tensor:
    """Causal (and SWA) attention, q blocks by KV blocks with an online
    softmax in fp32; returns (B, Sq, Hq, Dh) in q's dtype."""
    B, Sq, Hq, Dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    cq, ck = _block_size(Sq, chunk_q), _block_size(Sk, chunk_k)
    scale = Dh ** -0.5
    qg = q.reshape(B, Sq, Hkv, G, Dh)
    blocks = []
    # Each block is widened to fp32 where it is used, as JAX's kv_step does:
    # never the whole q, K or V at once.
    for i in range(0, Sq, cq):
        qs, qp = qg[:, i:i + cq].float(), q_pos[:, i:i + cq]
        m = torch.full((B, Hkv, G, cq), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, Hkv, G, cq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, Hkv, G, cq, Dh), dtype=torch.float32, device=q.device)
        for j in range(0, Sk, ck):
            ks, vs, kp = k[:, j:j + ck].float(), v[:, j:j + ck].float(), k_pos[:, j:j + ck]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qs, ks) * scale
            mask = kp[:, None, None, None, :] <= qp[:, None, None, :, None]
            if window is not None:
                mask &= kp[:, None, None, None, :] > (qp[:, None, None, :, None] - window)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, vs)
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        blocks.append(out.permute(0, 3, 1, 2, 4).to(q.dtype))  # (B, cq, Hkv, G, Dh)
    return torch.cat(blocks, dim=1).reshape(B, Sq, Hq, Dh)


# ---------------------------------------------------------------------------
# Projections and the output, on one device or a rank's shards
# ---------------------------------------------------------------------------

def _cols(x: torch.Tensor, w: torch.Tensor, width: int, group) -> torch.Tensor:
    """``x @ w`` whole along the last dim, alike on every rank: ``w`` whole,
    or the rank's column block, whose products the axis gathers."""
    if w.shape[-1] == width:
        return x @ w
    return mesh_lib.gather(mesh_lib.enter(x, group) @ w, group)


def _kv(params, cfg, x: torch.Tensor, positions: torch.Tensor, group):
    """k (normed, rotated) and v (B, S, Hkv, Dh), whole on every rank."""
    B, S, _ = x.shape
    Hkv, Dh = cfg.n_kv_heads, cfg.d_head
    kv = _cols(x, params["w_kv"], 2 * Hkv * Dh, group).reshape(B, S, 2, Hkv, Dh)
    k, v = kv[:, :, 0], kv[:, :, 1]
    if cfg.qk_norm:
        k = rmsnorm(params["k_norm"], k)
    return rope(k, positions, cfg.rope_theta), v


def _own_heads(cfg, params, group) -> Optional[Tuple[int, int]]:
    """``(h0, n)``: the padded q heads ``w_q``'s columns hold on this rank
    when they are whole heads of a sharded ``w_q``, else None."""
    He, Dh = _eff_heads(cfg), cfg.d_head
    cols = params["w_q"].shape[-1]
    if cols == He * Dh or He % group.size:
        return None
    n = cols // Dh
    return group.index * n, n


def _q(params, cfg, x: torch.Tensor, positions: torch.Tensor, group, local: bool):
    """q (normed, rotated): ``local`` the rank's own heads (B, S, n, Dh) of
    :func:`_own_heads`, computed in the rank's region; else all He heads,
    whole on every rank."""
    B, S, _ = x.shape
    He, Dh = _eff_heads(cfg), cfg.d_head
    q_norm = params.get("q_norm")
    if local:
        q = (mesh_lib.enter(x, group) @ params["w_q"]).reshape(B, S, -1, Dh)
        q_norm = mesh_lib.enter(q_norm, group)
    else:
        q = _cols(x, params["w_q"], He * Dh, group).reshape(B, S, He, Dh)
    if cfg.qk_norm:
        q = rmsnorm(q_norm, q)
    return rope(q, positions, cfg.rope_theta)


def _rows_sharded(cfg, params) -> bool:
    """True when ``w_o`` holds the rank's rows: the attention then runs in
    the rank's region, its output summed over the axis."""
    return params["w_o"].shape[0] != _eff_heads(cfg) * cfg.d_head


def _out_proj(params, cfg, o: torch.Tensor, h0: int, group, seq=None) -> torch.Tensor:
    """The block's output from ``o`` (B, S, n Dh): the attention output of
    padded heads ``[h0, h0 + n)``, the rank's own (its rows of a sharded
    ``w_o``) or all He of them (its slice of them, or all of a whole
    ``w_o``). ``seq``: the sequence-parallel axis (:func:`attn_train`); the
    output is then the rank's sequence slice, reduce-scattered from the
    partial products, or sliced from a whole ``w_o``'s."""
    Dh = cfg.d_head
    w = params["w_o"]
    if not _rows_sharded(cfg, params):
        return mesh_lib.seq_slice(o @ w, seq)
    rows = w.shape[0]
    lo = group.index * rows
    if o.shape[-1] != rows or h0 * Dh != lo:
        o = o[..., lo:lo + rows]
    if seq is not None:
        return mesh_lib.seq_scatter(o @ w, seq)
    return mesh_lib.combine(o @ w, group)


def _heads_mask(cfg, o: torch.Tensor, h0: int) -> torch.Tensor:
    """Zero the outputs of padded heads among ``[h0, h0 + n)``."""
    n = o.shape[2]
    if h0 + n <= cfg.n_heads:
        return o
    keep = (torch.arange(h0, h0 + n, device=o.device) < cfg.n_heads).to(o.dtype)
    return o * keep[None, None, :, None]


def _kv_for(cfg, k: torch.Tensor, v: torch.Tensor, h0: int, n: int, group):
    """The KV heads q heads ``[h0, h0 + n)`` read, as JAX's
    ``_maybe_repeat_kv`` maps them: one a q head (index) where the heads are
    padded or the KV heads do not divide the model axis, else the groups'
    own KV heads."""
    Hkv, He = cfg.n_kv_heads, _eff_heads(cfg)
    size = 1 if group is None else group.size
    if Hkv == He or (He == cfg.n_heads and Hkv % size == 0):
        G = He // Hkv
        return k[:, :, h0 // G:(h0 + n) // G], v[:, :, h0 // G:(h0 + n) // G]
    idx = _kv_index_for_heads(cfg, k.device)[h0:h0 + n]
    return k.index_select(2, idx), v.index_select(2, idx)


def _prompt_attention(params, cfg, x: torch.Tensor, positions: torch.Tensor, group):
    """Causal (SWA) attention of a prompt: ``(o, h0, k, v)``, ``o`` (B, S,
    n Dh) the output of padded heads ``[h0, h0 + n)`` (the rank's own, or
    all He), k and v whole."""
    B, S, _ = x.shape
    He = _eff_heads(cfg)
    k, v = _kv(params, cfg, x, positions, group)
    region = group if _rows_sharded(cfg, params) else None  # else all alike, no region
    own = None if group is None else _own_heads(cfg, params, group)
    if own is None:
        q, (h0, n) = mesh_lib.enter(_q(params, cfg, x, positions, group, False), region), (0, He)
    else:
        q, (h0, n) = _q(params, cfg, x, positions, group, True), own
    ka, va = _kv_for(cfg, mesh_lib.enter(k, region), mesh_lib.enter(v, region), h0, n, group)
    o = chunked_attention(q, ka, va, positions, positions, window=cfg.sliding_window,
                          chunk_q=cfg.attn_chunk, chunk_k=cfg.attn_chunk)
    return _heads_mask(cfg, o, h0).reshape(B, S, -1), h0, k, v


def attn_train(params, cfg, x: torch.Tensor, positions: torch.Tensor, seq=None
               ) -> torch.Tensor:
    """x: (B, S, d); positions (B, S). Causal (SWA) attention over the
    sequence, no cache. ``seq``: the model axis the sequence is sliced over
    (sequence parallelism, ``sharding.seq_group``): ``x`` is then the
    rank's slice (B, S / k, d), gathered whole where the projections read
    it, and the output is the rank's slice (Megatron-SP: an all-gather in,
    a reduce-scatter out, the region between on partial cotangents);
    ``positions`` stay whole."""
    group = model_group()
    x = mesh_lib.seq_gather(x, seq)
    with mesh_lib.partial_cotangents(seq is not None):
        o, h0, _, _ = _prompt_attention(params, cfg, x, positions, group)
        return _out_proj(params, cfg, o, h0, group, seq)


# ---------------------------------------------------------------------------
# KV cache (uniform scalar length; SWA uses a ring buffer of size window)
# ---------------------------------------------------------------------------

def cache_shapes(cfg, batch: int, max_len: int, dtype) -> Dict:
    """``{leaf: (shape, dtype)}`` of :func:`init_cache`, no tensor made."""
    size = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    shape = (batch, size, cfg.n_kv_heads, cfg.d_head)
    return {"k": (shape, dtype), "v": (shape, dtype),
            "pos": ((), torch.int32)}  # absolute next position


def init_cache(cfg, batch: int, max_len: int, dtype, device) -> Dict:
    return {k: torch.zeros(s, dtype=dt, device=device)
            for k, (s, dt) in cache_shapes(cfg, batch, max_len, dtype).items()}


def _cache_layout(cfg, cache: Dict, group) -> Tuple[str, int, int]:
    """``(kind, lo, size)`` of the rank's KV cache: ``"heads"`` (its KV
    heads from ``lo``), ``"seq"`` (its slots from ``lo`` of a ``size``-slot
    cache) or ``"whole"`` (every slot of ``size``)."""
    Hl, s = cache["k"].shape[2], cache["k"].shape[1]
    if group is None:
        return "whole", 0, s
    if Hl != cfg.n_kv_heads:
        return "heads", group.index * Hl, s
    max_len = _KV_LEN.get()
    if max_len is None:
        raise ValueError(
            f"{cfg.name}: {cfg.n_kv_heads} KV heads do not divide the model axis of "
            f"{group.size}, so the KV cache may hold a slice of its sequence; pass the "
            "caches' max_len to the step builder (build_decode_step(cfg, mesh, max_len=))")
    size = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    if s == size:
        return "whole", 0, size
    if s * group.size != size:
        raise ValueError(f"{cfg.name}: a KV cache of {s} slots on a rank is no shard of "
                         f"{size} over {group.size} ranks")
    return "seq", group.index * s, size


def _store_prompt(cache: Dict, k: torch.Tensor, v: torch.Tensor, lo: int, size: int) -> None:
    """Write the prompt's K/V rows into the rank's slots ``[lo, lo + s)`` of
    a ``size``-slot cache, as the whole cache holds them (the last ``size``
    rows, ring ordered, under SWA)."""
    S, s = k.shape[1], cache["k"].shape[1]
    if S >= size:  # keep the last `size` entries (SWA ring; ring origin at pos % size)
        for key, t in (("k", k), ("v", v)):
            whole = torch.roll(t[:, S - size:], shifts=S % size, dims=1)
            cache[key].copy_(whole[:, lo:lo + s])
        return
    n = min(max(S - lo, 0), s)
    if n:
        cache["k"][:, :n].copy_(k[:, lo:lo + n])
        cache["v"][:, :n].copy_(v[:, lo:lo + n])


def attn_prefill(params, cfg, x: torch.Tensor, cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """x: (B, S, d). Writes the prompt's K/V (the last ``size`` of them, ring
    ordered, under SWA; under a model axis the rank's KV heads, or its
    slots) and ``pos = S`` into ``cache`` in place."""
    group = model_group()
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    o, h0, k, v = _prompt_attention(params, cfg, x, positions, group)
    kind, lo, size = _cache_layout(cfg, cache, group)
    if kind == "heads":
        Hl = cache["k"].shape[2]
        k, v, lo = k[:, :, lo:lo + Hl], v[:, :, lo:lo + Hl], 0
    _store_prompt(cache, k.to(cache["k"].dtype), v.to(cache["v"].dtype), lo, size)
    cache["pos"].fill_(S)
    return _out_proj(params, cfg, o, h0, group), cache


def _lse_combine(o: torch.Tensor, lse: torch.Tensor, group) -> torch.Tensor:
    """The whole attention output from the ranks' partial ones over their
    slots, ``o`` (B, Hq, Dh) and its fp32 log-sum-exp (B, Hq): weights
    ``exp(lse - max lse)``, in fp32."""
    B, Hq, Dh = o.shape
    w = torch.exp(lse - group.all_reduce(lse, "max"))  # a rank with no valid slot: 0
    num = (o.float() * w[..., None]).reshape(B, Hq * Dh)
    total = group.all_reduce(torch.cat([num, w], dim=-1))
    return (total[:, :Hq * Dh].reshape(B, Hq, Dh) / total[:, Hq * Dh:, None]).to(o.dtype)


def attn_decode(params, cfg, x: torch.Tensor, cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """x: (B, 1, d). Writes the new K/V row at the slot ``pos % size`` (SWA)
    or ``min(pos, size - 1)`` in place, attends over the ``min(pos + 1,
    size)`` valid slots through ``gqa_decode``, advances ``pos`` in place.
    Under a model axis: B5 on the rank's KV heads, or its log-sum-exp form
    on the rank's slots, combined across ranks."""
    group = model_group()
    B = x.shape[0]
    Hq, Hkv, Dh, He = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, _eff_heads(cfg)
    pos = cache["pos"]
    positions = pos.expand(B, 1)
    k_new, v_new = _kv(params, cfg, x, positions, group)
    kind, lo, size = _cache_layout(cfg, cache, group)
    ck, cv = cache["k"], cache["v"]
    s = ck.shape[1]
    slot = torch.remainder(pos, size) if cfg.sliding_window else torch.clamp(pos, max=size - 1)
    n_valid = torch.clamp(pos + 1, max=size)
    h0, n = 0, Hq  # padded heads are masked anyway; skip their compute
    if kind == "heads":  # the rank's KV heads [lo, lo + Hl) and the q heads that read them
        Hl = ck.shape[2]
        k_new, v_new = k_new[:, :, lo:lo + Hl], v_new[:, :, lo:lo + Hl]
        h0, n = lo * (Hq // Hkv), Hl * (Hq // Hkv)
    own = None if group is None else _own_heads(cfg, params, group)
    if own == (h0, n):
        q = _q(params, cfg, x, positions, group, True)[:, 0]
    else:
        q = _q(params, cfg, x, positions, group, False)[:, 0, h0:h0 + n]
    q = q.to(ck.dtype).contiguous()
    if kind == "seq":  # the new row lands on the rank that holds its slot
        mine = (slot >= lo) & (slot < lo + s)
        at = torch.clamp(slot - lo, 0, s - 1).reshape(1).long()
        k_new = torch.where(mine, k_new.to(ck.dtype), ck.index_select(1, at))
        v_new = torch.where(mine, v_new.to(cv.dtype), cv.index_select(1, at))
        ck.index_copy_(1, at, k_new)
        cv.index_copy_(1, at, v_new)
        lengths = torch.clamp(n_valid - lo, 0, s).expand(B).contiguous()
        o, lse = gqa_decode(q, ck, cv, lengths, return_lse=True)
        o = _lse_combine(o, lse, group)
    else:
        at = slot.reshape(1).long()
        ck.index_copy_(1, at, k_new.to(ck.dtype))
        cv.index_copy_(1, at, v_new.to(cv.dtype))
        o = gqa_decode(q, ck, cv, n_valid.expand(B).contiguous())
    o = o.reshape(B, 1, n * Dh).to(x.dtype)
    cache["pos"].add_(1)
    if own != (h0, n):  # all Hq heads, alike on every rank
        if n != Hq:
            o = group.all_gather(o)
        if He != Hq:  # padded heads contribute zeros through their w_o rows
            o = F.pad(o, (0, (He - Hq) * Dh))
        h0 = 0
    return _out_proj(params, cfg, o, h0, group), cache
