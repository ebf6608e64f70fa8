"""GQA attention, from ``repro/models/attention.py``: chunked prefill, cached
decode, SWA.

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
``pos``: no host sync per layer or step.

On one device the model axis is 1, so of the JAX package's sharding only the
head padding (``pad_heads_to``) applies. ``attn_train``, the training
forward, runs ``chunked_attention`` and is differentiated by autograd; the
decode kernel is never on the training path (JAX has no VJP for it).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.gqa_decode.ops import gqa_decode
from repro_torch.models.layers import dense_init, rmsnorm, rmsnorm_init, rope

NEG_INF = -1e30


def _eff_heads(cfg) -> int:
    """Q head count inside attention (>= n_heads when pad_heads_to is set)."""
    return max(cfg.pad_heads_to, cfg.n_heads) if cfg.pad_heads_to else cfg.n_heads


def _kv_index_for_heads(cfg, device) -> torch.Tensor:
    """KV head feeding each (possibly padded) Q head: grouped GQA mapping."""
    Hq, Hkv, He = cfg.n_heads, cfg.n_kv_heads, _eff_heads(cfg)
    return torch.clamp(torch.arange(He, device=device) * Hkv // Hq, max=Hkv - 1)


def _maybe_repeat_kv(cfg, k: torch.Tensor, v: torch.Tensor):
    """With padded Q heads, gather KV heads up to the padded Q head count
    (JAX's ``padded`` case; its sharded case needs a model axis > 1)."""
    Hkv, He = cfg.n_kv_heads, _eff_heads(cfg)
    if Hkv != He and He != cfg.n_heads:
        idx = _kv_index_for_heads(cfg, k.device)
        k, v = k.index_select(2, idx), v.index_select(2, idx)
    return k, v


def _head_mask(cfg, out: torch.Tensor) -> torch.Tensor:
    """Zero the outputs of padded heads."""
    He = _eff_heads(cfg)
    if He == cfg.n_heads:
        return out
    mask = (torch.arange(He, device=out.device) < cfg.n_heads).to(out.dtype)
    return out * mask[None, None, :, None]


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


def _project_qkv(params, cfg, x, positions):
    B, S, _ = x.shape
    Hq, Hkv, Dh = _eff_heads(cfg), cfg.n_kv_heads, cfg.d_head
    q = (x @ params["w_q"]).reshape(B, S, Hq, Dh)
    kv = (x @ params["w_kv"]).reshape(B, S, 2, Hkv, Dh)
    k, v = kv[:, :, 0], kv[:, :, 1]
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q)
        k = rmsnorm(params["k_norm"], k)
    return rope(q, positions, cfg.rope_theta), rope(k, positions, cfg.rope_theta), v


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
    qg = q.reshape(B, Sq, Hkv, G, Dh).float()
    kf, vf = k.float(), v.float()
    blocks = []
    for i in range(0, Sq, cq):
        qs, qp = qg[:, i:i + cq], q_pos[:, i:i + cq]
        m = torch.full((B, Hkv, G, cq), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, Hkv, G, cq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, Hkv, G, cq, Dh), dtype=torch.float32, device=q.device)
        for j in range(0, Sk, ck):
            ks, vs, kp = kf[:, j:j + ck], vf[:, j:j + ck], k_pos[:, j:j + ck]
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
        blocks.append(out.permute(0, 3, 1, 2, 4))  # (B, cq, Hkv, G, Dh)
    return torch.cat(blocks, dim=1).reshape(B, Sq, Hq, Dh).to(q.dtype)


def attn_train(params, cfg, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d); positions (B, S). Causal (SWA) attention over the
    sequence, no cache."""
    q, k, v = _project_qkv(params, cfg, x, positions)
    k, v = _maybe_repeat_kv(cfg, k, v)
    out = chunked_attention(
        q, k, v, positions, positions,
        window=cfg.sliding_window, chunk_q=cfg.attn_chunk, chunk_k=cfg.attn_chunk,
    )
    out = _head_mask(cfg, out)
    B, S = x.shape[:2]
    return out.reshape(B, S, -1) @ params["w_o"]


# ---------------------------------------------------------------------------
# KV cache (uniform scalar length; SWA uses a ring buffer of size window)
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, dtype, device) -> Dict:
    size = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    shape = (batch, size, cfg.n_kv_heads, cfg.d_head)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),  # absolute next position
    }


def attn_prefill(params, cfg, x: torch.Tensor, cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """x: (B, S, d). Writes the prompt's K/V (the last ``size`` of them, ring
    ordered, under SWA) and ``pos = S`` into ``cache`` in place."""
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    q, k, v = _project_qkv(params, cfg, x, positions)
    k_att, v_att = _maybe_repeat_kv(cfg, k, v)
    out = chunked_attention(
        q, k_att, v_att, positions, positions,
        window=cfg.sliding_window, chunk_q=cfg.attn_chunk, chunk_k=cfg.attn_chunk,
    )
    out = _head_mask(cfg, out)
    size = cache["k"].shape[1]
    if S >= size:  # keep the last `size` entries (SWA ring; ring origin at pos % size)
        cache["k"].copy_(torch.roll(k[:, S - size:], shifts=S % size, dims=1))
        cache["v"].copy_(torch.roll(v[:, S - size:], shifts=S % size, dims=1))
    else:
        cache["k"][:, :S].copy_(k)
        cache["v"][:, :S].copy_(v)
    cache["pos"].fill_(S)
    return out.reshape(B, S, -1) @ params["w_o"], cache


def attn_decode(params, cfg, x: torch.Tensor, cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """x: (B, 1, d). Writes the new K/V row at the slot ``pos % size`` (SWA)
    or ``min(pos, size - 1)`` in place, attends over the ``min(pos + 1,
    size)`` valid slots through ``gqa_decode``, advances ``pos`` in place."""
    B = x.shape[0]
    Hq, Dh = cfg.n_heads, cfg.d_head
    He = _eff_heads(cfg)
    pos = cache["pos"]
    q, k_new, v_new = _project_qkv(params, cfg, x, pos.expand(B, 1))
    q = q[:, 0, :Hq].contiguous()  # padded heads are masked anyway; skip their compute

    size = cache["k"].shape[1]
    slot = torch.remainder(pos, size) if cfg.sliding_window else torch.clamp(pos, max=size - 1)
    slot = slot.reshape(1).long()
    cache["k"].index_copy_(1, slot, k_new.to(cache["k"].dtype))
    cache["v"].index_copy_(1, slot, v_new.to(cache["v"].dtype))
    lengths = torch.clamp(pos + 1, max=size).expand(B).contiguous()

    out = gqa_decode(q.to(cache["k"].dtype), cache["k"], cache["v"], lengths)
    out = out.reshape(B, 1, Hq * Dh).to(x.dtype)
    if He != Hq:  # padded heads contribute zeros through their w_o rows
        out = torch.nn.functional.pad(out, (0, (He - Hq) * Dh))
    cache["pos"].add_(1)
    return out @ params["w_o"], cache
