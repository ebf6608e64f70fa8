"""Plain PyTorch version of the decode-attention kernel
(``repro/kernels/gqa_decode/ref.py::gqa_decode_ref``).

fp32 scores scaled by ``Dh**-0.5``, rows at or past each lane's length
masked to ``-inf``, an fp32 softmax, ``p @ v`` in fp32, cast to ``q``'s
dtype. The CPU path of ``ops.gqa_decode`` runs it, and ``chip_smoke.py``
holds the kernel to it on the card.

``return_lse=True`` is the form a shard of a cache's rows runs (the
sequence-sharded cache of ``models/attention.py``): it also
returns each (lane, query head)'s log-sum-exp of its scaled scores, fp32
(B, Hq), and takes a length of 0, for which the output is 0 and the
log-sum-exp ``-inf``. Shards combine by ``exp(lse_i - max lse)`` weights.
"""
from __future__ import annotations

import torch


def gqa_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   lengths: torch.Tensor, return_lse: bool = False):
    """q: (B, Hq, Dh); k, v: (B, S, Hkv, Dh); lengths: (B,) valid rows."""
    B, Hq, Dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    scale = 1.0 / torch.sqrt(torch.tensor(Dh, dtype=torch.float32))
    qg = q.reshape(B, Hkv, Hq // Hkv, Dh).float()
    scores = torch.einsum("bhgd,bshd->bhgs", qg, k.float()) * scale.to(q.device)
    mask = (torch.arange(S, device=q.device)[None, :] < lengths[:, None])[:, None, None, :]
    scores = scores.masked_fill(~mask, float("-inf"))
    if not return_lse:
        p = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhgs,bshd->bhgd", p, v.float())
        return out.reshape(B, Hq, Dh).to(q.dtype)
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))  # an empty lane: every score -inf
    p = torch.exp(scores - m)
    l = p.sum(dim=-1)
    acc = torch.einsum("bhgs,bshd->bhgd", p, v.float())
    out = acc / torch.where(l > 0, l, torch.ones_like(l))[..., None]
    lse = torch.where(l > 0, m[..., 0] + torch.log(l), torch.full_like(l, float("-inf")))
    return out.reshape(B, Hq, Dh).to(q.dtype), lse.reshape(B, Hq)
