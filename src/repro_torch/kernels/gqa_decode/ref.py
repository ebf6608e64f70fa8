"""Plain PyTorch version of the decode-attention kernel
(``repro/kernels/gqa_decode/ref.py::gqa_decode_ref``).

fp32 scores scaled by ``Dh**-0.5``, rows at or past each lane's length
masked to ``-inf``, an fp32 softmax, ``p @ v`` in fp32, cast to ``q``'s
dtype. The CPU path of ``ops.gqa_decode`` runs it, and ``chip_smoke.py``
holds the kernel to it on the card.
"""
from __future__ import annotations

import torch


def gqa_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, Hq, Dh); k, v: (B, S, Hkv, Dh); lengths: (B,) valid rows."""
    B, Hq, Dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    scale = 1.0 / torch.sqrt(torch.tensor(Dh, dtype=torch.float32))
    qg = q.reshape(B, Hkv, Hq // Hkv, Dh).float()
    scores = torch.einsum("bhgd,bshd->bhgs", qg, k.float()) * scale.to(q.device)
    mask = (torch.arange(S, device=q.device)[None, :] < lengths[:, None])[:, None, None, :]
    scores = scores.masked_fill(~mask, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, v.float())
    return out.reshape(B, Hq, Dh).to(q.dtype)
