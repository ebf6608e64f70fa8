"""Common layers, from ``repro/models/layers.py``: the dtype map, RMSNorm,
and the embedding table and LM head; and the port's device rule."""
from __future__ import annotations

import torch


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def resolve_device(device) -> torch.device:
    """The port's entry points run on the card unless the caller asks for
    the CPU: ``cuda`` without a CUDA device raises, never falls back."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu) to run "
            "the plain PyTorch path on the CPU"
        )
    return device


def dense_init(gen, d_in: int, d_out: int, dtype, device, scale: float | None = None):
    """``normal * d_in**-0.5`` unless ``scale`` is given, as the JAX package."""
    scale = scale if scale is not None else d_in ** -0.5
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32) * scale
    return w.to(device=device, dtype=dtype)


def rmsnorm_init(d: int, dtype, device) -> torch.Tensor:
    return torch.ones((d,), dtype=dtype, device=device)


def rmsnorm(g: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """In fp32, cast back to ``x``'s dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * g.float()).to(x.dtype)


def embed_init(gen, vocab: int, d: int, dtype, tie: bool, device):
    p = {"embed": dense_init(gen, vocab, d, dtype, device)}
    if not tie:
        p["unembed"] = dense_init(gen, d, vocab, dtype, device)
    return p


def embed_apply(params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens]


def logits_apply(params, h: torch.Tensor) -> torch.Tensor:
    """A plain product: the JAX package left it to XLA, outside any kernel."""
    if "unembed" in params:
        return h @ params["unembed"]
    return h @ params["embed"].T
