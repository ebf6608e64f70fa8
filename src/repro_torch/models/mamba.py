"""Mamba-2 block (SSD core), from ``repro/models/mamba.py``: the matrix-state
consumer of the paper's technique.

Projections are separate per component (z, x, B, C, dt) and so are the
causal depthwise convs, with the JAX package's keys. Prefill and decode run
their sequence mixing through ``kernels/ssd/ops.py::ssd``: the CUDA port of
the TPU kernel on the card (the chunked kernel over the prompt, its one-step
form at decode), its plain version on the CPU. ``mamba_apply``, the
training forward, keeps ``core/ssd.py::ssd_chunked``, as in JAX.

Caches ``{"conv_x", "conv_b", "conv_c": (B, W-1, C), "ssm": (B, H, N, P)
fp32}`` per layer. Unlike JAX, prefill and decode write them IN PLACE and
return the same dict: the kernel writes the new state into ``ssm`` (at
decode over the old one), and the conv tails are copied into their
buffers. As in JAX, prefill starts from a zero state and zero tails and does
not read the cache it is given.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.ssd import ssd_chunked
from repro_torch.kernels.ssd.ops import ssd
from repro_torch.models.layers import dense_init, rmsnorm


def mamba_init(gen: torch.Generator, cfg, dtype, device) -> Dict:
    """Params drawn in fp32 on ``gen``'s device, cast to ``dtype`` as they
    are made; ``A_log``, ``D`` and ``dt_bias`` are fp32, as in JAX."""
    d = cfg.d_model
    di = cfg.d_inner
    G, N, H, W = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_conv
    f32 = torch.float32

    def conv_init(channels):
        w = torch.randn((W, channels), generator=gen, dtype=f32, device=gen.device)
        return w.mul_(W ** -0.5).to(device=device, dtype=dtype)

    return {
        "in_z": dense_init(gen, d, di, dtype, device),
        "in_x": dense_init(gen, d, di, dtype, device),
        "in_b": dense_init(gen, d, G * N, dtype, device),
        "in_c": dense_init(gen, d, G * N, dtype, device),
        "in_dt": dense_init(gen, d, H, dtype, device),
        "conv_x": conv_init(di),
        "conv_b": conv_init(G * N),
        "conv_c": conv_init(G * N),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=f32, device=device)),
        "D": torch.ones((H,), dtype=f32, device=device),
        "dt_bias": torch.log(torch.expm1(torch.full((H,), 0.01, dtype=f32, device=device))),
        "gnorm": torch.ones((di,), dtype=dtype, device=device),
        "out_proj": dense_init(gen, di, d, dtype, device),
    }


def _causal_conv(
    x: torch.Tensor, w: torch.Tensor, tail: Optional[torch.Tensor] = None, *,
    impl: str = "shift",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. x: (B, S, C); w: (W, C); tail: (B, W-1, C) carry.

    Returns (silu(y) (B, S, C), new_tail (B, W-1, C), a view of the padded
    input). ``impl="conv"`` with S > 1 runs one depthwise cross-correlation
    (``F.conv1d`` with ``groups=C`` and the taps as they are, not flipped),
    else W shifted multiply-adds."""
    W = w.shape[0]
    if tail is None:
        tail = x.new_zeros((x.shape[0], W - 1, x.shape[2]))
    xp = torch.cat([tail, x], dim=1)  # (B, S+W-1, C)
    if impl == "conv" and x.shape[1] > 1:
        C = x.shape[2]
        y = F.conv1d(xp.transpose(1, 2), w.t()[:, None, :].to(xp.dtype), groups=C)
        y = y.transpose(1, 2).contiguous()
    else:
        y = sum(xp[:, i : i + x.shape[1]] * w[i][None, None, :] for i in range(W))
    return F.silu(y), xp[:, -(W - 1):]


def _softplus(v: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(v, 0)``."""
    return torch.logaddexp(v, torch.zeros_like(v))


def _project(params, x: torch.Tensor):
    """z, x, B, C projections and dt = softplus(x @ in_dt + dt_bias) in fp32."""
    dt = _softplus((x @ params["in_dt"]).float() + params["dt_bias"])
    return (x @ params["in_z"], x @ params["in_x"], x @ params["in_b"], x @ params["in_c"],
            dt)


def _gate_out(params, cfg, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    B, S = y.shape[:2]
    y = rmsnorm(params["gnorm"], y.reshape(B, S, cfg.d_inner) * F.silu(z))
    return y @ params["out_proj"]


def mamba_apply(params, cfg, x: torch.Tensor, *, engine: Optional[str] = None) -> torch.Tensor:
    """Train/prefill path without caches (the training forward). x: (B, S, d)."""
    B, S, _ = x.shape
    G, N, H, P = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    z, xi, bi, ci, dt = _project(params, x)
    xi, _ = _causal_conv(xi, params["conv_x"], impl=cfg.conv_impl)
    bi, _ = _causal_conv(bi, params["conv_b"], impl=cfg.conv_impl)
    ci, _ = _causal_conv(ci, params["conv_c"], impl=cfg.conv_impl)
    A = -torch.exp(params["A_log"])
    y = ssd_chunked(
        xi.reshape(B, S, H, P), dt, A, bi.reshape(B, S, G, N), ci.reshape(B, S, G, N),
        params["D"],
        chunk=min(cfg.ssd_chunk, S),
        engine=engine or ("associative" if cfg.scan_engine == "pallas" else cfg.scan_engine),
        intra_dtype=torch.bfloat16 if cfg.ssd_intra_dtype == "bfloat16" else None,
    )
    return _gate_out(params, cfg, y, z)


def mamba_init_cache(cfg, batch: int, dtype, device) -> Dict:
    G, N, H, P, W = (
        cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_conv,
    )
    return {
        "conv_x": torch.zeros((batch, W - 1, cfg.d_inner), dtype=dtype, device=device),
        "conv_b": torch.zeros((batch, W - 1, G * N), dtype=dtype, device=device),
        "conv_c": torch.zeros((batch, W - 1, G * N), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, H, N, P), dtype=torch.float32, device=device),
    }


def mamba_prefill(params, cfg, x: torch.Tensor, cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """x: (B, S, d). Like ``mamba_apply``, from a zero state and zero conv
    tails; writes the state after the prompt and the new tails into
    ``cache`` in place."""
    B, S, _ = x.shape
    G, N, H, P = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    z, xi, bi, ci, dt = _project(params, x)
    xi, tail_x = _causal_conv(xi, params["conv_x"], impl=cfg.conv_impl)
    bi, tail_b = _causal_conv(bi, params["conv_b"], impl=cfg.conv_impl)
    ci, tail_c = _causal_conv(ci, params["conv_c"], impl=cfg.conv_impl)
    A = -torch.exp(params["A_log"])
    y, _ = ssd(
        xi.reshape(B, S, H, P), dt, A, bi.reshape(B, S, G, N), ci.reshape(B, S, G, N),
        params["D"], chunk=min(cfg.ssd_chunk, S), state_out=cache["ssm"],
    )
    for key, tail in (("conv_x", tail_x), ("conv_b", tail_b), ("conv_c", tail_c)):
        cache[key].copy_(tail)
    return _gate_out(params, cfg, y, z), cache


def mamba_decode(params, cfg, x: torch.Tensor, cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """x: (B, 1, d). O(1) per-token decode: the conv tails and the SSM state
    of ``cache`` are updated in place."""
    B = x.shape[0]
    G, N, H, P = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    z, xi, bi, ci, dt = _project(params, x)
    xi, tail_x = _causal_conv(xi, params["conv_x"], cache["conv_x"])
    bi, tail_b = _causal_conv(bi, params["conv_b"], cache["conv_b"])
    ci, tail_c = _causal_conv(ci, params["conv_c"], cache["conv_c"])
    A = -torch.exp(params["A_log"])
    y, _ = ssd(
        xi.reshape(B, 1, H, P), dt, A, bi.reshape(B, 1, G, N), ci.reshape(B, 1, G, N),
        params["D"], initial_state=cache["ssm"], chunk=1, state_out=cache["ssm"],
    )
    for key, tail in (("conv_x", tail_x), ("conv_b", tail_b), ("conv_c", tail_c)):
        cache[key].copy_(tail)
    return _gate_out(params, cfg, y, z), cache
