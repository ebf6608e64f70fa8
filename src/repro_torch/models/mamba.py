"""Mamba-2 block (SSD core), from ``repro/models/mamba.py``: the matrix-state
consumer of the paper's technique, on one device or on a rank's shards under
a model axis.

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

Under a mesh's model axis (the step builders' ``sharding.use_rules``), where
``d_inner`` divides it, JAX's rules shard the mixer over "ff": ``in_z``,
``in_x``, ``conv_x`` and ``gnorm`` hold the rank's ``d_inner`` channels and
``out_proj`` its rows; ``in_b``, ``in_c``, ``in_dt``, the B/C convs,
``A_log``, ``D`` and ``dt_bias`` are whole and computed whole. Where the
heads divide, the channels are whole heads: the SSD runs on the rank's
``H/k`` heads (B4 unchanged in prefill and decode, ``ssd_chunked`` in
training) with its heads of the state at rest (``cache_specs``), each head
reading its own group's B and C; else the channels are gathered and the SSD
runs whole, as the state is held (JAX's fallback). ``gnorm`` is one RMSNorm
over all of ``d_inner``: its sum of squares is summed over the axis first.
Whole ``ff`` leaves (one device, or ``d_inner`` indivisible) run whole. The
collectives are ``launch/mesh.py``'s autograd ones, the identity with no
model axis; a tensor every rank holds alike (the normed input, B, C, dt)
enters the rank's region through ``enter``, so the train step's backward
comes with the forward.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.ssd import ssd_chunked
from repro_torch.distribution.sharding import model_group
from repro_torch.kernels.ssd.ops import ssd
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.layers import dense_init

_EPS = 1e-6  # layers.rmsnorm's


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


def _group(cfg, params):
    """The model axis the mixer's "ff" leaves are sharded over, or None:
    no model axis, or whole leaves (``d_inner`` indivisible), which every
    rank computes alike."""
    group = model_group()
    return None if params["in_x"].shape[-1] == cfg.d_inner else group


def _heads(cfg, group) -> Tuple[int, int]:
    """``(h0, n)``: the heads whose SSD this rank runs: its own ``H/k``
    where the heads divide the axis, else all ``H`` (its channels split
    heads; the state is whole)."""
    H = cfg.ssm_heads
    if group is None or H % group.size:
        return 0, H
    n = H // group.size
    return group.index * n, n


def _whole_parts(params, cfg, x: torch.Tensor, tail_b=None, tail_c=None, impl="shift"):
    """The mixer's products of its whole leaves, alike on every rank: the
    convolved B and C (with their new tails), dt = softplus(x @ in_dt +
    dt_bias) and A, in fp32."""
    dt = _softplus((x @ params["in_dt"]).float() + params["dt_bias"])
    bi, tail_b = _causal_conv(x @ params["in_b"], params["conv_b"], tail_b, impl=impl)
    ci, tail_c = _causal_conv(x @ params["in_c"], params["conv_c"], tail_c, impl=impl)
    return bi, ci, dt, -torch.exp(params["A_log"]), tail_b, tail_c


def _own_in(params, x: torch.Tensor, group):
    """z and x on the rank's channels (all of them without a model axis)."""
    xr = mesh_lib.enter(x, group)
    return xr @ params["in_z"], xr @ params["in_x"]


def _ssd_operands(params, cfg, xi, bi, ci, dt, A, heads, group):
    """The SSD's operands of heads ``heads`` inside the rank's region: the
    rank's convolved channels ``xi`` (B, S, d_inner / k) as (B, S, n, P)
    (or gathered whole), and the heads' slices of dt, A, D and of B, C
    (entered: every rank holds them whole): their groups where the heads
    fall on whole groups or inside one, else each head its group's (G = n)."""
    B, S = xi.shape[:2]
    G, N, H, P = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    h0, n = heads
    if n == H:
        xi = mesh_lib.enter(mesh_lib.gather(xi, group), group)
    bi, ci, dt, A, D = (mesh_lib.enter(t, group) for t in (bi, ci, dt, A, params["D"]))
    bi, ci = bi.reshape(B, S, G, N), ci.reshape(B, S, G, N)
    per = H // G
    if n % per == 0 or per % n == 0:
        g0, g1 = h0 // per, max(h0 // per + 1, (h0 + n) // per)
        bi, ci = bi[:, :, g0:g1], ci[:, :, g0:g1]
    else:  # the rank's heads split groups
        idx = torch.arange(h0, h0 + n, device=bi.device) // per
        bi, ci = bi.index_select(2, idx), ci.index_select(2, idx)
    return (xi.reshape(B, S, n, P), dt[..., h0:h0 + n].contiguous(), A[h0:h0 + n].contiguous(),
            bi, ci, D[h0:h0 + n].contiguous())


def _gate_out(params, cfg, y: torch.Tensor, z: torch.Tensor, group) -> torch.Tensor:
    """``rmsnorm(gnorm, y * silu(z)) @ out_proj`` on the rank's channels:
    the sum of squares over all of d_inner summed over the axis, the rank's
    ``gnorm`` channels and ``out_proj`` rows, the products combined. ``y``
    is the SSD output (the rank's channels taken from it when it is
    whole)."""
    B, S = y.shape[:2]
    y = y.reshape(B, S, -1)
    di = z.shape[-1]
    if y.shape[-1] != di:
        lo = group.index * di
        y = y[..., lo:lo + di]
    u = y * F.silu(z)
    uf = u.float()
    ss = mesh_lib.enter(mesh_lib.combine(torch.sum(uf * uf, dim=-1, keepdim=True), group), group)
    u = (uf * torch.rsqrt(ss / cfg.d_inner + _EPS) * params["gnorm"].float()).to(u.dtype)
    return mesh_lib.combine(u @ params["out_proj"], group)


def mamba_apply(params, cfg, x: torch.Tensor, *, engine: Optional[str] = None) -> torch.Tensor:
    """Train/prefill path without caches (the training forward). x: (B, S, d)."""
    group = _group(cfg, params)
    heads = _heads(cfg, group)
    S = x.shape[1]
    bi, ci, dt, A, _, _ = _whole_parts(params, cfg, x, impl=cfg.conv_impl)
    z, xi = _own_in(params, x, group)
    xi, _ = _causal_conv(xi, params["conv_x"], impl=cfg.conv_impl)
    y = ssd_chunked(
        *_ssd_operands(params, cfg, xi, bi, ci, dt, A, heads, group),
        chunk=min(cfg.ssd_chunk, S),
        engine=engine or ("associative" if cfg.scan_engine == "pallas" else cfg.scan_engine),
        intra_dtype=torch.bfloat16 if cfg.ssd_intra_dtype == "bfloat16" else None,
    )
    return _gate_out(params, cfg, y, z, group)


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
    tails; writes the state after the prompt (the rank's heads of it under
    a model axis) and the new tails into ``cache`` in place."""
    group = _group(cfg, params)
    heads = _heads(cfg, group)
    S = x.shape[1]
    bi, ci, dt, A, tail_b, tail_c = _whole_parts(params, cfg, x, impl=cfg.conv_impl)
    z, xi = _own_in(params, x, group)
    xi, tail_x = _causal_conv(xi, params["conv_x"], impl=cfg.conv_impl)
    y, _ = ssd(*_ssd_operands(params, cfg, xi, bi, ci, dt, A, heads, group),
               chunk=min(cfg.ssd_chunk, S), state_out=cache["ssm"])
    for key, tail in (("conv_x", tail_x), ("conv_b", tail_b), ("conv_c", tail_c)):
        cache[key].copy_(tail)
    return _gate_out(params, cfg, y, z, group), cache


def mamba_decode(params, cfg, x: torch.Tensor, cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """x: (B, 1, d). O(1) per-token decode: the conv tails and the SSM state
    of ``cache`` are updated in place."""
    group = _group(cfg, params)
    heads = _heads(cfg, group)
    bi, ci, dt, A, tail_b, tail_c = _whole_parts(params, cfg, x, cache["conv_b"],
                                                 cache["conv_c"])
    z, xi = _own_in(params, x, group)
    xi, tail_x = _causal_conv(xi, params["conv_x"], cache["conv_x"])
    y, _ = ssd(*_ssd_operands(params, cfg, xi, bi, ci, dt, A, heads, group),
               initial_state=cache["ssm"], chunk=1, state_out=cache["ssm"])
    for key, tail in (("conv_x", tail_x), ("conv_b", tail_b), ("conv_c", tail_c)):
        cache[key].copy_(tail)
    return _gate_out(params, cfg, y, z, group), cache
