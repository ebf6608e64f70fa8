"""Plain PyTorch versions of the fused SRU/QRNN kernels
(``repro/kernels/fused_rnn/ref.py``: ``fused_rnn_ref``, ``fused_rnn_ref_q``,
``fused_rnn_stack_ref``, ``fused_rnn_stack_ref_q``).

They repeat the kernels' arithmetic step by step: gates in fp32, an fp32
carry, outputs cast to the input dtype, and for the stack an fp32 residual
stream across all layers, cast once at the end. The int8 twins accumulate the
raw int8 values in fp32 and multiply the per-lane scales in after the
accumulate, then add the bias. The CPU path of every kernel wrapper runs
them, and ``chip_smoke.py`` holds the kernels to them on the card.

``scan`` (every function here) is the recurrence, ``(x_hat, f, r, skip, c0)
-> (h, c_last)`` in fp32: by default ``_scan``, step by step as the
kernels walk it. The autograd Functions' backward passes the same
recurrence evaluated by the linear-scan kernel (``ops.py``).
"""
from __future__ import annotations

import torch


def _scan(x_hat, f, r, skip, c0):
    """``c_t = f_t c + (1 - f_t) x_hat_t``; ``h_t = r_t tanh(c_t) [+ (1 - r_t) skip_t]``."""
    c = c0.float()
    hs = []
    for t in range(x_hat.shape[0]):
        c = f[t] * c + (1.0 - f[t]) * x_hat[t]
        h = r[t] * torch.tanh(c)
        if skip is not None:
            h = h + (1.0 - r[t]) * skip[t]
        hs.append(h)
    return torch.stack(hs), c


def _gates(uf, w3, s3, b3):
    """``z = (uf . w3) [* s3] + b3`` in fp32: the scale after the accumulate."""
    z = torch.einsum("tbd,dgh->tbgh", uf, w3.float())
    if s3 is not None:
        z = z * s3.float()
    return z + b3.float()


def fused_rnn_ref(u, w3, b3, wskip, c0, *, mode: str, skip=None, scan=_scan):
    """u: (T, B, d); w3: (d, 3, H); b3: (3, H); c0: (B, H).

    mode: ``sru_identity`` (skip = u, needs d == H, or the given ``skip``
    (T, B, H), a model shard's lane slice of u), ``sru_proj``
    (skip = u @ wskip), ``qrnn`` (tanh on x_hat, no skip term).
    Returns (h, c_last): (T, B, H), (B, H) in u's dtype.
    """
    return _layer(u, w3, None, b3, wskip, c0, mode, skip, scan)


def fused_rnn_ref_q(u, wq, s3, b3, wskip, c0, *, mode: str, skip=None, scan=_scan):
    """Int8 twin of :func:`fused_rnn_ref`. ``wq``: int8 (d, 3, H); ``s3``:
    fp32 per-lane scales (3, H). ``wskip`` stays fp and is not scaled."""
    return _layer(u, wq, s3, b3, wskip, c0, mode, skip, scan)


def _layer(u, w3, s3, b3, wskip, c0, mode, skip, scan):
    uf = u.float()
    z = _gates(uf, w3, s3, b3)
    x_hat = z[..., 0, :]
    if mode == "qrnn":
        x_hat = torch.tanh(x_hat)
    f = torch.sigmoid(z[..., 1, :])
    r = torch.sigmoid(z[..., 2, :])
    if mode == "sru_identity":
        skip = uf if skip is None else skip.float()
    elif mode == "sru_proj":
        skip = uf @ wskip.float()
    else:
        skip = None
    h, c_last = scan(x_hat, f, r, skip, c0)
    return h.to(u.dtype), c_last.to(u.dtype)


def fused_rnn_stack_ref(x, w3L, b3L, lnL, c0L, tailsL, *, cell: str, eps: float = 1e-6,
                        scan=_scan):
    """The depth-fused stack. x: (T, B, d) residual stream; w3L: (L, K, d, 3, H)
    with K = 2 for QRNN (the [w0 ; w1] shifted-input halves); b3L: (L, 3, H);
    lnL: (L, d) pre-norm gains; c0L: (L, B, H); tailsL: (L, B, d) per-layer
    conv carries (NORMED inputs; ignored for SRU). Requires d == H. Each layer
    is pre-norm -> gates -> recurrence -> highway -> residual, all in fp32.
    Returns (y, c_lastL, tails_lastL) in x's dtype; tails_lastL is None for SRU.
    """
    return _stack(x, w3L, None, b3L, lnL, c0L, tailsL, cell, eps, scan)


def fused_rnn_stack_ref_q(x, wqL, sL, b3L, lnL, c0L, tailsL, *, cell: str, eps: float = 1e-6,
                          scan=_scan):
    """Int8 twin of :func:`fused_rnn_stack_ref`. ``wqL``: int8 (L, K, d, 3, H);
    ``sL``: fp32 per-lane scales (L, 3, H), shared by the K taps."""
    return _stack(x, wqL, sL, b3L, lnL, c0L, tailsL, cell, eps, scan)


def _stack(x, w3L, sL, b3L, lnL, c0L, tailsL, cell, eps, scan):
    qrnn = cell == "qrnn"
    xf = x.float()
    c_lasts, new_tails = [], []
    for l in range(w3L.shape[0]):
        g = lnL[l].float()
        ms = torch.mean(xf * xf, dim=-1, keepdim=True)
        u = xf * torch.rsqrt(ms + eps) * g
        if qrnn:
            u_prev = torch.cat([tailsL[l].float()[None], u[:-1]], dim=0)
            new_tails.append(u[-1])
            uu = torch.cat([u, u_prev], dim=-1)
        else:
            uu = u
        w = w3L[l].reshape(-1, 3, w3L.shape[-1])  # (K*d, 3, H)
        z = _gates(uu, w, None if sL is None else sL[l], b3L[l])
        x_hat = torch.tanh(z[..., 0, :]) if qrnn else z[..., 0, :]
        f = torch.sigmoid(z[..., 1, :])
        r = torch.sigmoid(z[..., 2, :])
        h, c_last = scan(x_hat, f, r, None if qrnn else u, c0L[l])
        c_lasts.append(c_last)
        xf = xf + h
    tails_out = torch.stack(new_tails).to(x.dtype) if qrnn else None
    return xf.to(x.dtype), torch.stack(c_lasts).to(x.dtype), tails_out
