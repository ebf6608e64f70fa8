"""Mamba-2 SSD (state-space duality), from ``repro/core/ssd.py``: the
matrix-state generalization of the paper's decomposition.

The paper isolates gates computable from the inputs alone (time-batched
GEMMs) from a cheap first-order recurrence. Chunked SSD has exactly this
structure one rank up: inside a chunk everything is dense products; between
chunks a first-order linear recurrence carries an (N, P) matrix state per
head, evaluated with the ``linear_scan`` engines (``core/scan.py``).

Per head h, step t (scalar-identity A, as in Mamba-2):

    S_t = exp(A_h dt_t) S_{t-1} + dt_t * B_t (x) x_t        (state: N x P)
    y_t = C_t . S_t + D_h x_t

Chunked evaluation with chunk length L:

    Lam_t     = cumsum_within_chunk(A_h dt_t)
    Y_intra   = ((C_t.B_s) * exp(Lam_t - Lam_s) * dt_s)_{s<=t} @ X        (L x L)
    dS_k      = sum_t exp(Lam_L - Lam_t) dt_t B_t (x) x_t                 (N x P)
    S_k       = exp(Lam_L) S_{k-1} + dS_k         <- matrix scan over chunks
    Y_inter   = exp(Lam_t) C_t . S_{k-1}

This module is the plain-PyTorch oracle, as in JAX. The served path runs
the CUDA port of the TPU kernel (``kernels/ssd``) for prefill and decode;
``ssd_chunked`` is its plain version (``kernels/ssd/ref.py``) and the
training forward's mixer (``models/mamba.py::mamba_apply``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.scan import linear_scan
from repro_torch.kernels.common import largest_divisor_leq


def _segsum(log_decay: torch.Tensor) -> torch.Tensor:
    """Stable pairwise sums: out[..., t, s] = sum_{i in (s, t]} log_decay[..., i].

    Lower-triangular; -inf above the diagonal (masked before exp).
    """
    L = log_decay.shape[-1]
    cum = torch.cumsum(log_decay, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=log_decay.device))
    return torch.where(mask, diff, -torch.inf)


def ssd_chunked(
    x: torch.Tensor,      # (B, S, H, P)
    dt: torch.Tensor,     # (B, S, H)  positive
    A: torch.Tensor,      # (H,)       negative
    B_: torch.Tensor,     # (B, S, G, N)
    C_: torch.Tensor,     # (B, S, G, N)
    D: Optional[torch.Tensor] = None,  # (H,)
    *,
    chunk: int = 128,
    initial_state: Optional[torch.Tensor] = None,  # (B, H, N, P)
    engine: str = "associative",
    return_final_state: bool = False,
    intra_dtype: Optional[torch.dtype] = None,
):
    """Full-sequence SSD. Returns y (B,S,H,P) [, final_state (B,H,N,P) fp32].

    ``chunk`` shrinks to the largest divisor of S. ``intra_dtype`` (bf16)
    rounds the intra-chunk operands to that dtype and multiplies them in
    fp32, as JAX's ``preferred_element_type=float32`` products do; decays
    and sums stay fp32. ``engine``: ``sequential``/``chunked`` carry the
    chunk states one by one, anything else goes through ``linear_scan``."""
    Bsz, S, H, P = x.shape
    G, N = B_.shape[-2], B_.shape[-1]
    rep = H // G
    if S % chunk != 0:  # fall back to the largest divisor (callers pad for perf)
        chunk = largest_divisor_leq(S, chunk)
    K = S // chunk
    f32 = torch.float32

    # Broadcast groups to heads and fold dt into the input branch (x * dt).
    Bh = torch.repeat_interleave(B_, rep, dim=2)  # (B, S, H, N)
    Ch = torch.repeat_interleave(C_, rep, dim=2)
    xdt = x.float() * dt.float()[..., None]        # (B, S, H, P)

    def ck(t):  # chunk reshape: (B, K, L, H, ...)
        return t.reshape((Bsz, K, chunk) + tuple(t.shape[2:]))

    xc, dtc, Bc, Cc = ck(xdt), ck(dt.float()), ck(Bh.float()), ck(Ch.float())
    ld = A.float()[None, None, None, :] * dtc      # (B, K, L, H) log-decay
    lam = torch.cumsum(ld, dim=2)                  # Lam_t within chunk
    lam_T = lam[:, :, -1:, :]                      # Lam_L

    def intra(t):
        return t if intra_dtype is None else t.to(intra_dtype).float()

    # --- intra-chunk: scores[b,k,h,t,s] ---
    Cc_i, Bc_i, xc_i = intra(Cc), intra(Bc), intra(xc)
    seg = _segsum(torch.movedim(ld, 2, -1))                    # (B, K, H, L, L)
    cb = torch.einsum("bklhn,bkshn->bkhls", Cc_i, Bc_i)        # (B, K, H, L, L)
    scores = cb * torch.exp(seg)
    scores = torch.where(torch.isfinite(seg), scores, 0.0)
    y_intra = torch.einsum("bkhls,bkshp->bklhp", intra(scores), xc_i)

    # --- chunk state contributions: dS[b,k,h,n,p] ---
    decay_to_end = torch.exp(lam_T - lam)                      # (B, K, L, H)
    dS = torch.einsum("bklhn,bklh,bklhp->bkhnp", Bc_i, intra(decay_to_end), xc_i)

    # --- inter-chunk recurrence (the paper's carry chain, matrix-valued) ---
    chunk_decay = torch.exp(lam_T[:, :, 0, :])                 # (B, K, H)
    S0 = (torch.zeros((Bsz, H, N, P), dtype=f32, device=x.device)
          if initial_state is None else initial_state.float())
    decay_t = torch.movedim(chunk_decay, 1, 0)                 # (K, B, H)
    dS_t = torch.movedim(dS, 1, 0)                             # (K, B, H, N, P)
    if engine in ("sequential", "chunked"):
        # memory-light carry chain: O(state) live memory, K sequential steps
        s, states = S0, []
        for k in range(K):
            s = decay_t[k][..., None, None] * s + dS_t[k]
            states.append(s)
        states = torch.stack(states)
    else:  # associative: O(log K) depth, materializes (K, ...) operands
        a_t = decay_t[..., None, None] * torch.ones_like(dS_t)
        states = linear_scan(a_t, dS_t, S0, engine=engine)     # state AFTER chunk k
    # state BEFORE chunk k:
    prev = torch.movedim(torch.cat([S0[None], states[:-1]], dim=0), 0, 1)  # (B, K, H, N, P)

    y_inter = torch.einsum("bklhn,bkhnp->bklhp", Cc * torch.exp(lam)[..., None], prev)

    y = (y_intra + y_inter).reshape(Bsz, S, H, P)
    if D is not None:
        y = y + x.float() * D.float()[None, None, :, None]
    y = y.to(x.dtype)
    if return_final_state:
        return y, torch.movedim(states, 0, 1)[:, -1].float()
    return y


def ssd_decode_step(
    state: torch.Tensor,  # (B, H, N, P) fp32
    x_t: torch.Tensor,    # (B, H, P)
    dt_t: torch.Tensor,   # (B, H)
    A: torch.Tensor,      # (H,)
    B_t: torch.Tensor,    # (B, G, N)
    C_t: torch.Tensor,    # (B, G, N)
    D: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """O(1) single-token decode: y_t (B,H,P), new state."""
    H = x_t.shape[1]
    G = B_t.shape[1]
    rep = H // G
    Bh = torch.repeat_interleave(B_t, rep, dim=1).float()  # (B, H, N)
    Ch = torch.repeat_interleave(C_t, rep, dim=1).float()
    decay = torch.exp(A.float()[None, :] * dt_t.float())    # (B, H)
    upd = torch.einsum("bhn,bhp->bhnp", Bh, x_t.float() * dt_t.float()[..., None])
    state = decay[..., None, None] * state + upd
    y = torch.einsum("bhn,bhnp->bhp", Ch, state)
    if D is not None:
        y = y + x_t.float() * D.float()[None, :, None]
    return y.to(x_t.dtype), state
