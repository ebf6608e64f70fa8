"""Compute/communication overlap primitives of the port
(``repro/core/overlap.py``), on one mesh axis (``launch/mesh.py::AxisGroup``).

Row-parallel matmuls (``w`` sharded on the contraction dim) give a partial
result followed by an all-reduce or reduce-scatter, which waits for the whole
GEMM. The ring forms split the GEMM into ``k`` chunk GEMMs interleaved with
ring shifts to the neighbour rank: each shift is started before the chunk
GEMM that does not need it and waited for after, so under NCCL the transfer
runs beside the GEMM (the collective-matmul schedule of Wang et al.,
ASPLOS'23). The chunk GEMMs are plain ``torch.matmul``: JAX computes them in
XLA, outside any kernel of its own.

Every function runs on each rank of the axis, with that rank's operands.
"""
from __future__ import annotations

import torch


def ring_rs_matmul(x: torch.Tensor, w: torch.Tensor, group) -> torch.Tensor:
    """Reduce-scatter(x @ w) over the axis with ring overlap.

    Args:
      x: (..., d_local) — this rank's piece of the contraction dim.
      w: (d_local, O)   — its rows of the weight.
    Returns:
      (..., O // k): this rank's chunk (chunk ``index``) of the summed output.

    The accumulator for chunk c starts at rank c + 1 and walks the ring for
    k - 1 hops, ending at rank c; each rank adds its partial for the chunk in
    hand.
    """
    k, idx = group.size, group.index
    O = w.shape[-1]
    if O % k != 0:
        raise ValueError(f"output dim {O} not divisible by ring size {k}")
    chunk = O // k

    def w_chunk(j):
        return w[..., j * chunk:(j + 1) * chunk]

    acc = x @ w_chunk((idx - 1) % k)
    for s in range(1, k):
        received = group.shift(acc)
        part = x @ w_chunk((idx - s - 1) % k)
        acc = received() + part
    return acc


def ring_ag_matmul(x: torch.Tensor, w: torch.Tensor, group) -> torch.Tensor:
    """``all_gather(x) @ w`` over the axis with ring overlap: the dual of
    :func:`ring_rs_matmul`.

    Args:
      x: (..., c)  — this rank's chunk of the contraction dim (chunk ``index``).
      w: (k*c, O)  — all contraction rows for this rank's output columns.
    Returns:
      (..., O) = sum_j x_chunk_j @ w[j*c:(j+1)*c], the same on every rank up
      to summation order (the ring starts at each rank's own chunk).

    The chunk in hand is sent on before its GEMM, so the next chunk travels
    while this one multiplies. The sharded stack's ring schedule
    (``distribution/fused_sharded.py``) gathers each layer's output this way
    inside the next layer's gate GEMM.
    """
    c = x.shape[-1]
    if w.shape[0] != group.size * c:
        raise ValueError(f"contraction dim {w.shape[0]} != ring {group.size} x chunk {c}")
    return ring_ag_contract(x, lambda buf, j: buf @ w[j * c:(j + 1) * c], group)


def ring_ag_contract(x: torch.Tensor, chunk_product, group) -> torch.Tensor:
    """:func:`ring_ag_matmul` with each chunk's product given as a function:
    ``chunk_product(buf, j)`` is ``buf @ rows block j of the weight``, so a
    caller contracts each block from the operands it holds, without building
    the whole weight (the sharded stack's ring, per tap)."""
    k, idx = group.size, group.index
    buf = x
    acc = None
    for s in range(k):
        # buf holds the chunk made by rank idx - s: rows block (idx - s) mod k
        received = group.shift(buf) if s + 1 < k else None
        part = chunk_product(buf, (idx - s) % k)
        acc = part if acc is None else acc + part
        if received is not None:
            buf = received()
    return acc


def ring_ar_matmul(x: torch.Tensor, w: torch.Tensor, group) -> torch.Tensor:
    """All-reduce(x @ w): the ring reduce-scatter matmul, then an all-gather
    (rank j's piece is chunk j, so the gather is already in order)."""
    return group.all_gather(ring_rs_matmul(x, w, group))


def plain_rs_matmul(x: torch.Tensor, w: torch.Tensor, group) -> torch.Tensor:
    """Unoverlapped baseline: the GEMM, then the sum over the axis, of which
    this rank keeps its chunk (JAX's ``psum_scatter``, tiled)."""
    full = group.all_reduce(x @ w)
    chunk = full.shape[-1] // group.size
    return full[..., group.index * chunk:(group.index + 1) * chunk]
