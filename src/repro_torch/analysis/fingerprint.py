"""Collective fingerprints of one step: ``repro/analysis/fingerprint.py``
over the port's collective log instead of compiled HLO text.

A step run under ``launch/mesh.py::recorded_collectives`` logs every
collective it calls, in call order, under JAX's HLO op names
(``all-gather``, ``all-reduce``, ``reduce-scatter``, ``collective-permute``
for a ring shift; ``broadcast`` apart) with its result's bytes and element
count (``mesh.Collective``). The log holds each call once, where JAX's
parser has to count definition sites and fold ``-start``/``-done`` pairs, and
it counts every layer's collectives, where an HLO loop body holds them once
(the ledger's configs unroll their layers in both).

The JAX ledger's donation count becomes the in-place count
(:func:`in_place_count`): the cache leaves a step wrote into their own
storage, the port's form of ``donate_argnums`` (``training/steps.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence

from repro_torch.tree import tree_leaves

#: Collective op names JAX's fingerprint tracks (HLO names).
COLLECTIVE_KINDS = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "collective-permute",
    "all-to-all",
)


@dataclass(frozen=True)
class CollectiveOp:
    kind: str   # an op name of the log (COLLECTIVE_KINDS, or "broadcast")
    elems: int  # element count of the op's result
    bytes: int  # its bytes


def collective_ops(log: Iterable, kinds: Optional[Sequence[str]] = None) -> List[CollectiveOp]:
    """Every logged collective (of ``kinds``, or of every op) with its
    result's size."""
    out = []
    for c in log:
        op, nbytes, _ = c
        if kinds is None or op in kinds:
            out.append(CollectiveOp(kind=op, elems=c.elems, bytes=nbytes))
    return out


def count_ops(log: Iterable, kind: str) -> int:
    """How many collectives of one kind the step called."""
    return len(collective_ops(log, kinds=(kind,)))


def weight_sized_allgathers(log: Iterable, threshold_elems: int) -> List[CollectiveOp]:
    """All-gathers at least ``threshold_elems`` big: the 'a weight slab
    moved' detector. Serving decode must report none: the slabs stay
    sharded at rest and enter the kernels without a per-step gather."""
    return [op for op in collective_ops(log, kinds=("all-gather",))
            if op.elems >= threshold_elems]


# Size classes for the ledger, JAX's labels and thresholds in elements:
# compared string for string in CONTRACTS_TORCH.json diffs.
_SIZE_CLASSES = (
    ("small", 1 << 10),     # < 1Ki elems: control/bookkeeping
    ("medium", 1 << 20),    # < 1Mi elems: activations
    ("large", None),        # >= 1Mi elems: weight-scale
)


def size_class(elems: int) -> str:
    for name, bound in _SIZE_CLASSES:
        if bound is None or elems < bound:
            return name
    return "large"


def in_place_count(caches, written) -> int:
    """How many cache leaves (a tree of dicts of tensors) a step wrote into
    their own storage: ``written`` holds the storages the step's in-place
    ops wrote (``contracts._Writes``)."""
    return sum(1 for t in tree_leaves(caches) if t.untyped_storage()._cdata in written)


def fingerprint(log: Sequence, weight_elems: Optional[int] = None) -> Dict:
    """Structured fingerprint of one step's collectives.

    ``weight_elems``: element count of one full gate-slab layer; all-gathers
    at >= 1/4 of it count as weight-sized (JAX's threshold)."""
    ops = collective_ops(log)
    by_kind: Dict[str, Dict[str, int]] = {}
    for op in ops:
        kinds = by_kind.setdefault(op.kind, {})
        cls = size_class(op.elems)
        kinds[cls] = kinds.get(cls, 0) + 1
    out: Dict = {
        "collectives": {k: dict(sorted(v.items())) for k, v in sorted(by_kind.items())},
        "collective_count": len(ops),
    }
    if weight_elems is not None:
        out["weight_allgathers"] = len(weight_sized_allgathers(log, max(weight_elems // 4, 1)))
    return out
