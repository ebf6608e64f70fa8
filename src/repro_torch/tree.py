"""Trees of the port: nested dicts (and NamedTuples of them) of tensors, the
port's form of JAX's pytrees. ``None`` is an empty subtree, as in JAX, and
dict keys are visited in sorted order, as ``jax.tree_util`` visits them, so
leaf lists and leaf paths come out in the JAX package's order."""
from __future__ import annotations

from typing import Any, List, Tuple


def tree_map(fn, *trees):
    """``fn`` over the leaves of trees of dicts with the first tree's keys; a
    ``None`` leaf stays ``None``."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    return None if first is None else fn(*trees)


def flatten_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` pairs in JAX's order; a path joins dict keys and
    NamedTuple field names with ``/`` (``params/layers/cell/w``,
    ``opt/step``), as ``repro/checkpoint/manager.py::_flatten_with_paths``
    does."""
    join = (lambda k: f"{prefix}/{k}") if prefix else str
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in flatten_with_paths(tree[k], join(k))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [pl for k in tree._fields for pl in flatten_with_paths(getattr(tree, k), join(k))]
    return [(prefix, tree)]


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in JAX's order."""
    return [leaf for _, leaf in flatten_with_paths(tree)]


def unflatten_like(tree, leaves):
    """A tree of ``tree``'s structure holding ``leaves`` (in JAX's order)."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(build(getattr(t, k)) for k in t._fields))
        return next(it)

    return build(tree)
