"""Prefix-sharing state cache, the port's copy of
``repro/serving/prefix_cache.py``: a trie of snapshotted RNN stack states.

The paper's serving advantage compounds here: because an RNN stream's whole
state is one fixed-size ``(L, ...)`` lane slice (not a length-proportional KV
cache), a shared prompt prefix can be cached as a SINGLE snapshot — admitting
a request whose prompt extends a cached prefix becomes one
``rnn_cache_inject_lane`` plus chunk-prefill of only the uncached tail.

Keying and cadence
------------------
Snapshots are only taken at prefill *chunk boundaries* (the engine captures a
lane's state right after a chunk step commits, via ``build_lane_snapshot``),
so every cached state sits at a position that is a multiple of ``chunk`` and
the trie can key on whole chunk segments: a node at depth ``d`` is the prompt
prefix ``prompt[: d * chunk]``, and its edge key is the raw bytes of segment
``d``. Lookup walks matching segments and returns the DEEPEST node holding a
state whose boundary is strictly less than the prompt length — at least one
tail token must remain, because the next-token logits at the boundary are not
cached, only the recurrent state.

Eviction
--------
States live on the host as trees of CPU tensors (device buffers are copied
out once, asynchronously, when the engine dispatches the snapshot, and waited
for when it retires that tick). An LRU over
state-holding nodes enforces a byte budget: ``lookup`` hits refresh recency,
``insert`` evicts cold entries until the new state fits, and nodes left both
stateless and childless are pruned from the trie. A state larger than the
whole budget is refused outright rather than flushing the cache for it.

Correctness
-----------
A snapshot at boundary ``b`` is produced by the same chunk-step computation a
cold prefill of ``prompt[:b]`` runs from a zeroed lane, and lane state is
independent of lane index and co-resident streams (the slot-isolation
property the engine tests pin down). Inject therefore reproduces the cold
path bitwise for SRU (<= 1e-6 for QRNN under the fused engines), which is the
bar the JAX package's ``tests/test_prefix_cache.py`` asserts per engine and
``tests/test_torch_engine.py`` asserts in the port.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def state_nbytes(state) -> int:
    """Host byte footprint of one snapshot: the sum of its leaves' sizes,
    tensors and numpy arrays alike."""
    return sum(leaf.numel() * leaf.element_size() if isinstance(leaf, torch.Tensor)
               else int(np.asarray(leaf).nbytes) for leaf in _leaves(state))


class _Node:
    """One chunk-aligned prefix. ``state`` is None for interior path nodes."""

    __slots__ = ("parent", "seg", "children", "state", "nbytes")

    def __init__(self, parent: Optional["_Node"], seg: bytes):
        self.parent = parent
        self.seg = seg                       # edge key from parent (chunk bytes)
        self.children: Dict[bytes, "_Node"] = {}
        self.state: Any = None
        self.nbytes = 0


class PrefixCache:
    """LRU byte-budgeted trie of chunk-boundary stack-state snapshots."""

    def __init__(self, *, chunk: int, budget_bytes: int):
        if chunk < 1:
            raise ValueError("chunk must be >= 1")
        self.chunk = int(chunk)
        self.budget_bytes = int(budget_bytes)
        self.used_bytes = 0
        self.hits = 0
        self.misses = 0
        self.inserted = 0
        self.evicted = 0
        self._root = _Node(None, b"")
        # prefix bytes -> state-holding node; order = recency (MRU at the end).
        self._lru: "OrderedDict[bytes, _Node]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._lru)

    # -- keying --------------------------------------------------------------

    def _segments(self, prefix: np.ndarray):
        p = np.asarray(prefix, dtype=np.int32)
        for d in range(p.size // self.chunk):
            yield p[d * self.chunk : (d + 1) * self.chunk].tobytes()

    # -- queries -------------------------------------------------------------

    def lookup(self, prompt: np.ndarray) -> Tuple[int, Optional[Any]]:
        """Deepest usable cached boundary for ``prompt``.

        Returns ``(boundary, state)`` with ``0 < boundary < len(prompt)`` and
        ``boundary % chunk == 0`` on a hit, else ``(0, None)``. The strict
        ``< len(prompt)`` cap leaves the engine at least one tail token to
        prefill (its logits seed the stream's first sample).
        """
        prompt = np.asarray(prompt, dtype=np.int32)
        node, depth = self._root, 0
        best: Tuple[int, Optional[_Node]] = (0, None)
        for seg in self._segments(prompt):
            child = node.children.get(seg)
            if child is None:
                break
            node, depth = child, depth + 1
            boundary = depth * self.chunk
            if node.state is not None and boundary < prompt.size:
                best = (boundary, node)
        boundary, hit = best
        if hit is None:
            self.misses += 1
            return 0, None
        key = prompt[:boundary].tobytes()
        self._lru.move_to_end(key)
        self.hits += 1
        return boundary, hit.state

    def wants(self, prefix: np.ndarray) -> bool:
        """True if snapshotting this chunk-aligned prefix would add an entry
        (the engine checks before paying the extract + fetch cost)."""
        prefix = np.asarray(prefix, dtype=np.int32)
        if self.budget_bytes <= 0 or prefix.size == 0 or prefix.size % self.chunk:
            return False
        node = self._root
        for seg in self._segments(prefix):
            node = node.children.get(seg)
            if node is None:
                return True
        return node.state is None

    # -- mutation ------------------------------------------------------------

    def insert(self, prefix: np.ndarray, state) -> bool:
        """Store ``state`` (a host tree of tensors or numpy arrays) at a chunk-aligned prefix,
        evicting LRU entries to stay under budget. False = refused (oversized
        state or misaligned prefix)."""
        prefix = np.asarray(prefix, dtype=np.int32)
        if prefix.size == 0 or prefix.size % self.chunk:
            return False
        nbytes = state_nbytes(state)
        if nbytes > self.budget_bytes:
            return False
        node = self._root
        for seg in self._segments(prefix):
            child = node.children.get(seg)
            if child is None:
                child = _Node(node, seg)
                node.children[seg] = child
            node = child
        key = prefix.tobytes()
        if node.state is not None:           # overwrite: re-account, refresh
            self.used_bytes -= node.nbytes
        node.state = state
        node.nbytes = nbytes
        self.used_bytes += nbytes
        self._lru[key] = node
        self._lru.move_to_end(key)
        self.inserted += 1
        while self.used_bytes > self.budget_bytes and len(self._lru) > 1:
            cold_key, _ = next(iter(self._lru.items()))
            if cold_key == key:              # never evict the entry just added
                self._lru.move_to_end(key)
                continue
            self._evict(cold_key)
        return True

    def _evict(self, key: bytes) -> None:
        node = self._lru.pop(key)
        self.used_bytes -= node.nbytes
        node.state, node.nbytes = None, 0
        self.evicted += 1
        while node.parent is not None and node.state is None and not node.children:
            del node.parent.children[node.seg]
            node = node.parent

    # -- reporting -----------------------------------------------------------

    def report(self) -> Dict:
        return {
            "chunk": self.chunk,
            "budget_bytes": self.budget_bytes,
            "used_bytes": self.used_bytes,
            "entries": len(self._lru),
            "hits": self.hits,
            "misses": self.misses,
            "inserted": self.inserted,
            "evicted": self.evicted,
        }
