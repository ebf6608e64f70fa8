"""Sharding rules of the port (``repro/distribution/sharding.py``): logical
axes -> mesh axes, with the divisibility-aware fallback.

A spec is a tuple with one entry per dim: ``None`` (not sharded), a mesh
axis name, or a tuple of axis names; it has the values of JAX's
``PartitionSpec``. Parameters get their specs from JAX's path-pattern rules
(``PARAM_RULES``, first match wins); caches and batches from
``cache_specs`` / ``batch_specs``. A dim is sharded only if its size divides
by the mesh-axis group's size; otherwise it is replicated, and
``describe_replications`` lists it.

:func:`local_shard` is the port's ``device_put`` of a spec: this rank's
slice of a whole leaf. The rank holds only that slice at rest, and
:func:`gather_shard` makes the leaf whole again. :func:`spec_axes` names the
mesh axes a spec shards over: the train step reduces a leaf's gradient, norm
and absmax over exactly those (a leaf replicated on an axis counts once).

Activation hints: ``use_rules`` installs the mesh for the enclosed region,
as in JAX, and the sharded dispatch (:func:`active_mesh`, MoE's
``_moe_shard_map``) reads it; under ``sp=True`` :func:`seq_group` names the
axis the train forward's residual stream is sliced over along its sequence
(``models/lm.py``), where JAX hints ``("batch", "seq", None)``. Without
GSPMD there is no sharding constraint to place, so :func:`shard_hint`
returns its input and :func:`suppress_hints` only clears the rules.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
import re
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.tree import flatten_with_paths

# Logical activation axes. "batch" spans all data-parallel mesh axes.
DEFAULT_LOGICAL = {
    "batch": ("pod", "data"),
    "seq": None,            # sequences replicated by default
    "model": ("model",),
    "ff": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "fsdp": ("data",),
}

_rules_var: contextvars.ContextVar[Optional[dict]] = contextvars.ContextVar(
    "sharding_rules", default=None
)


@contextlib.contextmanager
def use_rules(mesh, logical: Optional[dict] = None, sp: bool = False):
    """Install the mesh and the logical rules for the enclosed region."""
    logical = dict(logical or DEFAULT_LOGICAL)
    if sp:
        logical["seq"] = ("model",)
    tok = _rules_var.set({"mesh": mesh, "logical": logical})
    try:
        yield
    finally:
        _rules_var.reset(tok)


def activation_rules() -> Optional[dict]:
    return _rules_var.get()


MODEL_AXIS = "model"


def active_mesh():
    """The mesh installed by :func:`use_rules` (None outside it)."""
    rules = _rules_var.get()
    return rules["mesh"] if rules else None


def model_shards(mesh) -> int:
    """The size of ``mesh``'s model axis (1 without a mesh or the axis)."""
    return 1 if mesh is None else int(mesh.shape.get(MODEL_AXIS, 1))


def model_group():
    """The active mesh's model-axis group (``launch/mesh.py::AxisGroup``),
    or None: no mesh, or a model axis of one rank."""
    mesh = active_mesh()
    return mesh.axis(MODEL_AXIS) if model_shards(mesh) > 1 else None


def seq_group(seq_len: int):
    """The model-axis group the residual stream's sequence is sliced over
    under the active rules (``use_rules(..., sp=True)``: "seq" resolves to
    "model"), or None: no rules, "seq" replicated, a model axis of one rank,
    or ``seq_len`` not divisible by it (JAX's :func:`_resolve` fallback)."""
    rules = _rules_var.get()
    if rules is None or model_shards(rules["mesh"]) == 1:
        return None
    if _resolve(rules["mesh"], rules["logical"], ("seq",), (seq_len,)) != (MODEL_AXIS,):
        return None
    return rules["mesh"].axis(MODEL_AXIS)


@contextlib.contextmanager
def suppress_hints():
    """Clear the rules inside a manual (per-rank) region, as JAX's does
    inside ``shard_map``."""
    tok = _rules_var.set(None)
    try:
        yield
    finally:
        _rules_var.reset(tok)


def shard_hint(x: torch.Tensor, names: Sequence) -> torch.Tensor:
    """JAX's activation hint; without GSPMD there is nothing to constrain."""
    return x


def _resolve(mesh, logical: dict, names: Sequence, dim_sizes: Sequence[int]) -> tuple:
    """Logical dim names -> a spec. A mesh axis appears at most once: the
    first dim that claims it (and divides evenly) wins; later dims fall back
    to replication."""
    spec: List = []
    used: set = set()
    for name, size in zip(names, dim_sizes):
        axes = None if name is None else logical.get(name)
        if axes is None:
            spec.append(None)
            continue
        if isinstance(axes, str):
            axes = (axes,)
        axes = tuple(a for a in axes if a in mesh.shape and a not in used)
        group = math.prod(mesh.shape[a] for a in axes) if axes else 1
        if axes and size % group == 0:
            spec.append(axes if len(axes) > 1 else axes[0])
            used.update(axes)
        else:
            spec.append(None)
    return tuple(spec)


# ---------------------------------------------------------------------------
# Parameter partition rules (path pattern -> logical dim names), JAX's.
# Patterns match "/"-joined paths (first match of the right arity wins).
# Stacked layer params carry a leading "layers" dim, never sharded.
# ---------------------------------------------------------------------------

PARAM_RULES: List[Tuple[str, Tuple]] = [
    # embeddings / heads (unembed first: ".*embed$" would also match it)
    (r".*unembed$", ("model_embed", "vocab")),
    (r".*embed$", ("vocab", "model_embed")),
    # attention
    (r".*w_qkv$", ("fsdp_opt", "heads_flat")),
    (r".*w_q$", ("fsdp_opt", "heads_flat")),
    (r".*w_kv$", ("fsdp_opt", "kv_flat")),
    (r".*w_o$", ("heads_flat", "fsdp_opt")),
    # dense mlp
    (r".*w_gate$", ("fsdp_opt", "ff")),
    (r".*w_up$", ("fsdp_opt", "ff")),
    (r".*w_down$", ("ff", "fsdp_opt")),
    # moe
    (r".*router$", (None, None)),
    (r".*e_gate$", ("experts_opt", "fsdp_opt", "ff_moe")),
    (r".*e_up$", ("experts_opt", "fsdp_opt", "ff_moe")),
    (r".*e_down$", ("experts_opt", "ff_moe", "fsdp_opt")),
    # mamba
    (r".*in_(z|x)$", ("fsdp_opt", "ff")),
    (r".*in_(b|c|dt)$", ("fsdp_opt", None)),
    (r".*out_proj$", ("ff", "fsdp_opt")),
    (r".*conv_x$", (None, "ff")),
    (r".*conv_(b|c)$", (None, None)),
    (r".*gnorm$", ("ff",)),
    (r".*(A_log|D|dt_bias)$", (None,)),
    # rnn cells: lane-major gate slabs (d, G, H) shard their lane dim
    (r".*(w|w0|w1)$", ("fsdp_opt", None, "ff")),
    # int8 gate slabs and their compact per-gate x per-lane-block scales
    (r".*(wq|w0q|w1q)$", ("fsdp_opt", None, "ff")),
    (r".*wq_scale$", (None, "ff")),
    (r".*(wx|uh)$", ("fsdp_opt", "ff")),  # LSTM stays flat gate-major
    (r".*w_skip$", ("fsdp_opt", "ff")),
    (r".*cell/b$", (None, "ff")),  # (G, H) biases co-located with their lanes
    (r".*cell/b$", ("ff",)),       # LSTM's flat (4H,) bias (arity fallback)
    # norms / biases / scalars
    (r".*", (None,)),
]


def _param_logical(fsdp: bool) -> dict:
    return {
        "vocab": ("model",),
        "model_embed": ("data",) if fsdp else None,
        "heads_flat": ("model",),
        "kv_flat": ("model",),
        "ff": ("model",),
        "ff_moe": ("model",),
        # experts shard over model when the count divides (param_specs)
        "experts_opt": ("model",),
        "fsdp_opt": ("data",) if fsdp else None,
    }


def map_with_paths(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over a tree of dicts, paths joined with ``/`` as
    JAX's ``_path_str`` joins them; a ``None`` leaf stays ``None``."""
    if isinstance(tree, dict):
        return {k: map_with_paths(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    return None if tree is None else fn(prefix, tree)


def spec_for_path(path_s: str, shape: Tuple[int, ...], mesh, logical: dict,
                  stacked: bool) -> tuple:
    dims = list(shape)
    lead: List = []
    if stacked and dims:
        lead, dims = [None], dims[1:]  # the layer-stack dim: never sharded
    for pat, names in PARAM_RULES:
        if re.match(pat, path_s) and len(names) == len(dims):
            return tuple(lead) + _resolve(mesh, logical, names, dims)
    return (None,) * len(shape)


def param_specs(params, mesh, *, fsdp: bool = False):
    """A spec tree mirroring ``params``. Stacked-layer params are found by
    the path prefix ``layers/`` (their leading dim is the layer stack)."""
    logical = _param_logical(fsdp)

    def one(path, leaf):
        stacked = path.startswith("layers/") or "/layers/" in path
        return spec_for_path(path, tuple(leaf.shape), mesh, logical, stacked)

    return map_with_paths(one, params)


def cache_specs(cache_tree, mesh):
    """Specs of the decode caches (leading dim: the stacked layers). KV
    caches prefer their heads; when the KV head count does not divide the
    model axis the sequence dim shards instead. RNN carries ``c``/``h``
    (L, B, H) shard H over "model"; QRNN's ``x_tail`` stays replicated."""
    logical = {
        "batch": ("pod", "data"),
        "kv_heads": ("model",),
        "seq": ("model",),
        "heads": ("model",),
        "ff": ("model",),
    }

    def one(path, leaf):
        name = path.rsplit("/", 1)[-1]
        shape = tuple(leaf.shape)
        nd = len(shape)
        if name in ("k", "v") and nd == 5:
            spec = _resolve(mesh, logical, (None, "batch", None, "kv_heads", None), shape)
            if spec[3] is None:  # kv heads cannot shard: shard the cache's sequence
                spec = _resolve(mesh, logical, (None, "batch", "seq", None, None), shape)
            return spec
        if name == "ssm" and nd == 5:
            return _resolve(mesh, logical, (None, "batch", "heads", None, None), shape)
        if name == "conv_x" and nd == 4:
            return _resolve(mesh, logical, (None, "batch", None, "ff"), shape)
        if name in ("conv_b", "conv_c", "x_tail") and nd == 4:
            return _resolve(mesh, logical, (None, "batch", None, None), shape)
        if name in ("c", "h") and nd == 3:
            return _resolve(mesh, logical, (None, "batch", "ff"), shape)
        return (None,) * nd

    return map_with_paths(one, cache_tree)


def batch_specs(batch_tree, mesh):
    """Shard the leading batch dim of every input over the DP axes."""
    dp = tuple(a for a in ("pod", "data") if a in mesh.shape)

    def one(path, leaf):
        names = ["batch"] + [None] * (leaf.dim() - 1)
        return _resolve(mesh, {"batch": dp}, names, tuple(leaf.shape))

    return map_with_paths(one, batch_tree)


def describe_replications(params, specs) -> List[str]:
    """The dims above 1024 that a spec leaves replicated."""
    notes = []
    for path, leaf in flatten_with_paths(params):  # JAX's leaf order
        spec = _at(specs, path)
        for d, (size, s) in enumerate(zip(leaf.shape, spec)):
            if s is None and size > 1024:
                notes.append(f"{path}[dim{d}={size}] replicated")
    return notes


def _at(tree, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _axes(entry) -> tuple:
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


def shard_index(entry, mesh) -> Tuple[int, int]:
    """``(index, count)`` of this rank's block along a dim whose spec entry
    is ``entry``: the axes' coordinates, row-major in the order listed."""
    index, count = 0, 1
    for a in _axes(entry):
        index = index * mesh.shape[a] + mesh.coords[a]
        count *= mesh.shape[a]
    return index, count


def local_shape(shape, spec, mesh) -> tuple:
    """The shape of this rank's slice of a leaf of ``shape``."""
    return tuple(n // shard_index(s, mesh)[1] if s is not None else n
                 for n, s in zip(shape, spec))


def local_shard(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's slice of the whole leaf ``x`` under ``spec`` (the port's
    ``device_put``): its own storage, so the whole leaf can be freed; ``x``
    itself when nothing is sliced."""
    if mesh.coords is None:
        raise ValueError(f"mesh {mesh.shape} has no ranks to hold shards")
    out = x
    for dim, s in enumerate(spec):
        if s is None:
            continue
        i, k = shard_index(s, mesh)
        n = x.shape[dim]
        if n % k:
            raise ValueError(f"dim {dim} of size {n} does not split over {_axes(s)}")
        out = out.narrow(dim, i * (n // k), n // k)
    return x if out is x else out.clone(memory_format=torch.contiguous_format)


def spec_axes(spec) -> tuple:
    """The mesh axes ``spec`` shards over, in dim order."""
    return tuple(a for e in spec for a in _axes(e))


def replicated_on(spec, axis: str) -> bool:
    """True when a leaf under ``spec`` is whole on every rank of ``axis``."""
    return axis not in spec_axes(spec)


def gather_shard(x: torch.Tensor, spec, mesh):
    """The whole leaf from this rank's shard ``x`` under ``spec`` (the
    inverse of :func:`local_shard`): gathered along each sharded dim over
    its axes, the innermost first. Every rank of those axes must call it,
    leaf for leaf in one order."""
    for dim, entry in enumerate(spec):
        for a in reversed(_axes(entry)):
            if mesh.shape[a] > 1:
                x = mesh.axis(a).all_gather(x, dim)
    return x
