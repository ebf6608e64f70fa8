"""The contract ledger of the port (``CONTRACTS_TORCH.json``):
``repro/analysis/contracts.py`` for PyTorch on the H100.

For every registered paper-RNN config (``configs/paper_rnn.py``, each with
its own ``scan_engine``) this derives, without launching anything, the six
serving steps the continuous-batching ``Scheduler`` holds as CUDA graphs
(lane reset, chunk prefill, masked decode, speculative verify at the
canonical ``SPEC_K``, lane snapshot, lane inject; ``training/steps.py``), run
once each on the meta device at batch 8 and the config's chunk:

  * **kernel instances**: every kernel call the step makes, with the
    instance its wrapper would launch (``analysis/smem.py``: threads, grid,
    cluster, dynamic and static shared memory, registers, CTAs per SM, from
    the kernel's H100 model), each held to :data:`smem.SMEM_CEILING` with
    one CTA or more resident per SM, and the launches by kernel;
  * **collectives** (``analysis/fingerprint.py``): by op and size class, and
    the weight-sized all-gathers, which must be 0 in decode (the slabs stay
    sharded at rest);
  * **the in-place count**: the cache leaves the step writes into their own
    storage, the port's form of JAX's donated buffers;
  * **the trace set**: the signatures a Scheduler captures, in JAX's own
    string format (:func:`tick_trace_set`): exactly six fixed-shape steps,
    so a Scheduler captures its graphs once and never again.

The ``-ring`` and ``-stacked-int8`` configs (``ring_overlap``) derive as
rank (0, 0) of ``launch/mesh.py::virtual_mesh({"data": 1, "model": 8})``,
the mesh JAX derives them on; the others on one device.

``build_contracts`` emits the ledger; ``diff_contracts`` compares a committed
ledger with a derived one and returns named violations
(``decode-weight-allgather[arch]``, ``smem-ceiling[arch/step/kernel]``, ...),
the ids the CLI prints and the regression tests assert on.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

VERSION = 1

#: Canonical speculative block width, JAX's (``repro/analysis/contracts.py``).
SPEC_K = 4

#: The serving slot count of the ledger, JAX's default.
BATCH = 8

#: The model axis the ``ring_overlap`` configs derive under (JAX: its 8
#: virtual devices).
MODEL_SHARDS = 8

STEP_NAMES = ("reset", "prefill", "decode", "verify", "snapshot", "inject")

#: The arguments of each step, by name, as the Scheduler passes them.
STEP_ARGS = {
    "reset": ("caches", "mask"),
    "prefill": ("params", "caches", "tokens", "mask"),
    "decode": ("params", "caches", "tokens", "mask"),
    "verify": ("params", "caches", "tokens", "mask"),
    "snapshot": ("caches", "lane"),
    "inject": ("caches", "lane", "state"),
}

#: Each step's dtype name in JAX's signatures. Token ids and lanes are int32
#: there (x64 off) and int64 in the port (torch's index dtype); the ledger
#: names both as JAX does, so the two ledgers compare string for string.
_JAX_DTYPES = {"int64": "int32", "int32": "int32", "bool": "bool"}


@dataclass(frozen=True)
class Violation:
    rule: str      # e.g. "decode-weight-allgather[sru-paper-large-stacked-ring]"
    message: str

    def format(self) -> str:
        return f"{self.rule}: {self.message}"


# ---------------------------------------------------------------------------
# Signatures
# ---------------------------------------------------------------------------


def tick_trace_set(cfg, batch: int, chunk: int) -> List[str]:
    """The complete signature set a Scheduler captures, in JAX's format:
    the six fixed-shape steps (snapshot and inject take a lane tensor, so
    one signature serves every lane; verify one ``(B, SPEC_K)`` chunk)."""
    return [
        f"reset(caches, mask[{batch}]bool)",
        f"prefill(params, caches, tokens[{batch},{chunk}]int32, mask[{batch}]bool)",
        f"decode(params, caches, tokens[{batch},1]int32, mask[{batch}]bool)",
        f"verify(params, caches, tokens[{batch},{SPEC_K}]int32, mask[{batch}]bool)",
        "snapshot(caches, lane[]int32)",
        "inject(caches, lane[]int32, state)",
    ]


def step_signature(step: str, args) -> str:
    """The signature of one call of ``step`` (a key of :data:`STEP_ARGS`) on
    ``args``, in :func:`tick_trace_set`'s format: the params, caches and
    state by name, the other tensors with their shape and dtype."""
    parts = []
    for name, arg in zip(STEP_ARGS[step], args):
        if name in ("params", "caches", "state"):
            parts.append(name)
        else:
            dtype = str(arg.dtype).replace("torch.", "")
            parts.append(f"{name}[{','.join(str(n) for n in arg.shape)}]"
                         f"{_JAX_DTYPES.get(dtype, dtype)}")
    return f"{step}({', '.join(parts)})"


def step_of(fn) -> Optional[str]:
    """The step a function built by ``training/steps.py`` is (its inner
    def's name, ``decode_step`` ...), or None for any other (the draft
    block)."""
    name = getattr(fn, "__name__", "")
    step = name[:-len("_step")] if name.endswith("_step") else None
    return step if step in STEP_ARGS else None


# ---------------------------------------------------------------------------
# Derivation
# ---------------------------------------------------------------------------


def _slab_elems_per_layer(cfg) -> int:
    """Element count of one layer's gate-slab weights: the threshold base
    for weight-sized all-gathers (ops >= 1/4 of it), JAX's."""
    d, h = cfg.d_model, cfg.rnn_hidden
    if cfg.cell == "qrnn":
        return 2 * d * 3 * h  # two conv taps
    if cfg.cell == "lstm":
        return d * 4 * h
    return d * 3 * h  # sru


def _mesh_for(cfg):
    """The serving mesh of the ledger: rank (0, 0) of (data 1, model 8) for
    the ``ring_overlap`` configs, as JAX's ``_mesh_for`` gives them its 8
    devices; one device for the others."""
    from repro_torch.launch.mesh import virtual_mesh

    if not cfg.ring_overlap or cfg.rnn_hidden % MODEL_SHARDS:
        return None
    return virtual_mesh({"data": 1, "model": MODEL_SHARDS})


def _params(cfg, mesh):
    """``lm_init``'s params on meta, under ``mesh`` the rank's shards of
    them (``launch/serve.py::shard_params``'s specs)."""
    import torch

    from repro_torch.configs import shapes
    from repro_torch.distribution import fused_sharded
    from repro_torch.distribution.sharding import local_shape
    from repro_torch.tree import tree_map

    params = shapes.param_shapes(cfg)
    if mesh is None:
        return params
    specs = fused_sharded.rank_specs(cfg, fused_sharded.serving_param_specs(params, mesh), mesh)
    return tree_map(lambda x, spec: torch.empty(local_shape(x.shape, spec, mesh), dtype=x.dtype,
                                                device="meta"), params, specs)


def _writes_mode():
    """A dispatch mode that collects the storages its ops write in place
    (``.written``)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Writes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.written = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func._schema.is_mutable:
                pos = 0
                for a in func._schema.arguments:
                    if a.kwarg_only or pos >= len(args):
                        value = kwargs.get(a.name)
                    else:
                        value, pos = args[pos], pos + 1
                    if a.alias_info is None or not a.alias_info.is_write:
                        continue
                    for t in value if isinstance(value, (list, tuple)) else [value]:
                        if isinstance(t, torch.Tensor):
                            self.written.add(t.untyped_storage()._cdata)
            return func(*args, **kwargs)

    return _Writes()


def _run_step(fn, args, caches, mesh, weight_elems: int):
    """``fn(*args)`` on meta, recorded: ``(its record, what it returned)``."""
    import contextlib

    from repro_torch.analysis import fingerprint as fp
    from repro_torch.analysis import smem
    from repro_torch.kernels.common import recorded_kernel_calls
    from repro_torch.launch.mesh import recorded_collectives

    writes = _writes_mode()
    log_ctx = recorded_collectives(mesh) if mesh is not None else contextlib.nullcontext([])
    with recorded_kernel_calls() as calls, log_ctx as log, writes:
        out = fn(*args)
    rec = fp.fingerprint(log, weight_elems=weight_elems)
    rec["in_place"] = fp.in_place_count(caches, writes.written)
    rec["launches"] = smem.launches(calls)
    rec["instances"] = smem.instances(calls)
    return rec, out


def derive_arch(cfg, *, log: Optional[Callable] = None) -> Dict:
    """One ledger entry, on the meta device (shapes in, records out)."""
    import torch

    from repro_torch.training import steps

    batch, chunk = BATCH, int(cfg.mts_block_size)
    mesh = _mesh_for(cfg)
    params = _params(cfg, mesh)
    caches = steps.build_cache_init(cfg, mesh, batch=batch, device="meta")()

    def ids(*shape, dtype=torch.int64):
        return torch.zeros(shape, dtype=dtype, device="meta")

    mask, lane = ids(batch, dtype=torch.bool), ids()
    jobs = (
        ("reset", steps.build_lane_reset(cfg, mesh), (caches, mask)),
        ("prefill", steps.build_chunk_prefill_step(cfg, mesh, chunk=chunk),
         (params, caches, ids(batch, chunk), mask)),
        ("decode", steps.build_masked_decode_step(cfg, mesh), (params, caches, ids(batch, 1), mask)),
        ("verify", steps.build_verify_step(cfg, mesh, chunk=SPEC_K),
         (params, caches, ids(batch, SPEC_K), mask)),
        ("snapshot", steps.build_lane_snapshot(cfg, mesh, batch=batch), (caches, lane)),
    )
    weight_elems = _slab_elems_per_layer(cfg)
    out: Dict[str, Dict] = {}
    signatures = []
    for name, fn, args in jobs:
        if log:
            log(f"  {cfg.name}: {name} step on meta")
        out[name], result = _run_step(fn, args, caches, mesh, weight_elems)
        signatures.append(step_signature(name, args))
    state = result  # the snapshot's, injected back as the Scheduler does
    inject = (caches, lane, state)
    out["inject"], _ = _run_step(steps.build_lane_inject(cfg, mesh, batch=batch), inject, caches,
                                 mesh, weight_elems)
    signatures.append(step_signature("inject", inject))
    if signatures != tick_trace_set(cfg, batch, chunk):
        raise AssertionError(f"{cfg.name}: the steps' signatures {signatures} are not the "
                             "trace set's")
    return {
        "engine": cfg.scan_engine,
        "cell": cfg.cell,
        "family": cfg.family,
        "fuse_depth": bool(cfg.fuse_depth),
        "ring_overlap": bool(cfg.ring_overlap),
        "batch": batch,
        "chunk": chunk,
        "mesh": dict(mesh.shape) if mesh is not None else None,
        "steps": out,
        "trace_set": signatures,
        "trace_count": len(signatures),
    }


def registered_rnn_configs() -> List:
    """Every registered RNN config: the ledger's coverage universe."""
    from repro_torch.configs.registry import REGISTRY

    return [cfg for cfg in REGISTRY.values() if cfg.cell is not None]


def build_contracts(*, log: Optional[Callable] = None) -> Dict:
    archs: Dict[str, Dict] = {}
    for cfg in registered_rnn_configs():
        if log:
            log(f"deriving {cfg.name} (engine={cfg.scan_engine})")
        archs[cfg.name] = derive_arch(cfg, log=log)
    return {"version": VERSION, "device": "meta", "model_shards": MODEL_SHARDS,
            "archs": dict(sorted(archs.items()))}


def dumps(ledger: Dict) -> str:
    """The ledger as committed: sorted keys, two-space indent, one newline
    at the end (byte-stable from run to run)."""
    return json.dumps(ledger, indent=2, sort_keys=True) + "\n"


# ---------------------------------------------------------------------------
# Diff: committed vs derived -> named violations
# ---------------------------------------------------------------------------


def _diff_steps(name: str, com: Dict, der: Dict, out: List[Violation]) -> None:
    from repro_torch.analysis import smem

    com_steps, der_steps = com.get("steps", {}), der.get("steps", {})
    for step in STEP_NAMES:
        if step not in com_steps:
            out.append(Violation(
                f"ledger-missing-step[{name}/{step}]",
                f"committed entry lost its `{step}` contract; every tick step must stay "
                "covered: regenerate CONTRACTS_TORCH.json"))
            continue
        if step not in der_steps:
            out.append(Violation(f"ledger-stale-step[{name}/{step}]",
                                 f"analyzer no longer derives `{step}`"))
            continue
        c, d = com_steps[step], der_steps[step]
        if step == "decode":
            if c.get("weight_allgathers", 0) != 0:
                out.append(Violation(
                    f"decode-weight-allgather[{name}]",
                    f"committed ledger records {c.get('weight_allgathers')} weight-sized "
                    "all-gathers in decode; the sharded-at-rest contract requires 0: this "
                    "ledger must never be committed"))
            elif d.get("weight_allgathers", 0) != 0:
                out.append(Violation(
                    f"decode-weight-allgather[{name}]",
                    f"decode step now all-gathers {d.get('weight_allgathers')} weight-sized "
                    "operand(s); gate slabs must stay sharded at rest "
                    "(distribution/fused_sharded.py)"))
        if (c.get("collectives") != d.get("collectives")
                or c.get("collective_count") != d.get("collective_count")):
            out.append(Violation(
                f"collective-fingerprint[{name}/{step}]",
                f"collective mix changed: committed {c.get('collectives')} "
                f"(n={c.get('collective_count')}), derived {d.get('collectives')} "
                f"(n={d.get('collective_count')})"))
        if c.get("in_place") != d.get("in_place"):
            out.append(Violation(
                f"in-place[{name}/{step}]",
                f"cache leaves written in place changed: committed {c.get('in_place')}, "
                f"derived {d.get('in_place')}; writing into the pool's own buffers is what "
                "keeps the graphs' addresses and tick memory fixed"))
        if c.get("launches") != d.get("launches"):
            out.append(Violation(
                f"kernel-launches[{name}/{step}]",
                f"our kernels' launches changed: committed {c.get('launches')}, derived "
                f"{d.get('launches')}"))
        for inst in d.get("instances", []):
            if not smem.fits(inst):
                out.append(Violation(
                    f"smem-ceiling[{name}/{step}/{inst['kernel']}]",
                    f"kernel instance needs {smem.smem_bytes(inst)} B of shared memory a CTA "
                    f"({inst['ctas_per_sm']} resident a SM) against the H100's "
                    f"{smem.SMEM_CEILING} B a CTA"))
        if c.get("instances") != d.get("instances"):
            out.append(Violation(
                f"smem-budget[{name}/{step}]",
                f"kernel instance set changed ({len(c.get('instances', []))} committed vs "
                f"{len(d.get('instances', []))} derived, or an instance's resources "
                "drifted); review and regenerate CONTRACTS_TORCH.json"))


def diff_contracts(committed: Dict, derived: Dict) -> List[Violation]:
    """Pure comparison, so the regression tests can tamper with either side
    and assert on the violation id that comes out."""
    out: List[Violation] = []
    if committed.get("version") != derived.get("version"):
        out.append(Violation(
            "ledger-version",
            f"committed version {committed.get('version')} != analyzer version "
            f"{derived.get('version')}; regenerate CONTRACTS_TORCH.json"))
    com_archs: Dict = committed.get("archs", {})
    der_archs: Dict = derived.get("archs", {})
    for name in sorted(der_archs):
        if name not in com_archs:
            out.append(Violation(
                f"ledger-missing-arch[{name}]",
                "registered config has no committed contract entry; regenerate "
                "CONTRACTS_TORCH.json (python -m repro_torch.analysis contracts --emit)"))
    for name in sorted(com_archs):
        if name not in der_archs:
            out.append(Violation(
                f"ledger-stale-arch[{name}]",
                "committed contract for a config that is no longer registered; "
                "regenerate CONTRACTS_TORCH.json"))
    for name in sorted(set(com_archs) & set(der_archs)):
        com, der = com_archs[name], der_archs[name]
        for key in ("engine", "cell", "batch", "chunk", "mesh"):
            if com.get(key) != der.get(key):
                out.append(Violation(
                    f"ledger-meta[{name}/{key}]",
                    f"{key} changed: committed {com.get(key)!r} vs derived {der.get(key)!r}"))
        if (com.get("trace_set") != der.get("trace_set")
                or com.get("trace_count") != der.get("trace_count")):
            out.append(Violation(
                f"trace-set[{name}]",
                f"serving trace set changed: committed {com.get('trace_count')} signatures "
                f"{com.get('trace_set')}, derived {der.get('trace_count')} "
                f"{der.get('trace_set')}: a new shape in the tick means the Scheduler "
                "captures again mid-traffic"))
        _diff_steps(name, com, der, out)
    return out


def check_contracts(committed: Dict, *, log: Optional[Callable] = None) -> List[Violation]:
    """Re-derive and diff (the ``--check`` path)."""
    return diff_contracts(committed, build_contracts(log=log))
