"""The port's AST lint rules: ``repro/analysis/rules.py`` for PyTorch on the H100.

Each rule checks one invariant the port's serving and kernel story rests on,
under the JAX rule's id wherever the invariant is the same:

  RPL001  captured-tensor-if   Python ``if``/``while`` on a tensor's value
                               inside a step that ``training/graphs.py``
                               captures: a CUDA graph records one branch,
                               and reading the value syncs the card.
  RPL002  captured-host-sync   ``.item()``, ``.cpu()``, ``.tolist()``,
                               ``.numpy()``, ``int()/float()/bool()`` or
                               ``np.*`` of a tensor, or
                               ``torch.cuda.synchronize()``, inside a
                               captured step: a sync a graph cannot hold (the
                               capture fails or freezes one value).
  RPL003  host-item-sync       ``.item()`` in host code: a one-element sync;
                               serving hosts batch their transfers. Warning.
  RPL004  tick-loop-sync       a per-item transfer (``.item()``, ``.cpu()``,
                               ``.tolist()``, ``.numpy()``, ``np.asarray`` /
                               ``np.array``, ``torch.cuda.synchronize()``)
                               inside a loop of a scheduler-tick class (any
                               class defining ``tick``): fetch once per tick.
  RPL005  wall-clock-duration  ``time.time()`` measuring a duration.
  RPL101  layout-bypass        reshape/transpose/view/permute of a
                               lane-major gate slab outside
                               ``repro_torch/kernels/fused_rnn/layout.py``.
  RPL103  dequant-outside-kernel  int8-slab x scale arithmetic outside
                               ``repro_torch/kernels/fused_rnn/``.
  RPL202  plain-fallback       an ``except`` handler that falls back to a
                               kernel's plain version (``*_plain``,
                               ``*_ref``), or a literal that picks the CPU
                               (``device="cpu"``) outside tests: on the card
                               a kernel launches or the call raises.
  RPL301  config-field-unread  an ``ArchConfig`` field of
                               ``repro_torch/configs/base.py`` no code reads.

RPL201 (no HBM-materializing alloc inside a Pallas kernel body) has no AST
counterpart: the port's kernel bodies are CUDA C++. Its counterpart is the
contract ledger's shared-memory budget (``contracts.py``:
``smem-ceiling[arch/step/kernel]``), which :data:`RULE_CATALOG` names.

Captured scopes, the port's counterpart of JAX's jitted scopes: the inner
function a module-level ``build_*`` builder returns (``training/steps.py``'s
step convention; the Scheduler and ``launch/serve.py`` capture exactly
these) and any function handed by name to a ``capture(...)`` call in the same
file. Reads of a tensor's metadata (``.shape``, ``.dtype``, ``.device``,
``.dim()``, ``.numel()`` ...) and identity tests (``is None``) never touch
its value, so they are exempt, as in JAX.

Suppression: append ``# repro-lint: disable=RPL202`` (comma-separated ids,
or ``all``) to the offending line, with the reason in the comment
(``lint.py``).
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple


@dataclass(frozen=True)
class Finding:
    rule_id: str
    severity: str  # "error" | "warning"
    path: str
    line: int
    col: int
    message: str

    def format(self) -> str:
        return (
            f"{self.path}:{self.line}:{self.col}: "
            f"{self.rule_id} [{self.severity}] {self.message}"
        )


@dataclass
class Module:
    """One parsed source file handed to the rules."""

    path: str        # repo-relative, "/"-separated
    tree: ast.AST
    source: str


class Rule:
    """Base: per-file rules implement ``visit``; project-wide rules (which
    need every module before they can decide) implement ``finalize``."""

    rule_id: str = ""
    severity: str = "error"
    description: str = ""

    def visit(self, module: Module) -> List[Finding]:
        return []

    def finalize(self, modules: Sequence[Module]) -> List[Finding]:
        return []

    def _finding(self, module: Module, node: ast.AST, message: str) -> Finding:
        return Finding(
            rule_id=self.rule_id,
            severity=self.severity,
            path=module.path,
            line=getattr(node, "lineno", 0),
            col=getattr(node, "col_offset", 0) + 1,
            message=message,
        )


# ---------------------------------------------------------------------------
# Shared AST helpers
# ---------------------------------------------------------------------------

#: Attributes of a tensor that are its metadata, not its value.
STATIC_ATTRS = {"shape", "dtype", "ndim", "device", "is_cuda", "layout", "requires_grad"}

#: Methods of a tensor that return metadata (Python ints, bools, sizes).
STATIC_METHODS = {"dim", "size", "numel", "stride", "is_contiguous", "element_size",
                  "data_ptr", "untyped_storage"}

#: Calls whose result depends only on a tree's STRUCTURE (dict keys) or a
#: type: a Python bool whatever the values.
STATIC_CALLS = {"is_quantized", "isinstance", "len"}

#: The transfers that read a tensor's value on the host.
SYNC_METHODS = {"item", "cpu", "tolist", "numpy"}


def _dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` -> "a.b.c" for Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _is_capture_expr(node: ast.AST) -> bool:
    """True for ``capture`` / ``graphs.capture`` / ``step_graphs.capture``."""
    name = _dotted(node)
    return name is not None and name.split(".")[-1] == "capture"


def _expr_refs_tensor(node: ast.AST, tensors: Set[str]) -> bool:
    """Does ``node``'s VALUE depend on a tensor's value?

    Metadata reads stop the descent: ``x.shape[0]``, ``x.dtype``,
    ``x.device.type``, ``x.dim()``, ``x.numel()``, ``x is None``,
    ``len(x)``, ``isinstance(x, ...)`` and the ``STATIC_CALLS`` structure
    predicates."""
    if isinstance(node, ast.Attribute) and node.attr in STATIC_ATTRS:
        return False
    if isinstance(node, ast.Compare) and all(
        isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops
    ):
        return False
    if isinstance(node, ast.Call):
        if isinstance(node.func, ast.Attribute) and node.func.attr in STATIC_METHODS:
            return False
        fname = _dotted(node.func)
        if fname is not None and fname.split(".")[-1] in STATIC_CALLS:
            return False
    if isinstance(node, ast.Name):
        return node.id in tensors
    return any(_expr_refs_tensor(c, tensors) for c in ast.iter_child_nodes(node))


def _assigned_names(target: ast.AST) -> List[str]:
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, (ast.Tuple, ast.List)):
        out: List[str] = []
        for elt in target.elts:
            out.extend(_assigned_names(elt))
        return out
    return []


def _params_of(fn: ast.FunctionDef) -> Set[str]:
    args = fn.args
    names = [a.arg for a in args.posonlyargs + args.args + args.kwonlyargs]
    if args.vararg:
        names.append(args.vararg.arg)
    return {n for n in names if n != "self"}


def captured_scopes(tree: ast.AST) -> List[Tuple[ast.FunctionDef, Set[str]]]:
    """(function, tensor-parameter names) pairs that run inside a CUDA graph
    capture: the inner def a module-level ``build_*`` builder returns, and a
    def handed by name to a ``capture(...)`` call in the same file. The
    builder's closure (``cfg``, ``mesh``, ``chunk``) is fixed when the step
    is built; only the step's own parameters are tensors."""
    scopes: List[Tuple[ast.FunctionDef, Set[str]]] = []
    local_defs = {n.name: n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and _is_capture_expr(node.func) and node.args:
            arg = node.args[0]
            if isinstance(arg, ast.Name) and arg.id in local_defs:
                fn = local_defs[arg.id]
                scopes.append((fn, _params_of(fn)))
    if isinstance(tree, ast.Module):
        for top in tree.body:
            if not (isinstance(top, ast.FunctionDef) and top.name.startswith("build_")):
                continue
            inner = {n.name: n for n in top.body if isinstance(n, ast.FunctionDef)}
            for node in ast.walk(top):
                if (isinstance(node, ast.Return) and isinstance(node.value, ast.Name)
                        and node.value.id in inner):
                    fn = inner[node.value.id]
                    scopes.append((fn, _params_of(fn)))
    seen: Set[int] = set()
    out: List[Tuple[ast.FunctionDef, Set[str]]] = []
    for fn, params in scopes:
        if id(fn) not in seen:
            seen.add(id(fn))
            out.append((fn, params))
    return out


def _propagate(fn: ast.FunctionDef, tensors: Set[str]) -> Set[str]:
    """One forward pass: names assigned from tensor expressions are tensors."""
    tensors = set(tensors)
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and _expr_refs_tensor(node.value, tensors):
            for t in node.targets:
                tensors.update(_assigned_names(t))
        elif isinstance(node, ast.AugAssign) and isinstance(node.target, ast.Name):
            if _expr_refs_tensor(node.value, tensors) or node.target.id in tensors:
                tensors.add(node.target.id)
    return tensors


def _is_synchronize(node: ast.Call) -> bool:
    return _dotted(node.func) in ("torch.cuda.synchronize", "cuda.synchronize")


# ---------------------------------------------------------------------------
# RPL001 / RPL002: capture hazards
# ---------------------------------------------------------------------------


class CapturedBranchRule(Rule):
    rule_id = "RPL001"
    severity = "error"
    description = (
        "Python `if`/`while` on a tensor's value inside a captured step (a CUDA "
        "graph records one branch; use torch.where; metadata reads are exempt)"
    )

    def visit(self, module: Module) -> List[Finding]:
        findings: List[Finding] = []
        for fn, params in captured_scopes(module.tree):
            tensors = _propagate(fn, params)
            for node in ast.walk(fn):
                if isinstance(node, (ast.If, ast.While)) and _expr_refs_tensor(
                    node.test, tensors
                ):
                    kind = "if" if isinstance(node, ast.If) else "while"
                    findings.append(self._finding(
                        module, node,
                        f"`{kind}` branches on a tensor's value in captured step "
                        f"`{fn.name}`: the graph keeps the branch of its capture and the "
                        "read syncs the card; use torch.where"))
        return findings


class CapturedHostSyncRule(Rule):
    rule_id = "RPL002"
    severity = "error"
    description = (
        "host sync inside a captured step: `.item()`/`.cpu()`/`.tolist()`/"
        "`.numpy()`, `int()/float()/bool()` or `np.*` of a tensor, or "
        "`torch.cuda.synchronize()`"
    )

    _CASTS = {"int", "float", "bool"}

    def visit(self, module: Module) -> List[Finding]:
        findings: List[Finding] = []
        for fn, params in captured_scopes(module.tree):
            tensors = _propagate(fn, params)
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                func = node.func
                if isinstance(func, ast.Attribute) and func.attr in SYNC_METHODS:
                    findings.append(self._finding(
                        module, node,
                        f"`.{func.attr}()` inside captured step `{fn.name}` reads a "
                        "tensor on the host; return it and read it once outside the step"))
                    continue
                if _is_synchronize(node):
                    findings.append(self._finding(
                        module, node,
                        f"`torch.cuda.synchronize()` inside captured step `{fn.name}`: a "
                        "capture cannot wait for the card"))
                    continue
                fname = _dotted(func)
                if fname is None:
                    continue
                tensor_arg = any(_expr_refs_tensor(a, tensors) for a in node.args)
                if fname in self._CASTS and tensor_arg:
                    findings.append(self._finding(
                        module, node,
                        f"`{fname}()` of a tensor in captured step `{fn.name}` reads its "
                        "value on the host (metadata reads are exempt)"))
                elif fname.split(".")[0] in ("np", "numpy") and tensor_arg:
                    findings.append(self._finding(
                        module, node,
                        f"`{fname}()` pulls a tensor to the host in captured step "
                        f"`{fn.name}`; use torch ops on the device"))
        return findings


class HostItemRule(Rule):
    rule_id = "RPL003"
    severity = "warning"
    description = (
        "`.item()` in host code syncs one element per call; batch the transfer "
        "(one copy per tick) like serving/engine.py"
    )

    def visit(self, module: Module) -> List[Finding]:
        in_scope: Set[int] = set()
        for fn, _ in captured_scopes(module.tree):
            in_scope.update(id(n) for n in ast.walk(fn))
        return [
            self._finding(module, node,
                          "`.item()` is a one-element device sync; prefer one batched "
                          "copy per tick and host-side indexing")
            for node in ast.walk(module.tree)
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr == "item" and id(node) not in in_scope  # RPL002's
        ]


class PerItemHostSyncRule(Rule):
    rule_id = "RPL004"
    severity = "error"
    description = (
        "per-item transfer inside a loop in a scheduler-tick class (`.item()`/"
        "`.cpu()`/`.tolist()`/`.numpy()`/`np.asarray`/`np.array`/"
        "`torch.cuda.synchronize()` under For/While in any class defining "
        "`tick`): fetch once per tick and index on the host"
    )

    #: Host transfers by callable name, and by method.
    _SYNCS = {"np.asarray", "np.array", "numpy.asarray", "numpy.array",
              "torch.cuda.synchronize"}

    def visit(self, module: Module) -> List[Finding]:
        findings: List[Finding] = []
        for cls in ast.walk(module.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            methods = [n for n in cls.body if isinstance(n, ast.FunctionDef)]
            if not any(m.name == "tick" for m in methods):
                continue
            for fn in methods:
                seen: Set[int] = set()  # nested loops: flag each call once
                for loop in ast.walk(fn):
                    if not isinstance(loop, (ast.For, ast.While)):
                        continue
                    for node in ast.walk(loop):
                        if not isinstance(node, ast.Call) or id(node) in seen:
                            continue
                        seen.add(id(node))
                        fname = _dotted(node.func)
                        method = (node.func.attr if isinstance(node.func, ast.Attribute)
                                  and node.func.attr in SYNC_METHODS else None)
                        if fname in self._SYNCS or method:
                            what = f"`.{method}()`" if method else f"`{fname}`"
                            findings.append(self._finding(
                                module, node,
                                f"{what} inside a loop in `{cls.name}.{fn.name}` syncs "
                                "the card once per item; hoist one batched fetch out of "
                                "the loop (see serving/engine.py::Scheduler._retire)"))
        return findings


# ---------------------------------------------------------------------------
# RPL005: monotonic-clock durations
# ---------------------------------------------------------------------------


class WallClockDurationRule(Rule):
    rule_id = "RPL005"
    severity = "error"
    description = (
        "`time.time()` measuring a duration (operand of a subtraction, directly "
        "or via a bound name): use the monotonic `time.perf_counter()`. Epoch "
        "timestamps are exempt."
    )

    _CLOCK_NAMES = ("time.time", "time")

    def _is_wall_clock_call(self, node: ast.AST) -> bool:
        return (isinstance(node, ast.Call) and not node.args and not node.keywords
                and _dotted(node.func) in self._CLOCK_NAMES)

    @staticmethod
    def _scopes(tree: ast.AST):
        """The module, then each function: name binding is per scope."""
        yield tree
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield node

    @staticmethod
    def _walk_local(scope: ast.AST):
        """Walk a scope without descending into nested function defs."""
        stack = list(ast.iter_child_nodes(scope))
        while stack:
            node = stack.pop()
            yield node
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                stack.extend(ast.iter_child_nodes(node))

    def visit(self, module: Module) -> List[Finding]:
        findings: List[Finding] = []
        for scope in self._scopes(module.tree):
            bound: Set[str] = set()
            for node in self._walk_local(scope):
                if isinstance(node, ast.Assign) and self._is_wall_clock_call(node.value):
                    for t in node.targets:
                        bound.update(_assigned_names(t))
            for node in self._walk_local(scope):
                if not (isinstance(node, ast.BinOp) and isinstance(node.op, ast.Sub)):
                    continue
                for side in (node.left, node.right):
                    if self._is_wall_clock_call(side) or (
                            isinstance(side, ast.Name) and side.id in bound):
                        findings.append(self._finding(
                            module, node,
                            "duration measured with `time.time()`: the wall clock steps "
                            "under NTP adjustment; use `time.perf_counter()`"))
                        break
        return findings


# ---------------------------------------------------------------------------
# RPL101 / RPL103: the gate slabs' layout and the int8 scheme
# ---------------------------------------------------------------------------


class LayoutBypassRule(Rule):
    rule_id = "RPL101"
    severity = "error"
    description = (
        "reshape/transpose/view/permute of a gate slab outside "
        "repro_torch/kernels/fused_rnn/layout.py: the slab axis order is "
        "layout.py's contract (sharded serving, the kernels' tensor maps and "
        "checkpoint migration assume it)"
    )

    #: The port's names for lane-major gate slabs and their int8 twins.
    SLAB_NAME = re.compile(r"^(w3L?|w[01]|(wq|w[01]q)L?|slabs?)$|_slab$|^slab_")
    _RESHAPERS = {"reshape", "transpose", "swapaxes", "moveaxis", "movedim", "permute",
                  "view", "flatten", "unflatten"}
    EXEMPT_SUFFIX = "kernels/fused_rnn/layout.py"

    def visit(self, module: Module) -> List[Finding]:
        if module.path.endswith(self.EXEMPT_SUFFIX):
            return []
        findings: List[Finding] = []
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            target: Optional[str] = None
            if (isinstance(func, ast.Attribute) and func.attr in self._RESHAPERS
                    and isinstance(func.value, ast.Name) and self.SLAB_NAME.match(func.value.id)):
                target = func.value.id
            else:
                fname = _dotted(func)
                if (fname and fname.split(".")[0] in ("torch", "np", "numpy")
                        and fname.split(".")[-1] in self._RESHAPERS and node.args
                        and isinstance(node.args[0], ast.Name)
                        and self.SLAB_NAME.match(node.args[0].id)):
                    target = node.args[0].id
            if target is not None:
                findings.append(self._finding(
                    module, node,
                    f"gate slab `{target}` reshaped outside layout.py; move the axis "
                    "shuffle into kernels/fused_rnn/layout.py or rename the variable if "
                    "it is not a slab"))
        return findings


def _root_name(node: ast.AST) -> Optional[str]:
    """The base Name under attribute/subscript/call chains."""
    while True:
        if isinstance(node, ast.Name):
            return node.id
        if isinstance(node, ast.Attribute):
            node = node.value
        elif isinstance(node, ast.Subscript):
            node = node.value
        elif isinstance(node, ast.Call):
            node = node.func
        else:
            return None


class DequantOutsideKernelRule(Rule):
    rule_id = "RPL103"
    severity = "error"
    description = (
        "int8 gate-slab dequant arithmetic outside repro_torch/kernels/fused_rnn/: "
        "the fused kernels widen the int8 slab and scale after the gate GEMM's "
        "fp32 accumulate; fp weights made elsewhere forfeit the int8 bytes"
    )

    QSLAB_NAME = re.compile(r"^(wq|w0q|w1q)L?$")
    SCALE_NAME = re.compile(r"^(wq_scale|s3|sL)$|(^|_)scales?$")
    EXEMPT_DIR = "kernels/fused_rnn/"

    def visit(self, module: Module) -> List[Finding]:
        if self.EXEMPT_DIR in module.path:
            return []
        findings: List[Finding] = []
        for node in ast.walk(module.tree):
            if not (isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult)):
                continue
            left, right = _root_name(node.left), _root_name(node.right)
            for slab, scale in ((left, right), (right, left)):
                if (slab is not None and scale is not None and self.QSLAB_NAME.match(slab)
                        and self.SCALE_NAME.match(scale)):
                    findings.append(self._finding(
                        module, node,
                        f"int8 slab `{slab}` dequantized (* `{scale}`) outside "
                        "kernels/fused_rnn/: pass the int8 slabs and scales into the fused "
                        "kernels, or call layout.dequantize_* explicitly"))
                    break
        return findings


# ---------------------------------------------------------------------------
# RPL202: no plain fallback on the card
# ---------------------------------------------------------------------------


class PlainFallbackRule(Rule):
    rule_id = "RPL202"
    severity = "error"
    description = (
        "a plain fallback: an `except` handler that calls a kernel's plain "
        "version (`*_plain`, `*_ref`), or a `device=\"cpu\"` literal outside "
        "tests; on the card a kernel launches or the call raises"
    )

    PLAIN_NAME = re.compile(r"(_plain|_ref)$")
    EXEMPT_DIR = "tests/"

    @staticmethod
    def _is_cpu(node: Optional[ast.AST]) -> bool:
        if isinstance(node, ast.Constant):
            return node.value == "cpu"
        return (isinstance(node, ast.Call) and _dotted(node.func) == "torch.device"
                and len(node.args) == 1 and isinstance(node.args[0], ast.Constant)
                and node.args[0].value == "cpu")

    def visit(self, module: Module) -> List[Finding]:
        if self.EXEMPT_DIR in module.path:
            return []
        findings: List[Finding] = []
        for node in ast.walk(module.tree):
            if isinstance(node, ast.ExceptHandler):
                for call in ast.walk(node):
                    name = _dotted(call.func) if isinstance(call, ast.Call) else None
                    if name and self.PLAIN_NAME.search(name.split(".")[-1]):
                        findings.append(self._finding(
                            module, call,
                            f"`{name}` called in an `except` handler: a failed kernel "
                            "must raise on the card, not fall back to its plain version"))
            elif isinstance(node, ast.Call):
                for kw in node.keywords:
                    if kw.arg == "device" and self._is_cpu(kw.value):
                        findings.append(self._finding(
                            module, kw.value,
                            "`device=\"cpu\"` literal: the CPU (and the kernels' plain "
                            "versions) only when the caller asks for it"))
            elif isinstance(node, ast.FunctionDef):
                args = node.args
                positional = args.posonlyargs + args.args
                pairs = list(zip(positional[len(positional) - len(args.defaults):],
                                 args.defaults)) + list(zip(args.kwonlyargs, args.kw_defaults))
                for a, d in pairs:
                    if a.arg == "device" and self._is_cpu(d):
                        findings.append(self._finding(
                            module, a,
                            f"`def {node.name}(..., device=\"cpu\")` defaults to the CPU; "
                            "default to the card and let the caller ask for the CPU"))
        return findings


# ---------------------------------------------------------------------------
# RPL301: config hygiene (project-wide)
# ---------------------------------------------------------------------------


class ConfigFieldUnreadRule(Rule):
    rule_id = "RPL301"
    severity = "error"
    description = (
        "ArchConfig field of repro_torch/configs/base.py never read in the "
        "scanned tree: a dead knob is a silently ignored setting"
    )

    def __init__(self, config_path_suffix: str = "repro_torch/configs/base.py",
                 class_name: str = "ArchConfig"):
        self.config_path_suffix = config_path_suffix
        self.class_name = class_name

    def finalize(self, modules: Sequence[Module]) -> List[Finding]:
        config_mod = next((m for m in modules if m.path.endswith(self.config_path_suffix)),
                          None)
        if config_mod is None:
            return []
        fields: Dict[str, ast.AST] = {}
        for node in ast.walk(config_mod.tree):
            if isinstance(node, ast.ClassDef) and node.name == self.class_name:
                for stmt in node.body:
                    if (isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target, ast.Name)
                            and not stmt.target.id.startswith("_")):
                        fields[stmt.target.id] = stmt
                break
        unread = set(fields)
        for m in modules:
            for node in ast.walk(m.tree):
                if (isinstance(node, ast.Attribute) and isinstance(node.ctx, ast.Load)
                        and node.attr in unread):
                    unread.discard(node.attr)
            if not unread:
                break
        return [
            Finding(rule_id=self.rule_id, severity=self.severity, path=config_mod.path,
                    line=fields[f].lineno, col=fields[f].col_offset + 1,
                    message=(f"`{self.class_name}.{f}` is never read in the scanned tree; "
                             "wire it up or remove it"))
            for f in sorted(unread)
        ]


def default_rules() -> List[Rule]:
    return [
        CapturedBranchRule(),
        CapturedHostSyncRule(),
        HostItemRule(),
        PerItemHostSyncRule(),
        WallClockDurationRule(),
        LayoutBypassRule(),
        DequantOutsideKernelRule(),
        PlainFallbackRule(),
        ConfigFieldUnreadRule(),
    ]


#: The JAX ids with no AST rule here, and what stands for each.
COUNTERPARTS: Dict[str, str] = {
    "RPL201": (
        "no HBM alloc in a Pallas kernel body: the port's kernel bodies are CUDA C++; "
        "its counterpart is the contract ledger's shared-memory budget, "
        "smem-ceiling[arch/step/kernel] (repro_torch/analysis/contracts.py)"
    ),
}

#: id -> description, for docs and ``rules``: every JAX rule id, each with its
#: port rule or the counterpart that stands for it.
RULE_CATALOG: Dict[str, str] = dict(sorted(
    {**{r.rule_id: r.description for r in default_rules()}, **COUNTERPARTS}.items()))
