"""Lint driver: walk files, run the rules, filter suppressions
(``repro/analysis/lint.py``'s, over the port's rules).

``run_lint(paths)`` is the library entry (tests call it on snippets);
``python -m repro_torch.analysis lint`` is the CLI, over
``src/repro_torch`` by default.

Suppression is per line: a trailing ``# repro-lint: disable=RPL202`` (ids
comma-separated, or ``all``) silences findings ON that line only, so the
contract it bends stays greppable at the site, with the reason beside it.
"""
from __future__ import annotations

import ast
import pathlib
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set

from repro_torch.analysis.rules import Finding, Module, Rule, default_rules

_SUPPRESS_RE = re.compile(r"#\s*repro-lint:\s*disable=([\w,\s-]+)")


def parse_suppressions(source: str) -> Dict[int, Set[str]]:
    """line number (1-based) -> set of suppressed rule ids ("all" wildcard)."""
    out: Dict[int, Set[str]] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        m = _SUPPRESS_RE.search(line)
        if m:
            out[i] = {tok.strip() for tok in m.group(1).split(",") if tok.strip()}
    return out


def _suppressed(finding: Finding, table: Dict[int, Set[str]]) -> bool:
    ids = table.get(finding.line)
    return bool(ids) and ("all" in ids or finding.rule_id in ids)


def collect_files(paths: Sequence[str]) -> List[pathlib.Path]:
    files: List[pathlib.Path] = []
    for p in paths:
        path = pathlib.Path(p)
        if path.is_dir():
            files.extend(sorted(path.rglob("*.py")))
        elif path.suffix == ".py":
            files.append(path)
    return files


def load_modules(files: Iterable[pathlib.Path],
                 root: Optional[pathlib.Path] = None) -> List[Module]:
    modules: List[Module] = []
    for f in files:
        source = f.read_text(encoding="utf-8")
        try:
            tree = ast.parse(source, filename=str(f))
        except SyntaxError:
            continue  # not this linter's job; pytest surfaces it
        rel = f
        if root is not None:
            try:
                rel = f.resolve().relative_to(root.resolve())
            except ValueError:
                rel = f
        modules.append(Module(path=str(rel).replace("\\", "/"), tree=tree, source=source))
    return modules


def run_lint(paths: Sequence[str], rules: Optional[Sequence[Rule]] = None,
             root: Optional[pathlib.Path] = None) -> List[Finding]:
    """Lint ``paths`` (files or directories); returns the unsuppressed
    findings, sorted by (path, line, rule)."""
    rules = list(rules) if rules is not None else default_rules()
    modules = load_modules(collect_files(paths), root=root)
    tables = {m.path: parse_suppressions(m.source) for m in modules}
    findings: List[Finding] = []
    for m in modules:
        for rule in rules:
            findings.extend(f for f in rule.visit(m) if not _suppressed(f, tables[m.path]))
    for rule in rules:
        findings.extend(f for f in rule.finalize(modules)
                        if not _suppressed(f, tables.get(f.path, {})))
    findings.sort(key=lambda f: (f.path, f.line, f.rule_id))
    return findings
