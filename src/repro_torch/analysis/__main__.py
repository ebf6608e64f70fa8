"""The port's analyzer CLI: ``tools/repro_lint.py`` for ``repro_torch``.

  python -m repro_torch.analysis lint [paths...]   the port's AST rules over
                          ``paths`` (default: src/repro_torch). Exit 1 on any
                          error finding; warnings print but do not fail.
                          Suppress per line with
                          ``# repro-lint: disable=<RULE_ID>`` and the reason.
  python -m repro_torch.analysis rules             the rule catalog: every
                          JAX rule id with its port rule or counterpart.
  python -m repro_torch.analysis contracts --emit  derive the contract ledger
                          on the meta device and write CONTRACTS_TORCH.json
                          at the repository root.
  python -m repro_torch.analysis contracts --check re-derive and diff against
                          the committed ledger; exit 1 with one named
                          violation per line.

Runs on the CPU (the ledger is derived on meta tensors: nothing launches)
from the repository root, with ``src`` on ``PYTHONPATH``.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[3]
CONTRACTS_PATH = ROOT / "CONTRACTS_TORCH.json"


def cmd_lint(args) -> int:
    from repro_torch.analysis.lint import run_lint

    paths = args.paths or [str(ROOT / "src" / "repro_torch")]
    findings = run_lint(paths, root=ROOT)
    errors = sum(f.severity == "error" for f in findings)
    for f in findings:
        print(f.format())
    print(f"repro-lint: {len(findings)} finding(s) ({errors} error(s), "
          f"{len(findings) - errors} warning(s))")
    return 1 if errors else 0


def cmd_rules(_args) -> int:
    from repro_torch.analysis.rules import COUNTERPARTS, RULE_CATALOG, default_rules

    severity = {r.rule_id: r.severity for r in default_rules()}
    for rule_id, text in RULE_CATALOG.items():
        kind = severity.get(rule_id, "ledger" if rule_id in COUNTERPARTS else "")
        print(f"{rule_id}  [{kind:7s}]  {text}")
    return 0


def cmd_contracts(args) -> int:
    from repro_torch.analysis import contracts

    log = (lambda msg: print(msg, file=sys.stderr)) if args.verbose else None
    path = pathlib.Path(args.path) if args.path else CONTRACTS_PATH
    if args.emit:
        ledger = contracts.build_contracts(log=log)
        path.write_text(contracts.dumps(ledger))
        print(f"contracts: wrote {path} ({len(ledger['archs'])} archs)")
        return 0
    if not path.exists():
        print(f"contracts-check: FAIL: {path} missing; generate it with "
              "`python -m repro_torch.analysis contracts --emit`", file=sys.stderr)
        return 1
    committed = json.loads(path.read_text())
    violations = contracts.check_contracts(committed, log=log)
    for v in violations:
        print(f"contracts-check: {v.format()}", file=sys.stderr)
    print(f"contracts-check: {len(committed.get('archs', {}))} archs checked, "
          f"{len(violations)} violation(s)")
    return 1 if violations else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    sub = ap.add_subparsers(dest="cmd", required=True)
    lint = sub.add_parser("lint", help="the port's AST rules")
    lint.add_argument("paths", nargs="*", help="files/dirs (default: src/repro_torch)")
    lint.set_defaults(fn=cmd_lint)
    rules = sub.add_parser("rules", help="list the rule catalog")
    rules.set_defaults(fn=cmd_rules)
    con = sub.add_parser("contracts", help="the contract ledger")
    mode = con.add_mutually_exclusive_group(required=True)
    mode.add_argument("--emit", action="store_true", help="derive and write the ledger")
    mode.add_argument("--check", action="store_true", help="re-derive and diff vs committed")
    con.add_argument("--path", default=None, help="ledger path (default CONTRACTS_TORCH.json)")
    con.add_argument("-v", "--verbose", action="store_true")
    con.set_defaults(fn=cmd_contracts)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
