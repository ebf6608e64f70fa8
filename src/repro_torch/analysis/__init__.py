"""Static analysis of the port: AST lint rules and the contract ledger
(``repro/analysis/`` for PyTorch on the H100).

Two passes over the port's invariants:

  * ``rules``/``lint``: the port's AST rules (capture hazards in the steps
    ``training/graphs.py`` captures, host syncs in the tick loop, the gate
    slabs' layout and int8 scheme, no plain fallback on the card, config
    hygiene) with per-line suppression; ``python -m repro_torch.analysis
    lint [paths]``.
  * ``fingerprint``/``smem``/``contracts``: the six serving steps of every
    paper-RNN config run on the meta device, their kernel instances against
    the H100's shared memory, their collectives, in-place cache writes and
    trace set, committed as ``CONTRACTS_TORCH.json`` and re-checked by
    ``python -m repro_torch.analysis contracts --check``.

Nothing here launches a kernel; ``rules``, ``lint`` and ``fingerprint``
import no torch at import time.
"""
# The `fingerprint` MODULE is the API (`from repro_torch.analysis import
# fingerprint as fp`); its same-named function is not re-exported here,
# which would shadow the submodule attribute.
from repro_torch.analysis.fingerprint import (  # noqa: F401
    CollectiveOp,
    collective_ops,
    count_ops,
    in_place_count,
    size_class,
    weight_sized_allgathers,
)
from repro_torch.analysis.lint import run_lint  # noqa: F401
from repro_torch.analysis.rules import (  # noqa: F401
    RULE_CATALOG,
    Finding,
    Rule,
    default_rules,
)
