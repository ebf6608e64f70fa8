"""The port's analysis package (``repro_torch/analysis/``) against JAX's
(``repro/analysis/``): lint rules, collective fingerprints, the contract
ledger ``CONTRACTS_TORCH.json`` beside ``CONTRACTS.json``.

Cheapest first:

  * each port rule on inline snippets written to ``tmp_path`` (no fixture
    under ``src/``, where JAX's lint would read it): the bad snippet trips
    exactly its rule, its good twin is clean, and the suppression comment
    silences it; every JAX rule id has a port rule or a named counterpart;
    the port's lint over ``src/repro_torch`` is clean;
  * fingerprints of a synthetic collective log;
  * the committed ledger: the 17 archs and trace sets of ``CONTRACTS.json``,
    decode's weight-sized all-gathers 0, the ring configs' collective counts
    against JAX's, the self-diff clean and each deliberate regression a
    named violation (the pure ``diff_contracts``); the ledger derived again
    byte for byte; the CLI's exit codes;
  * a live CPU ``Scheduler`` (prefix cache on) and a speculative one call
    each step with one signature, the ledger's.
"""
from __future__ import annotations

import ast
import copy
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.analysis import contracts
from repro_torch.analysis import fingerprint as fp
from repro_torch.analysis import smem
from repro_torch.analysis.lint import parse_suppressions, run_lint
from repro_torch.analysis.rules import RULE_CATALOG, ConfigFieldUnreadRule, default_rules
from repro_torch.launch.mesh import Collective

REPO = pathlib.Path(__file__).resolve().parents[1]
LEDGER = REPO / "CONTRACTS_TORCH.json"
JAX_LEDGER = REPO / "CONTRACTS.json"

# rule id -> (bad snippet, its good twin, the bad snippet's flagged line).
SNIPPETS = {
    "RPL001": ('''
        def build_step(cfg):
            def decode_step(params, caches, token):
                x = token + 1
                if x.sum() > 0:
                    return caches
                return params
            return decode_step
        ''', '''
        def build_step(cfg):
            def decode_step(params, caches, token):
                if token.shape[0] > 0 and caches is not None and token.dim() == 2:
                    return caches
                return params
            return decode_step
        ''', 5),
    "RPL002": ('''
        def build_step(cfg):
            def decode_step(params, caches, token):
                n = token.cpu()
                return caches, n
            return decode_step
        ''', '''
        def build_step(cfg):
            def decode_step(params, caches, token):
                n = int(token.shape[0])
                return caches, n
            return decode_step
        ''', 4),
    "RPL003": ('''
        def first(x):
            return x.item()
        ''', '''
        def first(x):
            return x[0]
        ''', 3),
    "RPL004": ('''
        class Engine:
            def tick(self):
                out = []
                for t in self.pending:
                    out.append(t.tolist())
                return out
        ''', '''
        class Engine:
            def tick(self):
                host = torch.stack(self.pending).tolist()
                return [row for row in host]
        ''', 6),
    "RPL005": ('''
        import time
        def timed(fn):
            t0 = time.time()
            fn()
            return time.time() - t0
        ''', '''
        import time
        def timed(fn):
            t0 = time.perf_counter()
            fn()
            return time.perf_counter() - t0, time.time()
        ''', 6),
    "RPL101": ('''
        def flat(w3):
            return w3.permute(1, 0, 2)
        ''', '''
        def flat(x):
            return x.permute(1, 0, 2)
        ''', 3),
    "RPL103": ('''
        def widen(wq, wq_scale):
            return wq.float() * wq_scale
        ''', '''
        def widen(x, gain):
            return x.float() * gain
        ''', 3),
    "RPL202": ('''
        def layer(u):
            try:
                return layer_kernel(u)
            except RuntimeError:
                return layer_plain(u)
        ''', '''
        def layer(u):
            try:
                return layer_kernel(u)
            except RuntimeError:
                raise
        ''', 6),
    "RPL301": ('''
        from dataclasses import dataclass
        @dataclass
        class ArchConfig:
            width: int = 1
            dead_knob: int = 0
        def use(cfg):
            return cfg.width
        ''', '''
        from dataclasses import dataclass
        @dataclass
        class ArchConfig:
            width: int = 1
        def use(cfg):
            return cfg.width
        ''', 6),
}


def _lint(tmp_path, rule_id, text):
    """Lint the snippet, written as a file (RPL301's as the port's config
    module)."""
    path = (tmp_path / "repro_torch" / "configs" / "base.py" if rule_id == "RPL301"
            else tmp_path / f"{rule_id.lower()}.py")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    return run_lint([str(path)])


@pytest.mark.parametrize("rule_id", sorted(SNIPPETS))
def test_bad_snippet_trips_exactly_its_rule(tmp_path, rule_id):
    bad, _, line = SNIPPETS[rule_id]
    findings = _lint(tmp_path, rule_id, textwrap.dedent(bad))
    assert [(f.rule_id, f.line) for f in findings] == [(rule_id, line)], \
        [f.format() for f in findings]


@pytest.mark.parametrize("rule_id", sorted(SNIPPETS))
def test_good_twin_is_clean(tmp_path, rule_id):
    _, good, _ = SNIPPETS[rule_id]
    findings = _lint(tmp_path, rule_id, textwrap.dedent(good))
    assert not findings, [f.format() for f in findings]


@pytest.mark.parametrize("rule_id", sorted(SNIPPETS))
def test_suppression_comment_silences_the_line(tmp_path, rule_id):
    bad, _, line = SNIPPETS[rule_id]
    lines = textwrap.dedent(bad).split("\n")
    lines[line - 1] += f"  # repro-lint: disable={rule_id} (a test of the suppression)"
    assert not _lint(tmp_path, rule_id, "\n".join(lines))


def test_every_host_sync_trips_the_captured_step_rule(tmp_path):
    """RPL002 knows the port's transfers: `.item()`, `.cpu()`, `.tolist()`,
    `.numpy()`, `int/float/bool` of a tensor, `np.*` of one and
    `torch.cuda.synchronize()`, in a builder's step and in a def handed to
    `capture(...)` by name."""
    for sync in ("token.item()", "token.cpu()", "token.tolist()", "token.numpy()",
                 "int(token)", "float(token + 1)", "np.asarray(token)",
                 "torch.cuda.synchronize()"):
        for src in (f'''
                def build_step(cfg):
                    def decode_step(params, token):
                        n = {sync}
                        return n
                    return decode_step
                ''', f'''
                def run(params, token):
                    n = {sync}
                    return n
                step = graphs.capture(run, params, token)
                '''):
            path = tmp_path / "step.py"
            path.write_text(textwrap.dedent(src))
            assert [f.rule_id for f in run_lint([str(path)])] == ["RPL002"], (sync, src)


def test_plain_fallback_literals(tmp_path):
    """RPL202 also flags a `device="cpu"` literal at a call site and as a
    default, and a fallback to a `*_ref` plain version; nothing under
    `tests/`."""
    src = textwrap.dedent('''
        def a():
            return torch.zeros(3, device="cpu")
        def b(x, device="cpu"):
            return x
        def c(u):
            try:
                return scan_kernel(u)
            except ValueError:
                return linear_scan_ref(u)
        ''')
    path = tmp_path / "fallback.py"
    path.write_text(src)
    assert [(f.rule_id, f.line) for f in run_lint([str(path)])] == [
        ("RPL202", 3), ("RPL202", 4), ("RPL202", 10)]
    test_dir = tmp_path / "tests"
    test_dir.mkdir()
    (test_dir / "fallback.py").write_text(src)
    assert not run_lint([str(test_dir)], root=tmp_path)


def test_severity_split():
    """RPL003 alone warns; every other port rule is an error."""
    assert {r.rule_id: r.severity for r in default_rules()} == {
        **{k: "error" for k in SNIPPETS}, "RPL003": "warning"}


def test_suppression_parsing_variants():
    table = parse_suppressions(
        "x = 1  # repro-lint: disable=RPL101, RPL202 (why)\n"
        "y = 2  # repro-lint: disable=all\n"
        "z = 3\n")
    assert table[1] >= {"RPL101", "RPL202"} and table[2] == {"all"} and 3 not in table


def test_every_jax_rule_has_a_port_rule_or_counterpart():
    from repro.analysis.rules import RULE_CATALOG as JAX_CATALOG

    assert set(JAX_CATALOG) <= set(RULE_CATALOG)
    port_rules = {r.rule_id for r in default_rules()}
    for rule_id in set(JAX_CATALOG) - port_rules:
        assert "counterpart" in RULE_CATALOG[rule_id], rule_id
    assert "smem-ceiling" in RULE_CATALOG["RPL201"]


def test_port_lint_clean_on_repro_torch():
    """What `python -m repro_torch.analysis lint src/repro_torch` runs."""
    findings = run_lint([str(REPO / "src" / "repro_torch")], root=REPO)
    assert not findings, "\n".join(f.format() for f in findings)


def test_config_rule_reads_the_port_config():
    rule = ConfigFieldUnreadRule()
    assert rule.config_path_suffix == "repro_torch/configs/base.py"
    assert not run_lint([str(REPO / "src" / "repro_torch")], rules=[rule], root=REPO)


def test_package_imports_no_jax_and_no_repro():
    """The package's own imports name no `jax` and nothing of `repro`, and
    importing it (the ledger derived too) pulls neither in."""
    for path in (REPO / "src" / "repro_torch" / "analysis").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "repro"), (path.name, name)
    code = ("import sys, repro_torch.analysis, repro_torch.analysis.__main__; "
            "from repro_torch.analysis import contracts; "
            "contracts.derive_arch(contracts.registered_rnn_configs()[0]); "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env=dict(os.environ, PYTHONPATH=str(REPO / "src")))


# ---------------------------------------------------------------------------
# Fingerprints of a synthetic collective log
# ---------------------------------------------------------------------------

_LOG = [Collective("all-gather", 2 * 8 * 1024, True, 8 * 1024),
        Collective("all-gather", 4 * 4096 * 1024, False, 4096 * 1024),
        Collective("collective-permute", 4 * 8 * 64, False, 8 * 64),
        Collective("all-reduce", 4 * 8, False, 8),
        Collective("broadcast", 4 * 300, True, 300)]


def test_count_ops_counts_each_logged_call():
    assert fp.count_ops(_LOG, "all-gather") == 2
    assert fp.count_ops(_LOG, "collective-permute") == 1
    assert fp.count_ops(_LOG, "reduce-scatter") == 0
    assert len(fp.collective_ops(_LOG)) == 5


def test_weight_sized_allgather_detection():
    heavy = fp.weight_sized_allgathers(_LOG, threshold_elems=1 << 20)
    assert len(heavy) == 1 and heavy[0].elems == 4096 * 1024
    assert not fp.weight_sized_allgathers(_LOG, threshold_elems=1 << 23)


def test_size_classes_are_jaxs():
    from repro.analysis import fingerprint as jfp

    for n in (0, 100, 1023, 1024, 5000, (1 << 20) - 1, 1 << 20, 1 << 26):
        assert fp.size_class(n) == jfp.size_class(n), n


def test_fingerprint_structure_and_in_place_count():
    got = fp.fingerprint(_LOG, weight_elems=4096 * 1024)
    assert got == {"collectives": {"all-gather": {"large": 1, "medium": 1},
                                   "all-reduce": {"small": 1}, "broadcast": {"small": 1},
                                   "collective-permute": {"small": 1}},
                   "collective_count": 5, "weight_allgathers": 1}
    caches = {"c": torch.zeros(2), "x_tail": torch.zeros(3)}
    assert fp.in_place_count(caches, {caches["c"].untyped_storage()._cdata}) == 1


# ---------------------------------------------------------------------------
# The committed ledger
# ---------------------------------------------------------------------------

def _ledger():
    return json.loads(LEDGER.read_text())


def _jax_ledger():
    return json.loads(JAX_LEDGER.read_text())


def test_ledger_covers_jaxs_archs_with_jaxs_trace_sets():
    ledger, jax_ledger = _ledger(), _jax_ledger()
    assert sorted(ledger["archs"]) == sorted(jax_ledger["archs"])
    assert len(ledger["archs"]) == 17
    assert {c.name for c in contracts.registered_rnn_configs()} == set(ledger["archs"])
    for name, entry in ledger["archs"].items():
        jentry = jax_ledger["archs"][name]
        assert entry["trace_set"] == jentry["trace_set"], name
        assert entry["trace_count"] == jentry["trace_count"] == 6, name
        for key in ("engine", "cell", "batch", "chunk", "mesh"):
            assert entry[key] == jentry[key], (name, key)
        assert sorted(entry["steps"]) == sorted(contracts.STEP_NAMES)


def test_decode_never_all_gathers_a_weight():
    for name, entry in _ledger()["archs"].items():
        assert entry["steps"]["decode"]["weight_allgathers"] == 0, name


# The ring configs' collectives by op against JAX's HLO, per step, as
# (port - JAX); ops not listed are equal. The port gathers the whole (B, T,
# V) logits over the vocabulary shards once (65,536 elements at decode,
# medium) and every rank takes the argmax of the whole row, where XLA
# partitions the argmax and gathers each shard's maximum and its index (two
# small all-gathers): one all-gather fewer in every step that samples.
RING_DIFFS = {"prefill": {"all-gather": -1}, "decode": {"all-gather": -1},
              "verify": {"all-gather": -1}}


def test_ring_collectives_by_op_against_jax():
    ledger, jax_ledger = _ledger(), _jax_ledger()
    rings = [n for n, e in ledger["archs"].items() if e["mesh"]]
    assert len(rings) == 4
    for name in rings:
        for step in contracts.STEP_NAMES:
            got = {op: sum(v.values())
                   for op, v in ledger["archs"][name]["steps"][step]["collectives"].items()}
            want = {op: sum(v.values())
                    for op, v in jax_ledger["archs"][name]["steps"][step]["collectives"].items()}
            diff = {op: got.get(op, 0) - want.get(op, 0) for op in set(got) | set(want)
                    if got.get(op, 0) != want.get(op, 0)}
            assert diff == RING_DIFFS.get(step, {}), (name, step, got, want)


def test_in_place_counts_are_jaxs_donated_aliases():
    ledger, jax_ledger = _ledger(), _jax_ledger()
    for name, entry in ledger["archs"].items():
        for step, rec in entry["steps"].items():
            assert rec["in_place"] == jax_ledger["archs"][name]["steps"][step]["donated_aliases"]


def test_ledger_instances_fit_the_card():
    """Every instance within 232,448 B a CTA with one CTA or more an SM;
    our kernels run on the fused, stacked and ring configs, none on the
    others."""
    assert smem.SMEM_CEILING == 232448
    for name, entry in _ledger()["archs"].items():
        kernels = set()
        for rec in entry["steps"].values():
            for inst in rec["instances"]:
                assert smem.fits(inst), (name, inst)
                kernels.add(inst["call"])
        assert bool(kernels) == (entry["engine"] in ("fused", "fused_stack")), name
        if entry["mesh"]:
            assert kernels == {"linear_scan"}, name


def test_every_instance_kind_has_a_card_report(monkeypatch):
    """Each kernel body's meta instance (B1/B2's tensor-core and CUDA-core
    bodies, B3 forward and backward, B4's chunk and one-step kernels, B5's
    mma and split kernels) carries the arguments with which
    ``smem.card_instance`` asks the card for it: the call binds to the
    wrapper's report function, whose fields come back under the instance's
    names (static shared memory where the card reports it)."""
    import inspect

    from repro_torch.kernels.fused_rnn import fused_rnn
    from repro_torch.kernels.gqa_decode import gqa_decode
    from repro_torch.kernels.linear_scan import linear_scan
    from repro_torch.kernels.ssd import ssd

    bf16, f32 = torch.bfloat16, torch.float32
    cases = (
        (fused_rnn.meta_instance(64, 8, 1024, 1024, io_dtype=bf16, w_dtype=torch.int8),
         fused_rnn, "instance_info", False),
        (fused_rnn.meta_instance(13, 3, 1000, 1000, io_dtype=f32, w_dtype=f32, taps=2),
         fused_rnn, "simt_instance_info", False),
        (fused_rnn.meta_instance(64, 4, 1024, 1024, io_dtype=f32, w_dtype=bf16, stack=True),
         fused_rnn, "simt_instance_info", False),
        (linear_scan.meta_instance(64, 4096, f32), linear_scan, "instance_info", True),
        (linear_scan.meta_instance(64, 4096, f32, backward=True), linear_scan, "instance_info",
         True),
        (ssd.meta_instance(bf16, bf16, 4, 64, 80, 1, 64, 128), ssd, "instance_info", False),
        (ssd.meta_instance(f32, f32, 4, 64, 8, 4, 8, 16), ssd, "instance_info", False),
        (ssd.meta_instance(bf16, bf16, 4, 1, 80, 1, 64, 128), ssd, "step_instance_info", True),
        (ssd.meta_instance(f32, f32, 4, 1, 8, 4, 6, 16), ssd, "step_instance_info", True),
        (gqa_decode.meta_instance(bf16, 128, 4, (1, 1, 1)), gqa_decode, "instance_info", False),
        (gqa_decode.meta_instance(f32, 128, 32, (1, 1, 1)), gqa_decode, "instance_info", False),
    )
    report = {"smem_bytes": 11, "registers": 22, "ctas_per_sm": 3, "static_smem_bytes": 44}
    for inst, module, fn, static in cases:
        called = []
        real = getattr(module, fn)
        monkeypatch.setattr(module, fn, lambda *a, **kw: called.append((a, kw)) or report)
        got = smem.card_instance(inst)
        monkeypatch.setattr(module, fn, real)
        assert len(called) == 1, inst["kernel"]
        inspect.signature(real).bind(*called[0][0], **called[0][1])
        want = {"smem_dynamic": 11, "registers": 22, "ctas_per_sm": 3}
        assert got == ({**want, "smem_static": 44} if static else want), inst["kernel"]
    assert {c[0]["kernel"].split("<")[0] for c in cases} == {
        "fused_rnn_mma_kernel", "fused_rnn_layer_kernel", "linear_scan_kernel",
        "linear_scan_bwd_kernel", "ssd_chunk_mma_kernel", "ssd_chunk_kernel", "ssd_step_kernel",
        "ssd_step_vec_kernel", "gqa_decode_mma_kernel", "gqa_decode_split_kernel"}


def test_self_diff_is_clean():
    ledger = _ledger()
    assert contracts.diff_contracts(ledger, copy.deepcopy(ledger)) == []


def _rules(committed, derived):
    return {v.rule for v in contracts.diff_contracts(committed, derived)}


def _first_ring(ledger):
    return next(n for n, e in sorted(ledger["archs"].items()) if e["mesh"])


def _first_kernel_arch(ledger):
    return next(n for n, e in sorted(ledger["archs"].items())
                if e["steps"]["decode"]["instances"])


def test_deliberate_regressions_are_named_violations():
    committed = _ledger()
    first = sorted(committed["archs"])[0]
    ring, kern = _first_ring(committed), _first_kernel_arch(committed)

    gone = copy.deepcopy(committed)
    del gone["archs"][first]["steps"]["decode"]
    assert f"ledger-missing-step[{first}/decode]" in _rules(gone, committed)

    derived = copy.deepcopy(committed)
    derived["archs"][ring]["steps"]["decode"]["weight_allgathers"] = 1
    assert f"decode-weight-allgather[{ring}]" in _rules(committed, derived)
    assert f"decode-weight-allgather[{ring}]" in _rules(derived, copy.deepcopy(committed))

    derived = copy.deepcopy(committed)
    inst = derived["archs"][kern]["steps"]["decode"]["instances"][0]
    inst["smem_dynamic"] = smem.SMEM_CEILING + 1
    rules = _rules(committed, derived)
    assert f"smem-ceiling[{kern}/decode/{inst['kernel']}]" in rules
    assert f"smem-budget[{kern}/decode]" in rules

    derived = copy.deepcopy(committed)
    derived["archs"][ring]["steps"]["decode"]["collectives"].setdefault(
        "all-to-all", {})["large"] = 3
    assert f"collective-fingerprint[{ring}/decode]" in _rules(committed, derived)

    derived = copy.deepcopy(committed)
    del derived["archs"][first]
    derived["archs"]["brand-new-arch"] = copy.deepcopy(committed["archs"][ring])
    rules = _rules(committed, derived)
    assert f"ledger-stale-arch[{first}]" in rules
    assert "ledger-missing-arch[brand-new-arch]" in rules

    derived = copy.deepcopy(committed)
    entry = derived["archs"][first]
    entry["trace_set"].append(next(s for s in entry["trace_set"] if s.startswith("verify(")))
    entry["trace_count"] = len(entry["trace_set"])
    assert f"trace-set[{first}]" in _rules(committed, derived)

    derived = copy.deepcopy(committed)
    derived["archs"][first]["steps"]["prefill"]["in_place"] = 99
    assert f"in-place[{first}/prefill]" in _rules(committed, derived)

    derived = copy.deepcopy(committed)
    derived["archs"][kern]["steps"]["decode"]["launches"] = {}
    assert f"kernel-launches[{kern}/decode]" in _rules(committed, derived)


def test_verify_signature_appears_once_per_trace_set():
    for name, entry in _ledger()["archs"].items():
        hits = [s for s in entry["trace_set"] if s.startswith("verify(")]
        assert len(hits) == 1 and f",{contracts.SPEC_K}]int32" in hits[0], (name, hits)


def test_ledger_derives_again_byte_for_byte():
    """``contracts --emit`` is byte-stable: the derivation on meta gives the
    committed file."""
    assert contracts.dumps(contracts.build_contracts()) == LEDGER.read_text()


def test_cli_check_and_a_tampered_copy(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    cmd = [sys.executable, "-m", "repro_torch.analysis"]
    ok = subprocess.run(cmd + ["contracts", "--check"], cwd=REPO, env=env,
                        capture_output=True, text=True)
    assert ok.returncode == 0, ok.stderr
    assert "0 violation(s)" in ok.stdout
    tampered = _ledger()
    name = _first_ring(tampered)
    tampered["archs"][name]["steps"]["decode"]["weight_allgathers"] = 2
    path = tmp_path / "ledger.json"
    path.write_text(contracts.dumps(tampered))
    bad = subprocess.run(cmd + ["contracts", "--check", "--path", str(path)], cwd=REPO, env=env,
                         capture_output=True, text=True)
    assert bad.returncode == 1
    assert f"decode-weight-allgather[{name}]" in bad.stderr


def test_cli_lint_and_rules():
    from repro_torch.analysis.__main__ import main

    assert main(["lint", str(REPO / "src" / "repro_torch")]) == 0
    assert main(["rules"]) == 0


# ---------------------------------------------------------------------------
# Live: a CPU Scheduler stays inside the ledger's trace set
# ---------------------------------------------------------------------------

def _record_signatures(eng, attrs, seen):
    """Wrap the Scheduler's step attributes: each call's signature into
    ``seen[step]``."""
    for step, attr in attrs.items():
        fn = getattr(eng, attr)

        def wrapped(*args, fn=fn, step=step):
            seen.setdefault(step, set()).add(contracts.step_signature(step, args))
            return fn(*args)

        setattr(eng, attr, wrapped)


def test_live_schedulers_call_only_the_ledgers_signatures():
    """A CPU Scheduler at the ledger's batch 8 and chunk 32 with the prefix
    cache on (its snapshot and inject on a hit), and a speculative one at
    SPEC_K (verify, and the rollbacks' snapshot and inject), call each step
    with one signature only, the ledger's for the config."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import lm
    from repro_torch.serving import Request, Scheduler, clone_trace

    entry = _ledger()["archs"]["sru-paper-small"]
    cfg = get_config("sru-paper-small").reduced()
    params = lm.lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    plain_attrs = {s: f"_{s}" for s in ("reset", "prefill", "decode", "snapshot", "inject")}
    kw = dict(batch=entry["batch"], chunk=entry["chunk"], async_depth=2, device="cpu",
              graphs=False)
    eng = Scheduler(cfg, params, prefix_cache_mb=4.0, **kw)
    seen: dict = {}
    _record_signatures(eng, plain_attrs, seen)
    rng = np.random.default_rng(0)
    base = rng.integers(0, cfg.vocab, size=64, dtype=np.int32)
    trace = [Request(rid=0, prompt=base, max_new_tokens=4),
             Request(rid=1, prompt=np.concatenate([base[:32], base[:5]]), max_new_tokens=3),
             Request(rid=2, prompt=rng.integers(0, cfg.vocab, size=9, dtype=np.int32),
                     max_new_tokens=3)]
    done = eng.run(trace[:1], max_ticks=200)
    done += eng.run(trace[1:], max_ticks=200)
    assert sorted(r.rid for r in done) == [0, 1, 2]
    assert eng.metrics.prefix_hits >= 1

    draft_cfg = get_config("sru-paper-draft").reduced()
    spec = Scheduler(cfg, params, draft_cfg=draft_cfg,
                     draft_params=lm.lm_init(torch.Generator().manual_seed(1), draft_cfg,
                                             device="cpu"),
                     spec_k=contracts.SPEC_K, **kw)
    spec_seen: dict = {}
    _record_signatures(spec, {**plain_attrs, "verify": "_verify"}, spec_seen)
    spec_done = spec.run(clone_trace(trace), max_ticks=500)
    assert sorted(r.rid for r in spec_done) == [0, 1, 2]
    assert spec.metrics.verify_steps > 0

    ledger_set = set(entry["trace_set"])
    assert sorted(seen) == sorted(plain_attrs)
    assert sorted(spec_seen) == sorted([*plain_attrs, "verify"])
    for calls in (seen, spec_seen):
        for step, sigs in calls.items():
            assert len(sigs) == 1 and sigs <= ledger_set, (step, sigs)
    assert set().union(*seen.values(), *spec_seen.values()) == ledger_set
