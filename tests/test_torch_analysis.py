"""The port's flight-rules lint (DESIGN §13, `repro_torch.analysis`):
rule-by-rule coverage over paired good/bad fixture trees (exact rule IDs,
messages and file:line anchors), parity with the JAX package's rules on
the JAX fixtures, allowlist hygiene (justification / staleness / count
drift), seeded violations against a copy of the port's real package, and
the tier-1 gate over the live tree.
"""
import json
import re
import shutil
from pathlib import Path

import pytest

import repro.analysis as jax_analysis
from repro_torch.analysis import ALLOWLIST, RULES, Allow, Tree, run
from repro_torch.analysis.framework import MIN_REASON

REPO = Path(__file__).resolve().parents[1]
FIX = REPO / "tests" / "fixtures" / "torch_analysis"
JAX_FIX = REPO / "tests" / "fixtures" / "analysis"

ENGINE = "src/repro_torch/serving/engine.py"
SIM = "src/repro_torch/serving/sim.py"
CONFIG = "src/repro_torch/config/base.py"
LAYERS = "src/repro_torch/models/layers.py"
OPS = "src/repro_torch/kernels/ops.py"

OK_REASON = "fixture sync point retained deliberately for this test"

#: the bad fixture's engine: one host-sync per torch sync call, by line
ENGINE_SYNCS = {14: ".item()", 15: ".tolist()", 16: ".cpu()",
                17: ".numpy()", 18: ".to() the CPU", 19: ".to() the CPU",
                20: ".to() the CPU", 21: "torch.cuda.synchronize()",
                22: "ev.synchronize()", 23: "stream.synchronize()",
                24: "torch.nonzero()", 25: "x.nonzero()",
                26: "np.asarray()", 27: "np.array()"}

#: the port's Tree pointed at the JAX fixtures' anchors, reading under
#: src/ as the JAX rules do
JAX_ANCHORS = dict(engine="src/repro/serving/engine.py",
                   sim="src/repro/serving/sim.py",
                   kv_cache="src/repro/serving/kv_cache.py",
                   config="src/repro/config/base.py",
                   serve_cli="src/repro/launch/serve.py")


def bad_report(**kw):
    return run(Tree(root=FIX / "bad"), **kw)


# -- per-rule fixture coverage: exact IDs, messages, anchors -----------------

def test_host_sync_bad_fixture_exact_anchors():
    r = bad_report(rule_ids=["host-sync"])
    got = {(f.path, f.line, f.scope) for f in r.findings}
    assert got == {(ENGINE, n, "Engine.step") for n in ENGINE_SYNCS} | {
        (LAYERS, 7, "attention"), (LAYERS, 8, "attention"),
        (OPS, 6, "launch")}
    msgs = {f.line: f.message for f in r.findings if f.path == ENGINE}
    for line, call in ENGINE_SYNCS.items():
        assert msgs[line].startswith(call), (line, msgs[line])
    assert "waits for the stream" in msgs[14]
    assert "data-dependent output shape" in msgs[24]
    assert "non-literal operand" in msgs[26]
    assert all(f.rule == "host-sync" for f in r.findings)
    assert r.findings[0].anchor == "src/repro_torch/kernels/ops.py:6"


def test_host_sync_scope_is_the_ports_step_code():
    # core/ is host-only code, and the JAX package is not the port's
    r = run(Tree(root=FIX / "bad", scan=("src/**/*.py",)),
            rule_ids=["host-sync"])
    paths = {f.path for f in r.findings}
    assert paths == {ENGINE, LAYERS, OPS}
    # the clean calls of Engine.clean are not flagged
    assert not [f for f in r.findings if f.scope == "Engine.clean"]


def test_allocator_encapsulation_bad_fixture_exact_anchors():
    r = bad_report(rule_ids=["allocator-encapsulation"])
    got = {(f.line, f.scope) for f in r.findings}
    assert got == {(37, "Engine.evict"), (38, "Engine.evict"),
                   (39, "Engine.evict")}
    msgs = {f.line: f.message for f in r.findings}
    assert "BlockManager.ref (assignment)" in msgs[37]
    assert "BlockManager.tables (.append())" in msgs[38]
    assert "BlockManager.tables (del)" in msgs[39]
    assert all(f.path == ENGINE for f in r.findings)


def test_counter_parity_bad_fixture_exact_anchors():
    r = bad_report(rule_ids=["counter-parity"])
    eng = [f for f in r.findings if f.path == ENGINE]
    sim = [f for f in r.findings if f.path == SIM]
    assert [(f.line, f.scope) for f in eng] == [(44, "Engine.summary")]
    assert "'preemptions' has no SimResult twin" in eng[0].message
    # oom_events (field) and throughput (@property) both lack summary keys;
    # batch_trace is a List and structurally exempt
    assert {(f.line, f.scope) for f in sim} == \
        {(9, "SimResult"), (13, "SimResult")}
    assert any("'oom_events'" in f.message for f in sim)
    assert any("'throughput'" in f.message for f in sim)


def test_config_wiring_bad_fixture_exact_anchors():
    r = bad_report(rule_ids=["config-wiring"])
    msgs = {(f.line, f.message) for f in r.findings}
    assert all(f.path == CONFIG for f in r.findings)
    assert {line for line, _ in msgs} == {9, 10, 11, 12}
    assert any("dead ServeConfig field 'scheduling_interval': nothing under "
               "src/repro_torch/ reads it" in m for _, m in msgs)
    assert any("'b_min' is not wired through the serving CLI" in m
               for _, m in msgs)
    assert any("'eps_m' is undocumented" in m for _, m in msgs)


def test_config_wiring_reads_only_the_ports_package():
    """A field only the JAX package reads is dead in the port, even when
    the scan sees the JAX package's files; read across all of src/, as
    the JAX rule reads, the same field would pass as read."""
    port = run(Tree(root=FIX / "bad", scan=("src/**/*.py",)),
               rule_ids=["config-wiring"])
    assert any(f.line == 12 and "dead ServeConfig field 'jax_only'"
               in f.message for f in port.findings)
    wide = run(Tree(root=FIX / "bad", scan=("src/**/*.py",), package="src"),
               rule_ids=["config-wiring"])
    assert not any("dead ServeConfig field 'jax_only'" in f.message
                   for f in wide.findings)


def test_good_fixture_clean_under_justified_allowlist():
    allows = [Allow("host-sync", ENGINE, "Engine._retire_step", 1,
                    OK_REASON)]
    r = run(Tree(root=FIX / "good"), allows=allows)
    assert r.ok, (r.findings, r.problems)
    # and without the allowlist the sync point surfaces
    r2 = run(Tree(root=FIX / "good"))
    assert [(f.rule, f.line, f.scope) for f in r2.findings] == \
        [("host-sync", 12, "Engine._retire_step")]


# -- parity with the JAX package's rules ------------------------------------

def _tuples(findings):
    """(rule, path, line, scope, message); the allocator message's closing
    note, which names the guard's history in the JAX package, dropped."""
    return [(f.rule, f.path, f.line, f.scope,
             re.sub(r" \(the [\w -]+ guard\)$", "", f.message))
            for f in findings]


@pytest.mark.parametrize("fixture", ["good", "bad"])
@pytest.mark.parametrize("rule_id", ["allocator-encapsulation",
                                     "counter-parity", "config-wiring"])
def test_rules_match_the_jax_rules_on_the_jax_fixtures(fixture, rule_id):
    want = jax_analysis.run(jax_analysis.Tree(root=JAX_FIX / fixture),
                            rule_ids=[rule_id]).findings
    got = run(Tree(root=JAX_FIX / fixture, package="src",
                   scan=("src/**/*.py", "tests/**/*.py"), **JAX_ANCHORS),
              rule_ids=[rule_id]).findings
    assert _tuples(got) == _tuples(want)
    if fixture == "bad":
        assert got


def test_host_sync_on_the_jax_bad_fixture():
    # the JAX rule's .item() and np.asarray lines; jax.block_until_ready
    # (line 13) is not a torch call
    r = run(Tree(root=JAX_FIX / "bad", package="src/repro",
                 scan=("src/**/*.py",), **JAX_ANCHORS),
            rule_ids=["host-sync"])
    assert [(f.line, f.scope) for f in r.findings] == \
        [(14, "Engine.step"), (15, "Engine.step")]


def test_registries_are_separate():
    assert set(RULES) == {"host-sync", "allocator-encapsulation",
                          "counter-parity", "config-wiring"}
    assert RULES is not jax_analysis.RULES
    assert all(RULES[k] is not jax_analysis.RULES[k] for k in RULES)
    assert all(fn.__module__.startswith("repro_torch.analysis")
               for fn in RULES.values())
    assert all(fn.__module__.startswith("repro.analysis")
               for fn in jax_analysis.RULES.values())


# -- allowlist hygiene -------------------------------------------------------

def test_allowlist_requires_justification():
    allows = [Allow("host-sync", ENGINE, "Engine._retire_step", 1, "perf")]
    r = run(Tree(root=FIX / "good"), allows=allows)
    assert not r.ok
    assert len(r.problems) == 1
    assert "unjustified allowlist entry" in r.problems[0].message
    assert str(MIN_REASON) in r.problems[0].message
    # the finding is NOT suppressed by an unjustified entry
    assert [f.rule for f in r.findings] == ["host-sync"]


def test_allowlist_stale_entry_fails():
    allows = [Allow("host-sync", ENGINE, "Engine._retire_step", 1,
                    OK_REASON),
              Allow("host-sync", ENGINE, "Engine.gone", 2, OK_REASON)]
    r = run(Tree(root=FIX / "good"), allows=allows)
    assert not r.ok and not r.findings
    assert len(r.problems) == 1
    assert "stale allowlist entry" in r.problems[0].message


def test_allowlist_count_drift_fails():
    allows = [Allow("host-sync", ENGINE, "Engine.step", 2, OK_REASON)]
    r = run(Tree(root=FIX / "bad"), rule_ids=["host-sync"], allows=allows)
    assert not r.ok
    assert any("count drift" in p.message and "2 finding(s) but 14 match"
               in p.message for p in r.problems)


def test_port_allowlist_entries_are_justified():
    assert ALLOWLIST
    for a in ALLOWLIST:
        assert len(a.reason.strip()) >= MIN_REASON
        assert a.path == ENGINE and a.scope


# -- seeded violations against a copy of the port's real package -------------

@pytest.fixture()
def seeded(tmp_path):
    """A copy of the port's package, README and docs: the relative paths
    match the repo, so the production ALLOWLIST applies, and the copy is
    clean before seeding."""
    shutil.copytree(REPO / "src" / "repro_torch",
                    tmp_path / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "README.md", tmp_path / "README.md")
    shutil.copytree(REPO / "docs", tmp_path / "docs")
    assert run(Tree(root=tmp_path), allows=ALLOWLIST).ok
    return tmp_path


def seed(root, rel, old="", new="", append=""):
    p = root / rel
    text = p.read_text()
    if old:
        assert text.count(old) == 1, f"seed anchor {old!r} not unique in " \
            f"{rel}"
        text = text.replace(old, new)
    p.write_text(text + append)


def test_seeded_cpu_in_decode_step_caught(seeded):
    anchor = "        sampled = sample(logits[:n], self.generator, " \
        "self.temperature)\n"
    seed(seeded, ENGINE, old=anchor, new=anchor + "        sampled.cpu()\n")
    r = run(Tree(root=seeded), allows=ALLOWLIST)
    assert not r.ok
    assert [(f.rule, f.scope) for f in r.findings] == \
        [("host-sync", "Engine._decode_once")]
    assert r.findings[0].message.startswith(".cpu()")


def test_seeded_tolist_in_model_caught(seeded):
    seed(seeded, LAYERS, append=(
        "\n\ndef _peek(x):\n"
        "    return x.tolist()\n"))
    r = run(Tree(root=seeded), allows=ALLOWLIST)
    assert [(f.rule, f.path, f.scope) for f in r.findings] == \
        [("host-sync", LAYERS, "_peek")]


def test_seeded_extra_sync_in_retire_step_is_count_drift(seeded):
    anchor = "        vals = rec.host.tolist()\n"
    seed(seeded, ENGINE, old=anchor,
         new=anchor + "        torch.cuda.synchronize()\n")
    r = run(Tree(root=seeded), allows=ALLOWLIST)
    assert not r.ok
    assert any("count drift" in p.message and "Engine._retire_step"
               in p.message for p in r.problems)


def test_seeded_blockmanager_mutation_caught(seeded):
    seed(seeded, ENGINE, append=(
        "\n\ndef _drift(blocks, rid):\n"
        "    blocks.tables[rid] = []\n"))
    r = run(Tree(root=seeded), allows=ALLOWLIST)
    assert not r.ok
    assert any(f.rule == "allocator-encapsulation"
               and "BlockManager.tables (assignment)" in f.message
               and f.scope == "_drift" for f in r.findings)


def test_seeded_summary_only_counter_caught(seeded):
    seed(seeded, ENGINE,
         old='"finished": self.total_finished,',
         new='"finished": self.total_finished,\n'
             '            "phantom_counter": 0.0,')
    r = run(Tree(root=seeded), allows=ALLOWLIST)
    assert not r.ok
    assert any(f.rule == "counter-parity" and "'phantom_counter'"
               in f.message for f in r.findings)


def test_seeded_unwired_serveconfig_field_caught(seeded):
    seed(seeded, CONFIG,
         old="    b_max: int = 256",
         new="    b_max: int = 256\n    phantom_knob: int = 0")
    # read in the port so only the CLI wiring is missing
    seed(seeded, ENGINE, append=(
        "\n\ndef _read_phantom(serve):\n"
        "    return serve.phantom_knob\n"))
    r = run(Tree(root=seeded), allows=ALLOWLIST)
    assert not r.ok
    assert any(f.rule == "config-wiring"
               and "'phantom_knob' is not wired" in f.message
               for f in r.findings)


def test_seeded_field_read_only_by_the_jax_package_is_dead(seeded):
    seed(seeded, CONFIG,
         old="    b_max: int = 256",
         new="    b_max: int = 256\n    phantom_dead: int = 0")
    jax_side = seeded / "src" / "repro" / "serving" / "engine.py"
    jax_side.parent.mkdir(parents=True)
    jax_side.write_text("def read(serve):\n    return serve.phantom_dead\n")
    r = run(Tree(root=seeded, scan=("src/**/*.py",)), allows=ALLOWLIST)
    assert any(f.rule == "config-wiring"
               and "dead ServeConfig field 'phantom_dead'" in f.message
               for f in r.findings)


# -- the tier-1 gate: the live tree must be clean ----------------------------

def test_live_tree_clean():
    r = run(Tree(root=REPO), allows=ALLOWLIST)
    assert r.ok, "\n".join(str(f) for f in r.findings + r.problems)
    # the allowlist is fully consumed: every entry matched (no problems)
    # and the engine's sync points stayed within their declared counts
    assert r.per_rule["host-sync"] == sum(
        a.count for a in ALLOWLIST if a.rule == "host-sync")
    assert r.per_rule["counter-parity"] == sum(
        a.count for a in ALLOWLIST if a.rule == "counter-parity")


def test_live_tree_scan_covers_the_port_only():
    files = {p.relative_to(REPO).as_posix()
             for p in Tree(root=REPO).files()}
    assert ENGINE in files and "chip_smoke.py" in files
    assert "tests/test_torch_analysis.py" in files
    assert "examples/torch_quickstart.py" in files
    assert not any(f.startswith(("src/repro/", "tests/fixtures/"))
                   or f in ("tests/test_analysis.py",
                            "examples/quickstart.py") for f in files)


def test_report_json_round_trip(tmp_path):
    r = run(Tree(root=FIX / "bad"), rule_ids=["host-sync"])
    data = json.loads(r.to_json())
    assert data["ok"] is False
    assert data["per_rule"] == {"host-sync": 17}
    assert data["findings"][0]["path"] == OPS
    assert data["findings"][0] == {
        "rule": "host-sync", "path": OPS, "line": 6,
        "message": r.findings[0].message, "scope": "launch"}


def test_cli_lint_only_report(tmp_path):
    from repro_torch.analysis.__main__ import main

    out = tmp_path / "report.json"
    assert main(["--no-graphs", "--root", str(REPO),
                 "--report", str(out)]) == 0
    data = json.loads(out.read_text())
    assert data["ok"] and "graph-audit" not in data["per_rule"]
    assert main(["--no-graphs", "--root", str(FIX / "bad")]) == 1
