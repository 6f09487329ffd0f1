"""The port's per-file checker, its registries and its gate, held against
tpudl's (``tpudl.analysis`` and ``tools/tpudl_check.py``).

The checker's rules are tpudl's: every source snippet of
``tests/test_analysis.py`` gives the same findings (rule, line, column)
through ``tpudl_torch.analysis.check_source`` as through tpudl's, except
for the two registry rules, whose registries hold each package's own
names. The knob and metric registries round-trip over ``tpudl_torch``,
and ``python -m tpudl_torch.analysis tpudl_torch`` is a clean gate with
tpudl's exit codes, ``--json`` and ``--sarif``.
"""

import ast
import importlib.util
import json
import os
import subprocess
import sys

import pytest

from tpudl.analysis import check_source as tpudl_check_source
from tpudl_torch.analysis import (KNOB_NAMES, KNOBS, METRIC_NAMES, RULES,
                                  check_source, collect_usage,
                                  is_declared_metric, render_knob_table,
                                  render_metric_table)
from tpudl_torch.analysis import __main__ as gate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "tpudl_torch")
REGISTRY_RULES = {"undeclared-knob", "undeclared-metric"}


def _snippets(test_file: str) -> list:
    """(id, source) of every multi-line source string a tpudl test file
    assigns to a name: the fixtures its rule tests run."""
    path = os.path.join(REPO, "tests", test_file)
    tree = ast.parse(open(path).read())
    out, seen = [], set()
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.Module)):
            continue
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Constant) and \
                    isinstance(node.value.value, str) and \
                    "\n" in node.value.value:
                src = node.value.value
                try:
                    ast.parse(src)
                except SyntaxError:
                    continue
                if src in seen:
                    continue
                seen.add(src)
                name = fn.name if isinstance(fn, ast.FunctionDef) else "mod"
                out.append((f"{name}-{node.lineno}", src))
    return out


ANALYSIS_SNIPPETS = _snippets("test_analysis.py")


def _keyed(findings):
    return sorted((f.rule, f.line, f.col) for f in findings
                  if f.rule not in REGISTRY_RULES)


@pytest.mark.parametrize("src", [s for _, s in ANALYSIS_SNIPPETS],
                         ids=[i for i, _ in ANALYSIS_SNIPPETS])
def test_checker_findings_equal_tpudls(src):
    for rel in ("pkg/mod.py", "tpudl/jobs/retry.py"):
        theirs = tpudl_check_source(src, rel, rel)
        ours = check_source(src, rel.replace("tpudl/", "tpudl_torch/"),
                            rel.replace("tpudl/", "tpudl_torch/"))
        assert _keyed(ours) == _keyed(theirs)


def test_snippets_cover_every_per_file_rule():
    fired = {f.rule for _, src in ANALYSIS_SNIPPETS
             for f in check_source(src, "pkg/mod.py", "pkg/mod.py")}
    assert {"hot-sync", "atomic-write", "signal-handler", "adhoc-retry",
            "swallowed-except", "unlocked-global"} <= fired
    assert len(ANALYSIS_SNIPPETS) >= 50


@pytest.mark.parametrize("call, what", [
    ("torch.cuda.synchronize()", "torch.cuda.synchronize"),
    ("done.synchronize()", ".synchronize"),
    ("loss.item()", ".item()"),
    ("x.cpu()", ".cpu()"),
    ("x.tolist()", ".tolist()"),
])
def test_hot_sync_knows_torch_syncs(call, what):
    src = ("import torch\n"
           "def run(report, x, loss, done):\n"
           "    with report.stage('dispatch'):\n"
           f"        y = {call}\n"
           "    return y\n")
    fs = [f for f in check_source(src, "pkg/mod.py", "pkg/mod.py")
          if f.rule == "hot-sync"]
    assert [f.line for f in fs] == [4] and what in fs[0].message
    # the same call outside a hot stage is quiet
    cold = src.replace("with report.stage('dispatch')",
                       "with report.stage('dispatch_wait')")
    assert not [f for f in check_source(cold, "p.py", "p.py")
                if f.rule == "hot-sync"]


def test_the_one_retry_policy_is_the_ports():
    src = ("import time\n"
           "def f(g):\n"
           "    try:\n"
           "        g()\n"
           "    except OSError:\n"
           "        time.sleep(1)\n")
    rel = "tpudl_torch/jobs/retry.py"
    assert not check_source(src, rel, rel)
    assert [f.rule for f in check_source(src, "pkg/m.py", "pkg/m.py")] == \
        ["adhoc-retry"]
    assert "tpudl_torch/jobs/retry.py" in RULES["adhoc-retry"]


def test_rule_catalog_is_tpudls():
    from tpudl.analysis import RULES as TPUDL_RULES
    from tpudl.analysis.checker import _HINTS as TPUDL_HINTS
    from tpudl_torch.analysis.checker import _HINTS

    assert set(RULES) == set(TPUDL_RULES)
    assert set(_HINTS) == set(TPUDL_HINTS)
    # the trace rules' hints name torch idioms, never lax
    for rule in ("trace-time-effect", "host-op-on-traced", "traced-branch",
                 "jit-cache-churn"):
        assert "lax" not in _HINTS[rule] and "jnp" not in _HINTS[rule]


# ---------------------------------------------------------------------------
# registries
# ---------------------------------------------------------------------------

def test_registries_round_trip_over_the_port():
    drift = gate.registry_audit([PORT], root=REPO)
    assert drift == [], "\n".join(drift)


def test_knob_registry_is_tpudls_where_they_share_a_knob():
    from tpudl.analysis import KNOBS as TPUDL_KNOBS

    theirs = {k.name: k for k in TPUDL_KNOBS}
    usage = collect_usage([PORT], root=REPO)
    assert usage["knobs"] == set(KNOB_NAMES)
    for k in KNOBS:
        assert k.name in theirs, k.name
        assert (k.kind, k.subsystem) == (theirs[k.name].kind,
                                         theirs[k.name].subsystem)
    for name in ("TPUDL_TSAN", "TPUDL_TSAN_DEADLOCK_S", "TPUDL_TRACECK",
                 "TPUDL_TRACECK_STORM"):
        assert name in KNOB_NAMES
    table = render_knob_table()
    assert all(f"`{k.name}`" in table for k in KNOBS)


def test_metric_registry_declares_the_ports_own_names():
    for name in ("compile.programs", "compile.restore_skipped",
                 "compile.storms", "mesh.allreduce.calls",
                 "mesh.allreduce.bytes", "obs.profile.captures",
                 "obs.profile.head_lost", "obs.profile.truncated",
                 "tsan.lock_order_inversions", "tsan.deadlocks",
                 "tsan.lockset_violations", "traceck.traces",
                 "traceck.retraces", "traceck.storms"):
        assert name in METRIC_NAMES, name
    assert is_declared_metric("frame.stage.dispatch.seconds")
    usage = collect_usage([PORT], root=REPO)
    assert usage["metrics"] <= METRIC_NAMES
    assert "`compile.storms`" in render_metric_table()


# ---------------------------------------------------------------------------
# the gate
# ---------------------------------------------------------------------------

def _tpudl_cli():
    spec = importlib.util.spec_from_file_location(
        "tpudl_check", os.path.join(REPO, "tools", "tpudl_check.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_port_is_a_clean_gate():
    findings, errors = gate.collect_findings([PORT], root=REPO)
    assert errors == []
    assert findings == [], "\n".join(f.render() for f in findings)


FIXTURE = ("import time\n"
           "def f(g):\n"
           "    try:\n"
           "        g()\n"
           "    except Exception:\n"
           "        pass\n")


@pytest.mark.parametrize("argv, files", [
    (["{d}"], {"clean.py": "x = 1\n"}),
    (["{d}"], {"dirty.py": FIXTURE}),
    (["--rules", "swallowed-except", "{d}"], {"dirty.py": FIXTURE}),
    (["--rules", "hot-sync", "{d}"], {"dirty.py": FIXTURE}),
    (["--rules", "no-such-rule", "{d}"], {"dirty.py": FIXTURE}),
    (["--registry-adit", "{d}"], {"clean.py": "x = 1\n"}),
    (["--sarif"], {"clean.py": "x = 1\n"}),
    (["{d}/missing"], {}),
    ([], {}),
    (["{d}"], {"broken.py": "def f(:\n"}),
], ids=["clean", "findings", "rules", "other-rule", "unknown-rule",
        "typo-flag", "sarif-no-path", "missing-path", "no-path",
        "unparseable"])
def test_exit_codes_are_tpudls(tmp_path, capsys, argv, files):
    for name, src in files.items():
        (tmp_path / name).write_text(src)
    args = [a.format(d=tmp_path) for a in argv]
    rc_theirs = _tpudl_cli().main(["tpudl_check.py", *args])
    rc_ours = gate.main(["tpudl_torch.analysis", *args])
    capsys.readouterr()
    assert rc_ours == rc_theirs
    assert rc_ours in (0, 1, 2)


def test_json_and_sarif_are_tpudls(tmp_path, capsys):
    (tmp_path / "dirty.py").write_text(FIXTURE)
    outs = {}
    for name, main in (("theirs", _tpudl_cli().main),
                       ("ours", gate.main)):
        sarif = tmp_path / f"{name}.sarif"
        rc = main(["x", "--json", "--sarif", str(sarif), str(tmp_path)])
        assert rc == 2
        doc = json.loads(capsys.readouterr().out)
        outs[name] = (doc, json.loads(sarif.read_text()))
    (j1, s1), (j2, s2) = outs["theirs"], outs["ours"]
    assert j2["schema"] == j1["schema"] and j2["files"] == j1["files"]
    assert [(f["rule"], f["line"], f["col"]) for f in j2["findings"]] == \
        [(f["rule"], f["line"], f["col"]) for f in j1["findings"]]
    assert s2["version"] == s1["version"] == "2.1.0"
    r1, r2 = s1["runs"][0], s2["runs"][0]
    assert sorted(r["id"] for r in r2["tool"]["driver"]["rules"]) == \
        sorted(r["id"] for r in r1["tool"]["driver"]["rules"])
    assert [(r["ruleId"], r["locations"][0]["physicalLocation"]["region"])
            for r in r2["results"]] == \
        [(r["ruleId"], r["locations"][0]["physicalLocation"]["region"])
         for r in r1["results"]]


def test_list_rules_and_stale_audit(tmp_path, capsys):
    assert gate.main(["x", "--list-rules"]) == 0
    listed = capsys.readouterr().out
    assert all(rule in listed for rule in RULES)
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    (pkg / "m.py").write_text(
        "x = 1  # tpudl: ignore[swallowed-except] — nothing here\n")
    assert gate.main(["x", "--json", str(pkg)]) == 2
    doc = json.loads(capsys.readouterr().out)
    assert [f["rule"] for f in doc["findings"]] == ["stale-suppression"]
    assert gate.main(["x", "--allow-stale-in", str(pkg), str(pkg)]) == 0
    capsys.readouterr()


def test_python_dash_m_runs_the_gate(tmp_path):
    (tmp_path / "dirty.py").write_text(FIXTURE)
    env = dict(os.environ, PYTHONPATH=REPO)
    run = subprocess.run(
        [sys.executable, "-m", "tpudl_torch.analysis", "--json",
         str(tmp_path)], capture_output=True, text=True, env=env,
        timeout=120, cwd=REPO)
    assert run.returncode == 2, run.stderr
    assert json.loads(run.stdout)["findings"][0]["rule"] == \
        "swallowed-except"
