"""The port's interprocedural concurrency analyzer and its lock registry,
held against tpudl's (``tpudl.analysis.concurrency``, ``.locks``).

Every source snippet of ``tests/test_concurrency.py`` gives the same
findings (rule, line, message) and the same lock graph through the
port's analyzer as through tpudl's. Every lock ``tpudl_torch`` builds is
a ``named_lock`` with a declaration, a lock that is the twin of one of
tpudl's keeps tpudl's name and rank, and the real tree's acquired-under
edges climb the declared ranks.
"""

import ast
import os
import re
import threading

import pytest

from tpudl.analysis import analyze_sources as tpudl_analyze
from tpudl.analysis import build_lock_graph as tpudl_graph
from tpudl.analysis import LOCKS as TPUDL_LOCKS
from tpudl_torch.analysis import (CONCURRENCY_RULES, LOCK_NAMES, LOCKS,
                                  analyze_sources, build_lock_graph,
                                  iter_python_files, lock_order,
                                  registry_coverage, render_lock_table)
from tpudl_torch.testing import tsan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "tpudl_torch")


def _snippets(test_file: str) -> list:
    """(id, source) of every multi-line source string a tpudl test file
    assigns to a name."""
    tree = ast.parse(open(os.path.join(REPO, "tests", test_file)).read())
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
                if src not in seen:
                    seen.add(src)
                    name = fn.name if isinstance(fn, ast.FunctionDef) \
                        else "mod"
                    out.append((f"{name}-{node.lineno}", src))
    return out


SNIPPETS = _snippets("test_concurrency.py")


def _keyed(findings):
    return sorted((f.rule, f.path, f.line, f.message) for f in findings)


@pytest.mark.parametrize("src", [s for _, s in SNIPPETS],
                         ids=[i for i, _ in SNIPPETS])
def test_findings_and_lock_graph_equal_tpudls(src):
    sources = {"fix.py": src}
    assert _keyed(analyze_sources(sources)) == _keyed(tpudl_analyze(sources))
    ours, theirs = build_lock_graph(sources=sources), \
        tpudl_graph(sources=sources)
    assert sorted((s.lock_id, s.name, s.kind, s.line) for s in ours.locks) \
        == sorted((s.lock_id, s.name, s.kind, s.line) for s in theirs.locks)
    assert sorted(ours.edges) == sorted(theirs.edges)


def test_snippets_cover_every_concurrency_rule():
    fired = {f.rule for _, src in SNIPPETS
             for f in analyze_sources({"fix.py": src})}
    assert set(CONCURRENCY_RULES) <= fired
    assert len(SNIPPETS) >= 25


def test_a_device_sync_under_a_lock_is_blocking():
    src = ("import threading\n"
           "import torch\n"
           "LOCK = threading.Lock()\n"
           "def f(done):\n"
           "    with LOCK:\n"
           "        torch.cuda.synchronize()\n"
           "        done.synchronize()\n")
    fs = [f for f in analyze_sources({"fix.py": src})
          if f.rule == "lock-held-blocking"]
    assert [f.line for f in fs] == [6, 7]
    assert all("device sync" in f.message for f in fs)


# ---------------------------------------------------------------------------
# the lock registry
# ---------------------------------------------------------------------------

def test_every_port_lock_is_named_and_declared():
    cov = registry_coverage([PORT], root=REPO)
    assert cov["undeclared"] == [], cov["undeclared"]
    assert cov["unconstructed"] == [], cov["unconstructed"]
    assert cov["named"] == set(LOCK_NAMES)
    # raw construction only inside the sanitizer's own bookkeeping
    assert cov["anonymous"]
    assert all(a.startswith("tpudl_torch/testing/tsan.py")
               for a in cov["anonymous"]), cov["anonymous"]


def test_no_raw_lock_constructor_outside_the_sanitizer():
    pat = re.compile(r"threading\.(Lock|RLock|Condition)\(")
    offenders = [os.path.relpath(p, REPO)
                 for p in iter_python_files([PORT])
                 if not p.endswith(os.path.join("testing", "tsan.py"))
                 and pat.search(open(p, encoding="utf-8").read())]
    assert offenders == []


def test_declarations_are_wellformed_and_twins_keep_tpudls_rank():
    assert len({d.name for d in LOCKS}) == len(LOCKS)
    theirs = {d.name: d for d in TPUDL_LOCKS}
    graph = build_lock_graph([PORT], root=REPO)
    kinds = {s.name: s.kind for s in graph.locks if s.name}
    for d in LOCKS:
        assert d.kind in ("lock", "rlock") and d.scope in ("module",
                                                           "instance")
        assert d.guards and d.module.startswith("tpudl_torch")
        assert kinds[d.name] == d.kind, d.name
        t = theirs.get(d.name)
        if t is not None:
            assert (d.order, d.scope) == (t.order, t.scope), d.name
    # the twins: every tpudl lock the port's copied modules carry
    assert {"obs.metrics.registry", "obs.flight.recorder",
            "obs.pipeline.ring", "serve.queue", "compile.program_store",
            "data.device_cache", "testing.traceck"} <= set(LOCK_NAMES)
    assert lock_order("obs.metrics.counter") > \
        lock_order("obs.metrics.registry")
    assert lock_order("nope.such.lock") is None
    table = render_lock_table()
    assert all(f"`{d.name}`" in table for d in LOCKS)


def test_the_trees_edges_climb_the_declared_ranks():
    g = build_lock_graph([PORT], root=REPO)
    by_id = {s.lock_id: s for s in g.locks}
    checked = 0
    for (a, b), w in g.edges.items():
        sa, sb = by_id.get(a), by_id.get(b)
        if sa is None or sb is None or not sa.name or not sb.name:
            continue
        checked += 1
        assert lock_order(sb.name) > lock_order(sa.name), (
            f"{sa.name} -> {sb.name} at {w['file']}:{w['line']}")
    assert checked


def test_unarmed_named_lock_is_the_plain_lock():
    prev = tsan.ENABLED
    tsan.disarm()
    try:
        assert type(tsan.named_lock("obs.pipeline.ring")) \
            is type(threading.Lock())
        assert type(tsan.named_lock("compile.program_store",
                                    kind="rlock")) \
            is type(threading.RLock())
    finally:
        tsan.ENABLED = prev
