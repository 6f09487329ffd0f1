#!/usr/bin/env python
"""``python -m tpudl_torch.analysis``: the port's gate — tpudl's
``tools/tpudl_check.py`` over ``tpudl_torch``.

The AST invariant linter (:mod:`tpudl_torch.analysis.checker`'s eight
per-file rules), the four interprocedural concurrency rules over the
whole-tree lock graph (:mod:`tpudl_torch.analysis.concurrency`) and
the five capture-boundary rules (:mod:`tpudl_torch.analysis.traceguard`),
with tpudl's flags, output and exit codes: 0 clean, 2 findings, 1 error
(unparseable file / bad usage / unknown rule id).

Flags:

- ``--list-rules`` prints the rule table;
- ``--rules a,b,c`` runs only the named rules (an unknown id is rc 1:
  a typo must not silently gate nothing);
- ``--json`` emits findings as one JSON object on stdout
  (``{"files": N, "findings": [{file,line,rule,message,hint}],
  "errors": [...]}``);
- ``--registry-audit`` prints the declared-vs-used delta for the
  knob/metric registries and exits 2 when they drift;
- ``--sarif <path>`` additionally writes the findings as SARIF 2.1.0;
- ``--allow-stale-in <csv>`` exempts path prefixes from the
  stale-suppression audit (fixture trees keep deliberately-stale
  examples).

Full runs also audit suppressions themselves: an ``# tpudl:
ignore[rule] — reason`` whose line no longer produces a finding under
that rule is reported as ``stale-suppression``.
"""

from __future__ import annotations

import json
import os
import sys
import time

from tpudl_torch.analysis import (RULES, check_paths, collect_usage,
                                  is_declared_metric, iter_python_files,
                                  CONCURRENCY_RULES, analyze_sources,
                                  TRACE_RULES, analyze_trace_sources,
                                  Finding, KNOB_NAMES, METRIC_NAMES,
                                  METRIC_PATTERNS)
from tpudl_torch.analysis.checker import _HINTS
from tpudl_torch.analysis.concurrency import link_sources, read_sources
from tpudl_torch.analysis.metric_names import matches_pattern_prefix

USAGE = ("usage: python -m tpudl_torch.analysis [--list-rules] "
         "[--registry-audit] "
         "[--rules <csv>] [--json] [--sarif <path>] "
         "[--allow-stale-in <csv>] <path> [path ...]")


GRAPH_RULES = frozenset(CONCURRENCY_RULES) | frozenset(TRACE_RULES)


# copied from tools/tpudl_check.py:_stale_findings
def _stale_findings(sinks, allow_prefixes=(), root: str = ".",
                    graph_scope: bool = True) -> list:
    """The stale-suppression audit: a suppression (file, comment line,
    rule) declared in any half but USED (= it absorbed a finding) in
    none is itself a finding — the code it silenced has moved, and the
    comment now hides nothing but reviewer attention. ``sinks`` are
    the per-half ``{file: {line: [Suppression]}}`` maps; usage merges
    across halves (a concurrency suppression is legitimately unused by
    the per-file half). Files under an ``allow_prefixes`` entry are
    exempt (fixture trees keep deliberately-stale examples).

    Per-file-rule suppressions are judged unconditionally — the file
    itself is the complete evidence. Interprocedural (concurrency +
    trace) rule suppressions are judged only with ``graph_scope``
    True: a subtree scan truncates the call graph, and 'absorbed
    nothing' over a truncated graph proves nothing (a legitimate
    daemon-shared-write suppression whose thread-spawning callers live
    outside the scanned subtree must not read as rot)."""
    declared: dict = {}   # (file, comment_line, rule) -> Suppression
    used: set = set()
    for sink in sinks:
        for file, by_line in sink.items():
            for sups in by_line.values():
                for sup in sups:
                    for r in sup.rules:
                        if not graph_scope:
                            if r in GRAPH_RULES:
                                continue
                            if r == "stale-suppression" and \
                                    sup.rules & GRAPH_RULES:
                                # a keeper guarding a SKIPPED graph
                                # rule cannot be judged 'kept nothing'
                                continue
                        declared.setdefault((file, sup.line, r), sup)
                        if r in sup.used:
                            used.add((file, sup.line, r))
    def _under(path: str, prefix: str) -> bool:
        # SEGMENT-aware: tests/fixtures must not exempt the sibling
        # tests/fixtures_extra/ or tests/fixtures.py
        return path == prefix or path.startswith(prefix + "/")

    def _allowed(file: str) -> bool:
        f = file.replace(os.sep, "/")
        # relative finding paths were computed against the audit's
        # ``root``, not the process cwd — resolve them the same way
        fa = os.path.abspath(
            file if os.path.isabs(file) else os.path.join(root, file)
        ).replace(os.sep, "/")
        for p in allow_prefixes:
            if not p:
                continue
            q = p.replace(os.sep, "/").rstrip("/")
            # cwd-independence: a CI line lints ../some/tree while
            # exempting an absolute fixture path (or vice versa)
            qa = os.path.abspath(q).replace(os.sep, "/")
            if _under(f, q) or _under(fa, qa):
                return True
        return False

    out = []
    stale = [k for k in sorted(set(declared) - used)
             if not _allowed(k[0])]
    # the audit's own findings honor the shared grammar: an
    # ignore[stale-suppression] on the same comment line KEEPS a
    # deliberately-stale suppression (reason required as ever)
    keepers = {(f, ln): s for (f, ln, r), s in declared.items()
               if r == "stale-suppression"}
    reasonless_emitted: set = set()
    for (file, line, rule) in stale:
        if rule == "stale-suppression":
            continue   # the keepers themselves are judged below
        sup = declared[(file, line, rule)]
        keeper = keepers.get((file, line))
        if keeper is not None:
            keeper.used.add("stale-suppression")
            if not keeper.reason and (file, line) not in \
                    reasonless_emitted:
                reasonless_emitted.add((file, line))
                out.append(Finding(
                    file, line, keeper.col, "stale-suppression",
                    "suppression for [stale-suppression] is missing "
                    "its required reason",
                    "write the why after the bracket: "
                    "# tpudl: ignore[rule] — <reason>"))
            continue
        out.append(Finding(
            file, line, sup.col, "stale-suppression",
            f"suppression for [{rule}] absorbed no finding — the code "
            f"it silenced has moved or been fixed",
            _HINTS.get("stale-suppression", "")))
    for (file, line, rule) in stale:
        # a keeper that kept nothing is itself stale
        if rule != "stale-suppression":
            continue
        sup = declared[(file, line, rule)]
        if "stale-suppression" in sup.used:
            continue
        out.append(Finding(
            file, line, sup.col, "stale-suppression",
            "suppression for [stale-suppression] absorbed no finding "
            "— the code it silenced has moved or been fixed",
            _HINTS.get("stale-suppression", "")))
    return out


# copied from tools/tpudl_check.py:collect_findings
def collect_findings(paths, root: str = ".", rules=None,
                     allow_stale_in=()):
    """(findings, errors) across ALL THREE halves — the per-file
    rules, the interprocedural concurrency rules, and the jit-boundary
    trace rules — plus the stale-suppression audit, optionally
    restricted to ``rules``. The one entry point the CLI and the tests
    share; the tree is read ONCE and the source map fed to every half.

    The stale audit needs COMPLETE usage marks, so it runs only on
    full-rule runs (or when ``stale-suppression`` is explicitly in
    ``rules``, which forces the other halves to evaluate everything
    internally and filters their findings afterwards)."""
    findings = []
    rule_set = set(rules) if rules is not None else None
    want_stale = rule_set is None or "stale-suppression" in rule_set
    # judging staleness requires every rule to have RUN (an unused
    # mark on a rule nobody evaluated proves nothing)
    internal = None if want_stale else rule_set
    sources, modules, errors = read_sources(paths, root=root)
    supp_pf: dict = {}
    supp_cc: dict = {}
    supp_tg: dict = {}
    # the per-file half always runs: it carries the parse errors and
    # the bad-suppression findings (a typo'd ignore must surface no
    # matter which rules were selected); its rule findings are filtered
    per_file, errs = check_paths(paths, root=root, sources=sources,
                                 supp_sink=supp_pf)
    if rule_set is not None:
        per_file = [f for f in per_file
                    if f.rule in rule_set or f.rule == "bad-suppression"]
    findings.extend(per_file)
    errors.extend(e for e in errs if e not in errors)
    want_conc = internal is None or internal & set(CONCURRENCY_RULES)
    want_trace = internal is None or internal & set(TRACE_RULES)
    # ONE parse for both interprocedural halves (the per-file half's
    # own walk above is its analysis, not just a parse)
    linked = link_sources(sources, modules) if (want_conc or
                                                want_trace) else None
    if want_conc:
        conc = analyze_sources(
            sources, modules=modules, supp_sink=supp_cc, linked=linked,
            rules=(internal & set(CONCURRENCY_RULES)
                   if internal is not None else None))
        if rule_set is not None:
            conc = [f for f in conc if f.rule in rule_set]
        findings.extend(conc)
    if want_trace:
        trace = analyze_trace_sources(
            sources, modules=modules, supp_sink=supp_tg, linked=linked,
            rules=(internal & set(TRACE_RULES)
                   if internal is not None else None))
        if rule_set is not None:
            trace = [f for f in trace if f.rule in rule_set]
        findings.extend(trace)
    if want_stale:
        # graph-rule suppressions are judged only when the scan covers
        # whole ROOT trees including at least one directory (the
        # canonical gate shape: `tpudl_torch`).
        # `tpudl_torch/testing` scans a SUB-package (its parent
        # carries __init__.py — the graph is truncated) and
        # `chip_smoke.py` alone has no package graph at all —
        # either truncation makes 'absorbed nothing' prove nothing
        # about rot. Judged off the paths' own package structure, so
        # absolute paths / foreign cwd behave identically to the
        # in-repo relative invocation.
        def _sub_scope(p):
            parent = os.path.dirname(os.path.abspath(p))
            return os.path.exists(os.path.join(parent, "__init__.py"))

        graph_scope = any(os.path.isdir(p) for p in paths) and \
            not any(_sub_scope(p) for p in paths)
        findings.extend(_stale_findings((supp_pf, supp_cc, supp_tg),
                                        allow_stale_in, root=root,
                                        graph_scope=graph_scope))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings, errors


# copied from tools/tpudl_check.py:run_check
def run_check(paths, root: str = ".", out=sys.stderr, rules=None,
              allow_stale_in=()):
    """(findings, errors) with findings rendered to ``out``."""
    findings, errors = collect_findings(paths, root=root, rules=rules,
                                        allow_stale_in=allow_stale_in)
    for f in findings:
        print(f.render(), file=out)
    for e in errors:
        print(f"ERROR: {e}", file=out)
    return findings, errors


# copied from tools/tpudl_check.py:to_sarif
def to_sarif(findings, errors, rules=None) -> dict:
    """Findings as a SARIF 2.1.0 log (one run, one driver) so CI and
    code-review tooling can ingest the gate."""
    rule_ids = sorted(set(rules) if rules is not None else set(RULES))
    if "bad-suppression" not in rule_ids:
        rule_ids.append("bad-suppression")
    return {
        "version": "2.1.0",
        "$schema": "https://raw.githubusercontent.com/oasis-tcs/"
                   "sarif-spec/master/Schemata/sarif-schema-2.1.0.json",
        "runs": [{
            "tool": {"driver": {
                "name": "tpudl-check",
                "rules": [
                    {"id": r,
                     "shortDescription": {
                         "text": RULES.get(
                             r, "suppression names an unknown rule id")},
                     **({"help": {"text": _HINTS[r]}}
                        if r in _HINTS else {})}
                    for r in rule_ids],
            }},
            "results": [
                {"ruleId": f.rule,
                 "level": "warning",
                 "message": {"text": f.message
                             + (f" (hint: {f.hint})" if f.hint else "")},
                 "locations": [{"physicalLocation": {
                     "artifactLocation": {"uri": f.path},
                     "region": {"startLine": max(int(f.line), 1),
                                "startColumn": max(int(f.col) + 1, 1)},
                 }}]}
                for f in findings],
            "invocations": [{
                "executionSuccessful": not errors,
                "toolExecutionNotifications": [
                    {"level": "error", "message": {"text": e}}
                    for e in errors],
            }],
        }],
    }


# copied from tools/tpudl_check.py:write_sarif
def write_sarif(path: str, findings, errors, rules=None) -> None:
    """Atomic write (tmp + os.replace — the artifact contract)."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(to_sarif(findings, errors, rules=rules), f, indent=1)
    os.replace(tmp, path)


# copied from tools/tpudl_check.py:registry_audit
def registry_audit(paths, root: str = ".") -> list[str]:
    """Declared-vs-used drift lines (empty = registries in sync)."""
    usage = collect_usage(paths, root=root)
    drift = []
    for name in sorted(usage["knobs"] - KNOB_NAMES):
        drift.append(f"knob used but not declared: {name}")
    for name in sorted(KNOB_NAMES - usage["knobs"]):
        drift.append(f"knob declared but never read: {name}")
    for name in sorted(usage["metrics"] - METRIC_NAMES):
        if not is_declared_metric(name):
            drift.append(f"metric used but not declared: {name}")
    for name in sorted(METRIC_NAMES - usage["metrics"]):
        drift.append(f"metric declared but never published: {name}")
    used_ht = usage["metric_patterns"]
    for pat in METRIC_PATTERNS:
        head, _, tail = pat.partition("*")
        if (head, tail) not in used_ht:
            drift.append(f"metric pattern declared but never used: {pat}")
    for head, tail in sorted(used_ht):
        if not matches_pattern_prefix(head, tail):
            drift.append(f"dynamic metric family used but not "
                         f"declared: {head}*{tail}")
    return drift


# copied from tools/tpudl_check.py:main
def main(argv) -> int:
    args = list(argv[1:])
    if "--list-rules" in args:
        for rule, desc in RULES.items():
            scope = ("interprocedural" if rule in CONCURRENCY_RULES
                     else "trace" if rule in TRACE_RULES
                     else "gate" if rule == "stale-suppression"
                     else "per-file")
            print(f"{rule:22s} [{scope}] {desc}")
        return 0
    audit = "--registry-audit" in args
    if audit:
        args.remove("--registry-audit")
    as_json = "--json" in args
    if as_json:
        args.remove("--json")
    class _BadFlag(Exception):
        pass

    def _take_value(flag: str, what: str) -> str | None:
        """Pop ``<flag> <value>`` from args; None when absent. The ONE
        find/validate/delete block for every value-taking flag."""
        if flag not in args:
            return None
        i = args.index(flag)
        if i + 1 >= len(args) or args[i + 1].startswith("-"):
            print(f"ERROR: {flag} needs {what}", file=sys.stderr)
            print(USAGE, file=sys.stderr)
            raise _BadFlag()
        value = args[i + 1]
        del args[i:i + 2]
        return value

    try:
        sarif_path = _take_value("--sarif", "an output path")
        stale_csv = _take_value("--allow-stale-in",
                                "a comma-separated path-prefix list")
        rules_csv = _take_value("--rules",
                                "a comma-separated rule list")
    except _BadFlag:
        return 1
    allow_stale_in: tuple = ()
    if stale_csv is not None:
        allow_stale_in = tuple(
            p.strip().replace(os.sep, "/")
            for p in stale_csv.split(",") if p.strip())
    rules = None
    if rules_csv is not None:
        rules = {r.strip() for r in rules_csv.split(",") if r.strip()}
        unknown = rules - set(RULES)
        if unknown or not rules:
            # the suppression-typo contract: an unknown rule id must
            # not silently run nothing and report clean
            print(f"ERROR: unknown rule id(s) in --rules: "
                  f"{sorted(unknown) or '(empty)'}", file=sys.stderr)
            print("known rules: " + ", ".join(sorted(RULES)),
                  file=sys.stderr)
            return 1
    unknown_flags = [a for a in args if a.startswith("-")]
    if unknown_flags:
        # a typo'd --registry-adit must NOT silently run a plain lint
        # and report the audit as passed
        print(f"ERROR: unknown option(s): {unknown_flags}", file=sys.stderr)
        print(USAGE, file=sys.stderr)
        return 1
    paths = args
    if not paths:
        print(USAGE, file=sys.stderr)
        return 1
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        print(f"ERROR: no such path(s): {missing}", file=sys.stderr)
        return 1
    unlintable = [p for p in paths
                  if os.path.isfile(p) and not p.endswith(".py")]
    if unlintable:
        # an explicit file arg the scanner would drop means a CI line
        # pointed at the wrong path is gating NOTHING — be loud
        print(f"ERROR: not python file(s): {unlintable}", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    if audit:
        drift = registry_audit(paths)
        for line in drift:
            print(f"DRIFT: {line}", file=sys.stderr)
        print(f"registry audit: {'in sync' if not drift else str(len(drift)) + ' drift(s)'}")
        return 2 if drift else 0
    if as_json:
        findings, errors = collect_findings(paths, rules=rules,
                                            allow_stale_in=allow_stale_in)
        print(json.dumps({
            "schema": "tpudl-check-findings",
            "files": len(iter_python_files(paths)),
            "rules": sorted(rules) if rules is not None else sorted(RULES),
            "findings": [{"file": f.path, "line": f.line, "col": f.col,
                          "rule": f.rule, "message": f.message,
                          "hint": f.hint} for f in findings],
            "errors": errors,
        }, indent=1))
    else:
        findings, errors = run_check(paths, rules=rules,
                                     allow_stale_in=allow_stale_in)
        dt = time.perf_counter() - t0
        n_files = len(iter_python_files(paths))
        print(f"tpudl-check: {n_files} files, {len(findings)} finding(s), "
              f"{len(errors)} error(s) in {dt:.2f}s")
    if sarif_path is not None:
        write_sarif(sarif_path, findings, errors, rules=rules)
    if errors:
        return 1
    return 2 if findings else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
