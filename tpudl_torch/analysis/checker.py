"""AST invariant checker: tpudl's eight per-file rules over the port.

Port of ``tpudl/analysis/checker.py``. The rules, their ids and the
suppression contract are tpudl's (ANALYSIS.md documents the history and
the fix idiom per rule); the paths they name are the port's:

- ``hot-sync``          blocking device sync on the executor hot path
                        (``torch.cuda.synchronize``, an event's or a
                        stream's ``.synchronize()``, ``.item()``,
                        ``.cpu()``, ``.tolist()``, a bare ``.result()``/
                        ``.wait()``, a one-argument ``np.asarray``)
- ``atomic-write``      durable artifact written without tmp+os.replace
- ``signal-handler``    more than flag-sets/os.write in signal context
- ``adhoc-retry``       sleep-in-except/loop outside
                        ``tpudl_torch/jobs/retry.py``
- ``swallowed-except``  bare/broad except that swallows silently
- ``undeclared-knob``   TPUDL_* literal missing from the knob registry
- ``undeclared-metric`` obs metric literal missing from the name registry
- ``unlocked-global``   global rebound without a lock in a threaded
                        module

Suppression: ``# tpudl: ignore[rule-id] — reason`` on the flagged line
or alone on the line above. The reason is REQUIRED — a reasonless
ignore is itself a finding. ``# tpudl: hot-path`` on (or above) a
``def`` marks that one function hot for ``hot-sync``; the executor's
``with report.stage("dispatch"|"d2h"|"h2d")`` blocks are hot
implicitly.

Pure stdlib + the two sibling registries; importable
(``from tpudl_torch.analysis import check_paths``) and runnable via
``python -m tpudl_torch.analysis`` (exit 0 clean / 2 findings / 1 error,
the validator convention).
"""

from __future__ import annotations

import ast
import io
import os
import re
import tokenize
from dataclasses import dataclass, field

from . import knobs as _knobs
from . import metric_names as _metric_names

__all__ = ["Finding", "RULES", "Suppression", "check_source",
           "check_file", "check_paths", "collect_usage",
           "iter_python_files"]

RULES: dict[str, str] = {
    "hot-sync": "blocking device sync (torch.cuda.synchronize/"
                ".synchronize()/.item()/.cpu()/.tolist()/np.asarray/"
                "bare .result()/.wait() on an in-flight future) on the "
                "executor hot path",
    "atomic-write": "durable artifact opened for write without the "
                    "tmp + os.replace idiom in the same function",
    "signal-handler": "signal handler does more than set flags / "
                      "os.write / chain the previous handler",
    "adhoc-retry": "time.sleep in an except/retry loop outside "
                   "tpudl_torch/jobs/retry.py (use RetryPolicy)",
    "swallowed-except": "bare or over-broad except that swallows the "
                        "exception without re-raise or logging",
    "undeclared-knob": "TPUDL_* env literal not declared in "
                       "tpudl_torch/analysis/knobs.py",
    "undeclared-metric": "obs metric name not declared in "
                         "tpudl_torch/analysis/metric_names.py",
    "unlocked-global": "module global rebound outside a lock in a "
                       "module that spawns threads",
    # the four INTERPROCEDURAL rules (tpudl_torch.analysis.concurrency —
    # they reason over the whole tree at once; listed here so the
    # suppression grammar and --list-rules see one catalog)
    "lock-order": "cycle in the acquired-under lock graph (ABBA "
                  "deadlock risk across any number of call hops)",
    "lock-held-blocking": "lock held across a blocking operation "
                          "(bounded-queue put / join / device sync / "
                          "durable IO / subprocess / sleep), directly "
                          "or through a callee",
    "signal-lock": "lock acquisition interprocedurally reachable from "
                   "a signal.signal-registered handler",
    "daemon-shared-write": "attribute/global written from both a "
                           "thread-reachable function and foreground "
                           "code with no common lock",
    # the five TRACE rules (tpudl_torch.analysis.traceguard — the
    # capture boundary: which functions a CUDA graph records, and what
    # must never happen inside them)
    "trace-time-effect": "host side effect (obs counter/gauge, flight "
                         "breadcrumb, env read, print/logging) inside "
                         "captured code — it runs ONCE at capture and "
                         "never on a replay",
    "host-op-on-traced": "np.* call or .item()/.cpu()/.numpy()/"
                         ".tolist()/float()/int()/bool() on a tensor "
                         "inside captured code (a sync: it fails the "
                         "capture or bakes one value in)",
    "traced-branch": "Python if/while on a tensor's value inside "
                     "captured code (the branch taken at capture is "
                     "baked into every replay)",
    "donation-reuse": "a buffer passed to a donating wrapper and read "
                      "again afterwards in the same scope (the donated "
                      "buffer is dead)",
    "jit-cache-churn": "a fresh closure handed to the program store or "
                       "to a capture per call or per loop iteration — "
                       "every call captures a new CUDA graph",
    # the gate's self-audit (python -m tpudl_torch.analysis full runs)
    "stale-suppression": "an '# tpudl: ignore[rule]' comment whose "
                         "line no longer produces a finding under "
                         "that rule (the suppression has rotted as "
                         "code moved)",
}

_HINTS: dict[str, str] = {
    "hot-sync": "keep the hot path async (record an event, wait in the "
                "dispatch_wait stage); if the sync IS this stage's job, "
                "suppress with the reason",
    "atomic-write": "write to <path>.tmp.<pid> then os.replace() it "
                    "into place (the shard-manifest contract)",
    "signal-handler": "set a flag (threading.Event) and do the work at "
                      "the next boundary on a normal thread",
    "adhoc-retry": "route through tpudl_torch.jobs.retry.RetryPolicy (e.g. "
                   "io_policy()) so attempts/backoff are counted",
    "swallowed-except": "narrow the except, re-raise, or record a "
                        "breadcrumb (flight recorder / obs counter / "
                        "log) before continuing",
    "undeclared-knob": "add a Knob(...) entry to "
                       "tpudl_torch/analysis/knobs.py",
    "undeclared-metric": "add a Metric(...) entry to "
                         "tpudl_torch/analysis/metric_names.py",
    "unlocked-global": "guard the write with the module's lock, or use "
                       "a bounded thread-safe structure",
    "lock-order": "acquire in registry rank order (tpudl_torch/"
                  "analysis/locks.py) — release the outer lock "
                  "first, or merge the critical sections",
    "lock-held-blocking": "move the blocking call outside the with "
                          "block (snapshot under the lock, do the slow "
                          "work after release)",
    "signal-lock": "signal handlers set flags only (JOBS.md): do the "
                   "locked work at the next boundary on a normal "
                   "thread",
    "daemon-shared-write": "take the structure's named_lock at BOTH "
                           "write sites, or make one side copy-on-read",
    "trace-time-effect": "move the effect outside the captured fn "
                         "(count at the dispatch or replay site, read "
                         "env before capturing)",
    "host-op-on-traced": "keep the value a tensor (torch.where, "
                         "tensor ops on the device); read it on the "
                         "host AFTER the replay returns (and outside "
                         "hot stages — see hot-sync)",
    "traced-branch": "branch on static shape/dtype info, or select on "
                     "the device with torch.where / masked ops",
    "donation-reuse": "copy before donating, or stop reading the "
                      "buffer after dispatch",
    "jit-cache-churn": "build the function once and keep it (a "
                       "module-level def, a method, or a cache keyed "
                       "on the inputs: the stages' _cached_fn); keep "
                       "static args hashable (tuples, not lists)",
    "stale-suppression": "delete the ignore comment, or re-anchor it "
                         "to the line that still produces the finding",
}

_KNOB_RE = re.compile(r"TPUDL_[A-Z0-9_]+\Z")
_SUPPRESS_RE = re.compile(
    r"#\s*tpudl:\s*ignore\[([a-z\-, ]+)\]\s*[-–—:]?\s*(.*)")
_HOT_RE = re.compile(r"#\s*tpudl:\s*hot-path\b")
_HOT_STAGES = {"dispatch", "d2h", "h2d"}
_DURABLE_RE = re.compile(
    r"manifest|status|dump|checkpoint|ckpt|summary|"
    r"\.(json|jsonl|npy|npz)\b", re.IGNORECASE)
_METRIC_CALLS = {"counter", "gauge", "histogram"}
_BROAD_EXC = {"Exception", "BaseException"}
# calls that are legitimate from signal context: async-signal-safe
# syscalls, handler re-registration — matched by DOTTED form so a
# buffered logfile.write() or pool.kill() doesn't ride the os.* pass
_HANDLER_DOTTED_ALLOW = {"os.write", "os.kill", "os._exit", "os.getpid",
                         "signal.signal"}


@dataclass
class Finding:
    path: str
    line: int
    col: int
    rule: str
    message: str
    hint: str = ""

    def render(self) -> str:
        s = f"{self.path}:{self.line}:{self.col}: [{self.rule}] " \
            f"{self.message}"
        if self.hint:
            s += f"\n    hint: {self.hint}"
        return s


@dataclass
class Suppression:
    """One ``# tpudl: ignore[rules] — reason`` comment. A single object
    is registered at every line it covers (its own line and the next
    code line), so a finding absorbed at either marks the SAME record
    used — the stale-suppression audit (tools/tpudl_check.py) reports
    records whose rules never absorbed anything."""
    rules: set            # valid rule ids named in the bracket
    reason: str
    line: int             # the comment's own line (the audit anchor)
    col: int = 0
    used: set = field(default_factory=set)  # rule ids that absorbed


@dataclass
class _Ctx:
    """Lexical context threaded through the walk."""
    func: ast.AST | None = None        # enclosing function node
    hot: bool = False                  # hot-path scope (marker/stage)
    in_except: bool = False
    in_loop_try: bool = False          # inside try within a loop
    in_loop: bool = False
    funcs: dict = field(default_factory=dict)  # visible name -> def


class _FileChecker:
    def __init__(self, src: str, path: str, relpath: str):
        self.src = src
        self.path = path
        self.rel = relpath.replace(os.sep, "/")
        self.lines = src.splitlines()
        self.findings: list[Finding] = []
        # line -> [Suppression] (one record may appear under two lines)
        self.suppressions: dict[int, list[Suppression]] = {}
        self.hot_lines: set[int] = set()
        self.docstring_positions: set[tuple[int, int]] = set()
        self.used_knobs: set[str] = set()
        self.used_metrics: set[str] = set()
        self.used_metric_patterns: set[tuple[str, str]] = set()
        self.spawns_threads = False
        self.global_names: set[str] = set()

    # -- comments: suppressions + hot markers --------------------------
    def _scan_comments(self):
        try:
            toks = tokenize.generate_tokens(io.StringIO(self.src).readline)
            for tok in toks:
                if tok.type != tokenize.COMMENT:
                    continue
                line = tok.start[0]
                standalone = self.lines[line - 1].lstrip().startswith("#")
                target = line
                if standalone:
                    # a standalone suppression covers the next code
                    # line, skipping the rest of its comment block
                    target = line + 1
                    while target <= len(self.lines) and (
                            not self.lines[target - 1].strip() or
                            self.lines[target - 1].lstrip()
                            .startswith("#")):
                        target += 1
                m = _SUPPRESS_RE.search(tok.string)
                if m:
                    rules = {r.strip() for r in m.group(1).split(",")}
                    reason = m.group(2).strip()
                    unknown = rules - set(RULES)
                    if unknown:
                        self._emit(line, tok.start[1], "bad-suppression",
                                   f"unknown rule id in suppression: "
                                   f"{sorted(unknown)}",
                                   suppressible=False)
                    valid = rules & set(RULES)
                    # all-unknown rule ids register NOTHING: a typo'd
                    # ignore must not become a suppress-everything that
                    # hides the line's genuine findings
                    if valid:
                        rec = Suppression(rules=valid, reason=reason,
                                          line=line, col=tok.start[1])
                        self.suppressions.setdefault(target, []).append(
                            rec)
                        if standalone:
                            # also cover the comment's own line so a
                            # same-line OR line-above placement both
                            # work (same record: usage marks once)
                            self.suppressions.setdefault(line, []).append(
                                rec)
                if _HOT_RE.search(tok.string):
                    self.hot_lines.add(target)
                    self.hot_lines.add(line)
        except tokenize.TokenError:
            pass

    # -- finding emission (suppression-aware) --------------------------
    def _emit(self, line: int, col: int, rule: str, message: str,
              suppressible: bool = True, also_lines: tuple = ()):
        if suppressible:
            for ln in (line, *also_lines):
                for sup in self.suppressions.get(ln, []):
                    if rule in sup.rules:
                        # a reasonless match still ABSORBED the finding
                        # (used for the stale audit) — but is its own
                        # finding: the reason is required
                        sup.used.add(rule)
                        if not sup.reason:
                            self.findings.append(Finding(
                                self.rel, ln, col, rule,
                                f"suppression for [{rule}] is missing "
                                f"its required reason",
                                "write the why after the bracket: "
                                "# tpudl: ignore[rule] — <reason>"))
                        return
        self.findings.append(Finding(self.rel, line, col, rule,
                                     message, _HINTS.get(rule, "")))

    # -- entry ---------------------------------------------------------
    def run(self) -> list[Finding]:
        self._scan_comments()
        try:
            tree = ast.parse(self.src, filename=self.path)
        except SyntaxError as e:
            raise _ParseError(f"{self.rel}: {e}") from e
        self._collect_docstrings(tree)
        self.spawns_threads = self._module_spawns_threads(tree)
        self._walk(tree, _Ctx())
        self.findings.sort(key=lambda f: (f.line, f.col, f.rule))
        return self.findings

    def _collect_docstrings(self, tree):
        for node in ast.walk(tree):
            if isinstance(node, (ast.Module, ast.ClassDef,
                                 ast.FunctionDef, ast.AsyncFunctionDef)):
                body = node.body
                if body and isinstance(body[0], ast.Expr) and \
                        isinstance(body[0].value, ast.Constant) and \
                        isinstance(body[0].value.value, str):
                    c = body[0].value
                    self.docstring_positions.add((c.lineno, c.col_offset))

    @staticmethod
    def _module_spawns_threads(tree) -> bool:
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                f = node.func
                if (isinstance(f, ast.Attribute) and f.attr == "Thread") \
                        or (isinstance(f, ast.Name) and f.id == "Thread"):
                    return True
        return False

    # -- helpers -------------------------------------------------------
    @staticmethod
    def _call_name(func) -> str:
        if isinstance(func, ast.Attribute):
            return func.attr
        if isinstance(func, ast.Name):
            return func.id
        return ""

    @staticmethod
    def _dotted(node) -> str:
        parts = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if isinstance(node, ast.Name):
            parts.append(node.id)
        return ".".join(reversed(parts))

    def _expr_idents(self, node):
        """Every identifier / string fragment in an expression — the
        'does this path look durable' evidence for atomic-write."""
        out = []
        for n in ast.walk(node):
            if isinstance(n, ast.Constant) and isinstance(n.value, str):
                out.append(n.value)
            elif isinstance(n, ast.Name):
                out.append(n.id)
            elif isinstance(n, ast.Attribute):
                out.append(n.attr)
        return out

    @staticmethod
    def _scope_calls_os_replace(scope) -> bool:
        for n in ast.walk(scope):
            if isinstance(n, ast.Call) and \
                    isinstance(n.func, ast.Attribute) and \
                    n.func.attr in ("replace", "rename") and \
                    isinstance(n.func.value, ast.Name) and \
                    n.func.value.id == "os":
                return True
        return False

    def _stage_label(self, withitem) -> str | None:
        """``with report.stage("dispatch")`` → 'dispatch'."""
        call = withitem.context_expr
        if isinstance(call, ast.Call) and \
                isinstance(call.func, ast.Attribute) and \
                call.func.attr == "stage" and call.args and \
                isinstance(call.args[0], ast.Constant) and \
                isinstance(call.args[0].value, str):
            return call.args[0].value
        return None

    # -- the walk ------------------------------------------------------
    def _walk(self, node, ctx: _Ctx):
        for child in ast.iter_child_nodes(node):
            self._visit(child, ctx)

    def _visit(self, node, ctx: _Ctx):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self._check_function(node, ctx)
            hot = node.lineno in self.hot_lines or any(
                d.lineno in self.hot_lines for d in node.decorator_list)
            ctx.funcs[node.name] = node
            # nested defs do NOT inherit hot: a prepare-pool closure
            # inside map_batches is its own (prepare-stage) scope
            sub = _Ctx(func=node, hot=hot, funcs=dict(ctx.funcs))
            self._walk(node, sub)
            return
        if isinstance(node, ast.ClassDef):
            sub = _Ctx(func=ctx.func, hot=ctx.hot,
                       funcs=dict(ctx.funcs))
            self._walk(node, sub)
            return
        if isinstance(node, ast.With):
            hot = ctx.hot or any(
                (self._stage_label(i) or "") in _HOT_STAGES
                for i in node.items)
            sub = _Ctx(func=ctx.func, hot=hot, in_except=ctx.in_except,
                       in_loop=ctx.in_loop, in_loop_try=ctx.in_loop_try,
                       funcs=ctx.funcs)
            self._walk(node, sub)
            return
        if isinstance(node, (ast.For, ast.While, ast.AsyncFor)):
            sub = _Ctx(func=ctx.func, hot=ctx.hot,
                       in_except=ctx.in_except, in_loop=True,
                       in_loop_try=ctx.in_loop_try, funcs=ctx.funcs)
            self._walk(node, sub)
            return
        if isinstance(node, ast.Try):
            body_ctx = _Ctx(func=ctx.func, hot=ctx.hot,
                            in_except=ctx.in_except, in_loop=ctx.in_loop,
                            in_loop_try=ctx.in_loop or ctx.in_loop_try,
                            funcs=ctx.funcs)
            for child in node.body + node.orelse + node.finalbody:
                self._visit(child, body_ctx)
            for handler in node.handlers:
                self._check_except(handler)
                h_ctx = _Ctx(func=ctx.func, hot=ctx.hot, in_except=True,
                             in_loop=ctx.in_loop,
                             in_loop_try=ctx.in_loop_try, funcs=ctx.funcs)
                for child in handler.body:
                    self._visit(child, h_ctx)
            return
        if isinstance(node, ast.Call):
            self._check_call(node, ctx)
        elif isinstance(node, ast.Constant):
            self._check_knob_literal(node)
        elif isinstance(node, (ast.Assign, ast.AugAssign)) and ctx.func:
            self._check_global_write(node, ctx)
        self._walk(node, ctx)

    # -- rule: swallowed-except ---------------------------------------
    def _check_except(self, handler: ast.ExceptHandler):
        names = []
        t = handler.type
        if t is None:
            names = [None]
        elif isinstance(t, ast.Name):
            names = [t.id]
        elif isinstance(t, ast.Tuple):
            names = [e.id for e in t.elts if isinstance(e, ast.Name)]
        bare = t is None
        broad = any(n in _BROAD_EXC for n in names if n)
        if not bare and not broad:
            return
        if not bare and not self._swallows(handler):
            return
        if bare:
            self._emit(handler.lineno, handler.col_offset,
                       "swallowed-except",
                       "bare except: catches SystemExit/"
                       "KeyboardInterrupt and hides the cause")
            return
        if self._swallows(handler):
            which = next(n for n in names if n in _BROAD_EXC)
            self._emit(handler.lineno, handler.col_offset,
                       "swallowed-except",
                       f"except {which} swallows silently (no raise, "
                       f"no breadcrumb, exception unused)")

    @staticmethod
    def _swallows(handler: ast.ExceptHandler) -> bool:
        """True when the handler neither re-raises, nor calls anything
        (a log/record/metric call is a breadcrumb), nor returns a
        value, nor uses the bound exception."""
        for n in ast.walk(handler):
            if isinstance(n, (ast.Raise, ast.Call)):
                return False
            if isinstance(n, ast.Return) and n.value is not None:
                return False
            if handler.name and isinstance(n, ast.Name) and \
                    n.id == handler.name and isinstance(n.ctx, ast.Load):
                return False
        return True

    # -- rule: undeclared-knob ----------------------------------------
    def _check_knob_literal(self, node: ast.Constant):
        if not isinstance(node.value, str):
            return
        if not _KNOB_RE.fullmatch(node.value):
            return
        if (node.lineno, node.col_offset) in self.docstring_positions:
            return
        if self.rel.endswith("tpudl_torch/analysis/knobs.py"):
            return  # the declarations themselves are not USES: counting
            # them would make every declared knob self-count as read and
            # the 'declared but never read' audit could never fire
        self.used_knobs.add(node.value)
        if node.value not in _knobs.KNOB_NAMES:
            self._emit(node.lineno, node.col_offset, "undeclared-knob",
                       f"env knob {node.value!r} is not in the knob "
                       f"registry")

    # -- rule: undeclared-metric / hot-sync / adhoc-retry /
    #    atomic-write / signal-handler (all call-shaped) ---------------
    def _check_call(self, node: ast.Call, ctx: _Ctx):
        name = self._call_name(node.func)
        dotted = self._dotted(node.func)

        # undeclared-metric
        if name in _METRIC_CALLS and node.args and \
                not self.rel.endswith("tpudl_torch/analysis/metric_names.py"):
            self._check_metric_name(node)

        # hot-sync
        if ctx.hot:
            self._check_hot_sync(node, name, dotted)

        # adhoc-retry
        if dotted == "time.sleep" and \
                not self.rel.endswith("tpudl_torch/jobs/retry.py") and \
                (ctx.in_except or (ctx.in_loop and ctx.in_loop_try)):
            where = ("an except block" if ctx.in_except
                     else "a try inside a loop")
            self._emit(node.lineno, node.col_offset, "adhoc-retry",
                       f"time.sleep in {where} looks like an ad-hoc "
                       f"retry/backoff")

        # atomic-write: open(path, "w"/"wb") on a durable-looking path
        if name == "open" and isinstance(node.func, ast.Name):
            self._check_atomic_open(node, ctx)
        if dotted in ("np.save", "np.savez", "np.savez_compressed",
                      "numpy.save", "numpy.savez"):
            self._check_atomic_npsave(node, ctx)

        # signal-handler registration
        if dotted == "signal.signal" and len(node.args) == 2:
            self._check_signal_registration(node, ctx)

    def _check_metric_name(self, node: ast.Call):
        arg = node.args[0]
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            n = arg.value
            self.used_metrics.add(n)
            if not _metric_names.is_declared_metric(n):
                self._emit(node.lineno, node.col_offset,
                           "undeclared-metric",
                           f"metric name {n!r} is not in the metric "
                           f"registry")
        elif isinstance(arg, ast.JoinedStr):
            head, tail, seen_dyn = "", "", False
            for v in arg.values:
                if isinstance(v, ast.Constant) and \
                        isinstance(v.value, str):
                    if seen_dyn:
                        tail += v.value
                    else:
                        head += v.value
                else:
                    if seen_dyn:   # two dynamic segments: treat tail
                        tail = ""  # as unknowable, match on head only
                    seen_dyn = True
            if not head and not tail:
                return  # fully dynamic: plumbing, not a declaration site
            self.used_metric_patterns.add((head, tail))
            if not _metric_names.matches_pattern_prefix(head, tail):
                self._emit(node.lineno, node.col_offset,
                           "undeclared-metric",
                           f"dynamic metric family "
                           f"{head + '*' + tail!r} is not a declared "
                           f"pattern in the metric registry")

    def _check_hot_sync(self, node: ast.Call, name: str, dotted: str):
        bad = None
        if name == "block_until_ready":
            bad = "block_until_ready"
        elif name == "item" and not node.args and not node.keywords:
            bad = ".item()"
        elif name in ("cpu", "tolist") and \
                isinstance(node.func, ast.Attribute) and \
                not node.args and not node.keywords:
            bad = f".{name}() (device→host copy)"
        elif dotted == "torch.cuda.synchronize" or (
                name == "synchronize" and
                isinstance(node.func, ast.Attribute) and not node.args):
            # the whole card, or an event's / a stream's wait
            bad = f"{dotted or '.synchronize'}()"
        elif name in ("result", "wait") and \
                isinstance(node.func, ast.Attribute) and \
                not node.args and not node.keywords:
            # the async-dispatch window's helpers: a bare .result() /
            # .wait() on an in-flight future inside a hot stage blocks
            # the dispatch loop exactly like block_until_ready (the
            # executor's own window waits live in their own
            # ``dispatch_wait`` stage, which is deliberately NOT hot)
            bad = f".{name}() (in-flight future)"
        elif dotted in ("jax.device_get",):
            bad = "jax.device_get"
        elif dotted in ("np.asarray", "np.array", "numpy.asarray",
                        "numpy.array") and len(node.args) == 1 and \
                not node.keywords:
            # single-arg form: a host-side np.asarray(x, dtype) on a
            # scalar is fine; a bare asarray on a device array is a
            # blocking D2H round-trip
            bad = f"{dotted}(...) (device→host materialization)"
        if bad:
            self._emit(node.lineno, node.col_offset, "hot-sync",
                       f"{bad} inside a hot-path scope blocks the "
                       f"dispatch pipeline")

    def _check_atomic_open(self, node: ast.Call, ctx: _Ctx):
        mode = None
        if len(node.args) >= 2 and isinstance(node.args[1], ast.Constant):
            mode = node.args[1].value
        for kw in node.keywords:
            if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
                mode = kw.value.value
        if not (isinstance(mode, str) and mode.startswith("w")):
            return
        if not node.args:
            return
        evidence = " ".join(self._expr_idents(node.args[0])).lower()
        if "tmp" in evidence or "temp" in evidence:
            return  # writing the tmp side of the idiom itself
        if not _DURABLE_RE.search(evidence):
            return
        scope = ctx.func if ctx.func is not None else None
        if scope is not None and self._scope_calls_os_replace(scope):
            return
        self._emit(node.lineno, node.col_offset, "atomic-write",
                   "durable-looking path opened for write without "
                   "os.replace in the same function (a crash leaves a "
                   "torn artifact)")

    def _check_atomic_npsave(self, node: ast.Call, ctx: _Ctx):
        if not node.args:
            return
        evidence = " ".join(self._expr_idents(node.args[0])).lower()
        if "tmp" in evidence or "temp" in evidence:
            return
        if not _DURABLE_RE.search(evidence):
            return
        scope = ctx.func if ctx.func is not None else None
        if scope is not None and self._scope_calls_os_replace(scope):
            return
        self._emit(node.lineno, node.col_offset, "atomic-write",
                   "np.save to a durable-looking path without "
                   "os.replace in the same function")

    # -- rule: signal-handler -----------------------------------------
    def _check_signal_registration(self, node: ast.Call, ctx: _Ctx):
        target = node.args[1]
        handler = None
        if isinstance(target, ast.Name):
            handler = ctx.funcs.get(target.id)
        if handler is None:
            return  # SIG_DFL / prev-handler variable / lambda-free
        params = {a.arg for a in handler.args.args}
        for stmt in handler.body:
            self._check_handler_stmt(stmt, params, handler)

    def _check_handler_stmt(self, stmt, params: set, handler):
        if isinstance(stmt, (ast.Pass, ast.Raise, ast.Return,
                             ast.Global, ast.Nonlocal)):
            return
        if isinstance(stmt, ast.Expr) and \
                isinstance(stmt.value, ast.Constant):
            return  # docstring
        if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            value = stmt.value
            if value is None or isinstance(
                    value, (ast.Constant, ast.Name, ast.Attribute)):
                return  # flag set
        if isinstance(stmt, ast.If):
            for s in stmt.body + stmt.orelse:
                self._check_handler_stmt(s, params, handler)
            return
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
            call = stmt.value
            if self._dotted(call.func) in _HANDLER_DOTTED_ALLOW:
                return
            if isinstance(call.func, ast.Attribute) and \
                    call.func.attr == "set" and not call.args:
                return  # event.set() — the threading.Event flag idiom
            if isinstance(call.func, ast.Name) and call.func.id in params:
                return  # chaining the previous handler
        # a suppression on the handler's def line covers the whole
        # handler: one documented reason beats one comment per line
        self._emit(stmt.lineno, stmt.col_offset, "signal-handler",
                   f"signal handler {handler.name!r} does non-trivial "
                   f"work in signal context (an interrupted frame may "
                   f"hold a lock this needs)",
                   also_lines=(handler.lineno,))

    # -- rule: unlocked-global ----------------------------------------
    def _check_global_write(self, node, ctx: _Ctx):
        if not self.spawns_threads:
            return
        if getattr(ctx.func, "name", "").endswith("_locked"):
            return  # the caller-holds-the-lock naming contract
        declared = self._globals_in(ctx.func)
        if not declared:
            return
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target])
        # flatten tuple/list/starred targets: `_A, _B = a, b` rebinds
        # both globals just as racily as the single-name form
        names = set()
        stack = list(targets)
        while stack:
            t = stack.pop()
            if isinstance(t, ast.Name):
                names.add(t.id)
            elif isinstance(t, (ast.Tuple, ast.List)):
                stack.extend(t.elts)
            elif isinstance(t, ast.Starred):
                stack.append(t.value)
        hit = names & declared
        if not hit:
            return
        if self._under_lock(node, ctx.func):
            return
        self._emit(node.lineno, node.col_offset, "unlocked-global",
                   f"module global {sorted(hit)[0]!r} rebound without "
                   f"a lock in a thread-spawning module")

    @staticmethod
    def _globals_in(func) -> set:
        out = set()
        if func is None:
            return out
        for n in ast.walk(func):
            if isinstance(n, ast.Global):
                out.update(n.names)
        return out

    def _under_lock(self, node, func) -> bool:
        """Is ``node`` lexically inside a ``with <something lock-y>``
        in ``func``? (Ancestor scan — cheap at this file count.)"""
        for w in ast.walk(func):
            if not isinstance(w, ast.With):
                continue
            span_ok = (w.lineno <= node.lineno and
                       (w.end_lineno or w.lineno) >= node.lineno)
            if not span_ok:
                continue
            for item in w.items:
                for ident in self._expr_idents(item.context_expr):
                    if "lock" in str(ident).lower():
                        return True
        return False

    # -- rule: hot-sync markers on functions (checked in _visit) -------
    def _check_function(self, node, ctx: _Ctx):
        pass  # marker resolution happens in _visit


class _ParseError(Exception):
    pass


# -- public API --------------------------------------------------------

def check_source(src: str, filename: str = "<src>",
                 relpath: str | None = None) -> list[Finding]:
    """Check one source string (the tests' fixture entry point)."""
    return _FileChecker(src, filename, relpath or filename).run()


def check_file(path: str, root: str = ".") -> list[Finding]:
    rel = os.path.relpath(path, root)
    with open(path, encoding="utf-8") as f:
        src = f.read()
    return _FileChecker(src, path, rel).run()


def iter_python_files(paths) -> list[str]:
    out = []
    for p in paths:
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [d for d in dirnames
                               if d not in ("__pycache__",)]
                out.extend(os.path.join(dirpath, fn)
                           for fn in sorted(filenames)
                           if fn.endswith(".py"))
        elif p.endswith(".py"):
            out.append(p)
    return sorted(set(out))


def check_paths(paths, root: str = ".",
                sources: dict | None = None,
                supp_sink: dict | None = None) -> tuple[list[Finding],
                                                        list[str]]:
    """(findings, errors) over files/dirs. Errors are unreadable or
    unparseable files — the CLI maps them to exit 1. Pass ``sources``
    (``{relpath: src}``, already read) to skip the file IO — the CLI
    reads the tree once and feeds both checker halves. ``supp_sink``
    (``{relpath: {line: [Suppression]}}``) receives each file's
    suppression records with their usage marks — the stale-suppression
    audit's evidence."""
    findings: list[Finding] = []
    errors: list[str] = []
    if sources is not None:
        for rel, src in sorted(sources.items()):
            fc = _FileChecker(src, rel, rel)
            try:
                findings.extend(fc.run())
            except _ParseError as e:
                errors.append(str(e))
                continue
            if supp_sink is not None:
                supp_sink[rel.replace(os.sep, "/")] = fc.suppressions
        return findings, errors
    for path in iter_python_files(paths):
        rel = os.path.relpath(path, root)
        try:
            with open(path, encoding="utf-8") as f:
                src = f.read()
        except (OSError, UnicodeDecodeError) as e:
            # a non-UTF-8 source is an ERROR line + rc 1, not a
            # traceback through the lint gate
            errors.append(f"{path}: {e}")
            continue
        fc = _FileChecker(src, path, rel)
        try:
            findings.extend(fc.run())
        except _ParseError as e:
            errors.append(str(e))
            continue
        if supp_sink is not None:
            supp_sink[rel.replace(os.sep, "/")] = fc.suppressions
    return findings, errors


def collect_usage(paths, root: str = ".") -> dict:
    """Scan without judging: which knobs / metric names / dynamic
    metric families the tree actually uses. Feeds the registry
    round-trip test (declared ⊆ used, used ⊆ declared)."""
    knobs: set[str] = set()
    metrics: set[str] = set()
    patterns: set[tuple[str, str]] = set()
    for path in iter_python_files(paths):
        try:
            with open(path, encoding="utf-8") as f:
                src = f.read()
        except (OSError, UnicodeDecodeError):
            continue  # check_paths reports these; usage just skips
        fc = _FileChecker(src, path, os.path.relpath(path, root))
        try:
            fc.run()
        except _ParseError:
            continue
        knobs |= fc.used_knobs
        metrics |= fc.used_metrics
        patterns |= fc.used_metric_patterns
    return {"knobs": knobs, "metrics": metrics,
            "metric_patterns": patterns}
