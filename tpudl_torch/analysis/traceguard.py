"""Interprocedural capture-boundary analyzer: which functions a CUDA
graph records, and the five contracts captured code must honor.

Port of ``tpudl/analysis/traceguard.py``. tpudl's boundary is the jit
trace; the port's is the CUDA-graph capture: a captured function's
Python body runs once, at capture, and every replay runs only the
kernels it launched then. The rule ids and their meaning carry over
(per-file rules live in :mod:`tpudl_torch.analysis.checker`, the lock
graph in :mod:`tpudl_torch.analysis.concurrency`, whose call-graph
machinery this module reuses).

Phase 1 finds the **traced set**: a function is traced when it reaches
a capture entry —

- passed to ``cuda_ops.capture_graph(f, ...)`` (the one capture path);
- passed to ``FusedGraph(f, ...)`` or ``BoundGraph(f, ...)``
  (``compile/graphs.py``: the executor's fused dispatch, the serve
  engine's programs);
- passed to the program store (``<store>.call(f, ...)``,
  ``.fused(f, ...)``, ``.compile_signature(f, ...)``);
- returned by a stage's ``_device_fn(key, build)`` builder (the
  per-batch function the executor and the store capture);
- the first argument of a call site carrying a truthy ``device_fn=``
  marker;

plus, transitively, anything a traced function calls (name-based
may-analysis, the same call resolution as the lock graph —
over-approximation is the design, and the sweep's fix-or-suppress
pass is the accuracy mechanism).

Phase 2 runs five rules:

- ``trace-time-effect``: obs counters/gauges/histograms, flight
  breadcrumbs (``record_*``), env reads (``os.environ``/
  ``os.getenv``), ``print``/logging inside captured code: they run once
  at capture and never on a replay.
- ``host-op-on-traced``: ``np.*`` calls and ``.item()``/``.cpu()``/
  ``.numpy()``/``.tolist()``/``float()``/``int()``/``bool()`` on a
  tensor — a device sync, which fails a capture or bakes the value it
  read into every replay.
- ``traced-branch``: Python ``if``/``while`` on a tensor's value (the
  branch taken at capture is the only one any replay runs).
  Static accesses (``x.shape``/``x.ndim``/``x.dtype``/``x.size``/
  ``x.device``, ``len(x)``, ``isinstance``, ``is None``) are exempt —
  shape dispatch is the house idiom, value dispatch is the bug.
- ``donation-reuse``: a variable passed to a donating wrapper
  (``<plan>.wrap(..., donate=)``) and read again afterwards in the
  same scope. The port's torch functions donate nothing (its codec
  plan takes no ``donate``), so the rule guards the pattern's return.
- ``jit-cache-churn``: a fresh closure (a lambda or a local def made
  per call) handed to a capture, a graph or the program store: the
  store keys its programs on the live function, so every call captures
  a new CUDA graph.

Traced-value tracking is a per-function forward dataflow: parameters
(minus ``self``/``cls``) of a root seed the set; assignments whose
right side references a traced value or calls ``torch.*``/``F.*``
extend it.

Suppression: the shared ``# tpudl: ignore[rule] — reason`` grammar,
accepted at ANY witness site (the offending line, the traced
function's ``def`` line, or the capture-entry site that made it
traced).

Runtime twin: :mod:`tpudl_torch.testing.traceck` (``TPUDL_TRACECK=1``)
counts actual captures per function identity and files recompile-storm
findings.
"""

from __future__ import annotations

import ast

from .checker import Finding, _HINTS  # noqa: F401  (re-export surface)
from .concurrency import (_Emitter, _Func, _dotted, _expr_idents, _link,
                          read_sources)

__all__ = ["TRACE_RULES", "TracedFn", "analyze", "analyze_sources",
           "traced_functions"]

TRACE_RULES = ("trace-time-effect", "host-op-on-traced", "traced-branch",
               "donation-reuse", "jit-cache-churn")

# call tails that capture their first argument as a CUDA graph
_CAPTURE_TAILS = {"capture_graph", "FusedGraph", "BoundGraph"}
# the program store's entries: capture their first argument
_STORE_TAILS = {"call", "fused", "compile_signature"}
# attribute accesses that are STATIC under capture (shape dispatch)
_STATIC_ATTRS = {"shape", "ndim", "dtype", "size", "device", "dim",
                 "numel", "is_cuda", "layout", "requires_grad"}
# calls whose result is static even over traced args
_STATIC_CALLS = {"len", "isinstance", "getattr", "hasattr", "type",
                 "callable", "id", "repr"}
_LOG_TAILS = {"debug", "info", "warning", "error", "exception",
              "critical", "log", "warn"}


class TracedFn:
    """Why one function is traced: the entry kind and witness site."""

    __slots__ = ("key", "kind", "file", "line", "via")

    def __init__(self, key, kind, file, line, via=None):
        self.key = key          # "<module>:<qual>"
        self.kind = kind        # capture|store|device_fn|call
        self.file = file        # trace-entry witness file
        self.line = line        # trace-entry witness line
        self.via = via          # caller qual for transitive entries


def _call_tail(d: str) -> str:
    return d.rsplit(".", 1)[-1] if d else ""


def _bind_targets(n) -> list:
    """The binding targets of an Assign OR AnnAssign — an annotation
    (`g: Callable = plan.wrap(f)`) must not break maker/factory
    recognition."""
    return n.targets if isinstance(n, ast.Assign) else [n.target]


def _truthy_const(node) -> bool:
    return isinstance(node, ast.Constant) and bool(node.value)


def _falsy_const(node) -> bool:
    return isinstance(node, ast.Constant) and not node.value


def _donate_positions(call: ast.Call):
    """``"all"`` when ``call`` builds a donating wrapper
    (``<plan>.wrap(fn, ..., donate=<not False>)``: the wrapper donates
    its whole input tree), else None."""
    if _call_tail(_dotted(call.func)) == "wrap":
        for kw in call.keywords:
            if kw.arg == "donate" and not _falsy_const(kw.value):
                return "all"    # donate=True or donate=<flag var>: may
    return None


def _capture_fn_arg(call: ast.Call):
    """``(kind, fn expression)`` when ``call`` hands its first argument
    to a capture: ``capture_graph``/``FusedGraph``/``BoundGraph``
    (``"capture"``), the program store (``"store"``), a truthy
    ``device_fn=`` marker (``"device_fn"``); else None."""
    if not call.args:
        return None
    d = _dotted(call.func)
    tail = _call_tail(d)
    if tail in _CAPTURE_TAILS:
        return "capture", call.args[0]
    if tail in _STORE_TAILS and isinstance(call.func, ast.Attribute) and \
            any("store" in str(i).lower()
                for i in _expr_idents(call.func.value)):
        return "store", call.args[0]
    if any(kw.arg == "device_fn" and _truthy_const(kw.value)
           for kw in call.keywords):
        return "device_fn", call.args[0]
    return None


class _FnScope:
    """One function's AST plus the bookkeeping phase 2 needs."""

    __slots__ = ("key", "node", "file", "module", "qual", "func")

    def __init__(self, key, node, file, module, qual, func):
        self.key = key
        self.node = node
        self.file = file
        self.module = module
        self.qual = qual
        self.func = func      # the linker's _Func (call resolution)


def _iter_scopes(scan):
    """Every function in a module scan, with the SAME qual scheme the
    concurrency linker uses (class bodies reset qual to the class
    name; nested defs join with '.') so keys line up."""
    out = []

    def walk(node, qual, cls):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                walk(child, child.name, child.name)
            elif isinstance(child, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                fq = f"{qual}.{child.name}" if qual else child.name
                out.append((fq, child, cls))
                walk(child, fq, cls)
            else:
                walk(child, qual, cls)

    walk(scan.tree, "", None)
    return out


class _TraceLinker:
    """Phase 1: the traced set over the whole tree."""

    def __init__(self, linker):
        self.linker = linker
        self.scopes: dict[str, _FnScope] = {}
        self._scan_scopes: dict[int, list] = {}  # id(scan) -> scopes
        for scan in linker.scans:
            scoped = _iter_scopes(scan)
            self._scan_scopes[id(scan)] = scoped
            for fq, node, _cls in scoped:
                f = scan.funcs.get(fq)
                if f is None:
                    continue
                self.scopes[f.key] = _FnScope(
                    f.key, node, scan.rel, scan.module, fq, f)
        self.traced: dict[str, TracedFn] = {}

    # -- trace-entry discovery ----------------------------------------
    def _module_ctx(self, scan) -> _Func:
        return _Func(key=f"{scan.module}:<module>", module=scan.module,
                     qual="", cls=None, file=scan.rel, line=0,
                     name="<module>")

    def resolve(self, desc, f: _Func) -> list[_Func]:
        """The linker's call resolution, minus its bare-method-name
        fallback for EXTERNAL module attributes: ``torch.log`` /
        ``F.linear`` must not resolve to some repo function that
        happens to be named ``log``/``linear`` — one such mismatch marks
        a whole host subsystem traced and floods the sweep."""
        _, d = desc
        if "." in d:
            head = d.split(".", 1)[0]
            s = self.linker.by_module.get(f.module)
            if s is not None:
                if head in s.imports and \
                        s.imports[head] not in self.linker.by_module:
                    return []
                if head in s.from_imports:
                    mod, orig = s.from_imports[head]
                    if f"{mod}.{orig}" not in self.linker.by_module \
                            and mod not in self.linker.by_module:
                        return []   # `import torch.nn.functional as F`
        return self.linker.resolve_call(desc, f)

    def _resolve_fn_arg(self, expr, ctx: _Func) -> list[_Func]:
        if isinstance(expr, ast.Lambda):
            return []           # no body scope to analyze; churn rules
            # judge the lambda at its construction site instead
        d = _dotted(expr)
        if not d:
            return []
        return self.resolve(("call", d), ctx)

    def _mark(self, f: _Func, kind, file, line, via=None):
        if f.key in self.traced:
            return False
        self.traced[f.key] = TracedFn(f.key, kind, file, line, via=via)
        return True

    def discover(self):
        for scan in self.linker.scans:
            for node in ast.walk(scan.tree):
                if not isinstance(node, ast.Call):
                    continue
                if _call_tail(_dotted(node.func)) == "_device_fn" and \
                        len(node.args) >= 2:
                    # a stage's builder: what it returns is the
                    # per-batch function the executor captures
                    ctx = self._ctx_for(scan, node)
                    build = node.args[1]
                    if isinstance(build, ast.Lambda) and \
                            isinstance(build.body, ast.Call):
                        build = build.body.func   # lambda d: maker(...)
                    for b in self._resolve_fn_arg(build, ctx):
                        for g in self._returned_defs(b):
                            self._mark(g, "device_fn", scan.rel,
                                       node.lineno)
                    continue
                entry = _capture_fn_arg(node)
                if entry is None:
                    continue
                kind, fn_expr = entry
                ctx = self._ctx_for(scan, node)
                for g in self._resolve_fn_arg(fn_expr, ctx):
                    self._mark(g, kind, scan.rel, node.lineno)
        self._propagate()

    def _returned_defs(self, f: _Func) -> list[_Func]:
        """The nested defs a builder returns by name."""
        scope = self.scopes.get(f.key)
        if scope is None:
            return []
        nested = {c.name for c in ast.walk(scope.node)
                  if isinstance(c, (ast.FunctionDef, ast.AsyncFunctionDef))
                  and c is not scope.node}
        out = []
        for n in _RuleRunner._own_nodes(scope.node):
            if isinstance(n, ast.Return) and isinstance(n.value, ast.Name) \
                    and n.value.id in nested:
                g = self.linker.funcs.get(f"{f.key}.{n.value.id}")
                if g is not None:
                    out.append(g)
        return out

    def _ctx_for(self, scan, node) -> _Func:
        """The innermost function enclosing ``node`` (for name
        resolution), else a module-level pseudo context."""
        best = None
        for fq, fnode, _cls in self._scan_scopes[id(scan)]:
            if fnode.lineno <= node.lineno <= (fnode.end_lineno or
                                               fnode.lineno):
                if best is None or fnode.lineno >= best[1].lineno:
                    best = (fq, fnode)
        if best is not None:
            f = scan.funcs.get(best[0])
            if f is not None:
                return f
        return self._module_ctx(scan)

    def _propagate(self):
        """Transitive closure: whatever a traced fn calls is traced."""
        work = list(self.traced)
        while work:
            key = work.pop()
            f = self.linker.funcs.get(key)
            if f is None:
                continue
            for desc, line, _held in f.calls:
                for g in self.resolve(desc, f):
                    if g.key not in self.traced:
                        self.traced[g.key] = TracedFn(
                            g.key, "call", f.file, line, via=f.qual)
                        work.append(g.key)


# -- phase 2: the rules -------------------------------------------------

class _RuleRunner:
    def __init__(self, tl: _TraceLinker, emitter: _Emitter):
        self.tl = tl
        self.emitter = emitter

    def run(self):
        for key, why in sorted(self.tl.traced.items()):
            scope = self.tl.scopes.get(key)
            if scope is None:
                continue
            self._check_traced_fn(scope, why)
        # donation-reuse and jit-cache-churn judge HOST code (the
        # scopes that BUILD and CALL the programs), so every function
        # is checked, traced or not — plus one pseudo-scope per MODULE
        # body: a script-level warmup loop is the canonical churn
        # pattern, and the doctor's remediation pointer must not
        # dead-end on it
        module_scopes = [
            _FnScope(f"{scan.module}:<module>", scan.tree, scan.rel,
                     scan.module, "<module>", None)
            for scan in self.tl.linker.scans]
        for scope in sorted(list(self.tl.scopes.values()) +
                            module_scopes,
                            key=lambda s: (s.file, s.qual)):
            self._check_donation(scope)
            self._check_churn(scope)

    # -- traced-value dataflow ----------------------------------------
    def _traced_names(self, scope: _FnScope, why: TracedFn) -> set:
        node = scope.node
        traced: set = set()
        if why.kind != "call":
            # parameters seed the traced set only for ROOT traced fns
            # — a captured entry's arguments really are the tensors.
            # A transitively-traced helper's params are unknowable
            # (name-based may-analysis would brand every static string
            # /int argument a tracer and flood traced-branch); inside
            # it, values born from torch.*/F.* calls still count.
            args = node.args
            traced = {a.arg for a in (args.posonlyargs + args.args +
                                      args.kwonlyargs)}
            for va in (args.vararg, args.kwarg):
                if va is not None:
                    traced.add(va.arg)
            traced -= {"self", "cls"}
        # iterate to a FIXPOINT: the walk yields nodes out of source
        # order, so a bounded pass count would silently drop any
        # assignment chain deeper than the pass count — exactly the
        # a0 = torch.f(x); a1 = a0 + 1; a2 = a1 * 2 shape numeric code
        # is made of
        changed = True
        while changed:
            changed = False
            for stmt in self._own_nodes(node):
                if isinstance(stmt, (ast.Assign, ast.AnnAssign,
                                     ast.AugAssign)):
                    value = stmt.value
                    if value is None:
                        continue
                    if self._dynamic_refs(value, traced) or \
                            self._has_device_call(value):
                        targets = (stmt.targets
                                   if isinstance(stmt, ast.Assign)
                                   else [stmt.target])
                        for t in targets:
                            for n in self._stored_names(t):
                                if n not in traced:
                                    traced.add(n)
                                    changed = True
        return traced

    @staticmethod
    def _stored_names(target) -> list:
        """Names a store target binds to its value: a plain name, the
        names of a tuple, the container of ``x[i] = v`` (its index
        names are read, not bound: ``i`` stays a Python int)."""
        if isinstance(target, ast.Name):
            return [target.id]
        if isinstance(target, (ast.Tuple, ast.List)):
            return [n for e in target.elts
                    for n in _RuleRunner._stored_names(e)]
        if isinstance(target, ast.Starred):
            return _RuleRunner._stored_names(target.value)
        if isinstance(target, ast.Subscript):
            return _RuleRunner._stored_names(target.value)
        return []

    @staticmethod
    def _own_nodes(fnode):
        """Walk a function body WITHOUT descending into nested defs —
        a nested def is its own traced scope (reached via the closure)
        and must not double-report under its parent."""
        stack = list(ast.iter_child_nodes(fnode))
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                continue
            yield n
            stack.extend(ast.iter_child_nodes(n))

    @staticmethod
    def _has_device_call(expr) -> bool:
        for n in ast.walk(expr):
            if isinstance(n, ast.Call):
                d = _dotted(n.func)
                head = d.split(".", 1)[0]
                if head in ("torch", "F"):
                    return True
        return False

    @staticmethod
    def _static_ctx(node) -> bool:
        """Is ``node`` a static-under-trace/donation context (shape
        dispatch, metadata access, identity comparison)? THE shared
        predicate for every exemption walker — one list to extend."""
        if isinstance(node, ast.Attribute) and node.attr in _STATIC_ATTRS:
            return True
        if isinstance(node, ast.Call):
            d = _dotted(node.func)
            if d in _STATIC_CALLS or _call_tail(d) in _STATIC_CALLS:
                return True
        if isinstance(node, ast.Compare) and all(
                isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
            return True
        return False

    def _dynamic_refs(self, expr, traced) -> list:
        """Traced Name loads used DYNAMICALLY in ``expr`` — references
        through static-under-trace accessors (.shape/.ndim/len()/
        isinstance/is-None) are pruned."""
        out: list = []
        if self._static_ctx(expr):
            return out
        if isinstance(expr, ast.Name) and expr.id in traced and \
                isinstance(expr.ctx, ast.Load):
            return [expr]
        for child in ast.iter_child_nodes(expr):
            out.extend(self._dynamic_refs(child, traced))
        return out

    # -- rules on traced functions ------------------------------------
    def _check_traced_fn(self, scope: _FnScope, why: TracedFn):
        traced = self._traced_names(scope, why)
        where = (f"traced via {why.kind} at {why.file}:{why.line}"
                 + (f" (through {why.via})" if why.via else ""))
        sites_tail = [(scope.file, scope.node.lineno),
                      (why.file, why.line)]
        for n in self._own_nodes(scope.node):
            if isinstance(n, ast.Call):
                self._check_effect_call(n, scope, where, sites_tail)
                self._check_host_op(n, traced, scope, where, sites_tail)
            elif isinstance(n, ast.Subscript) and \
                    _dotted(n.value) == "os.environ" and \
                    isinstance(n.ctx, ast.Load):
                self.emitter.emit(
                    "trace-time-effect",
                    f"os.environ read inside traced "
                    f"{scope.qual!r} ({where}) — the env is read ONCE "
                    f"at trace time, not per step",
                    [(scope.file, n.lineno)] + sites_tail)
            elif isinstance(n, (ast.If, ast.While)):
                refs = self._dynamic_refs(n.test, traced)
                if refs:
                    names = sorted({r.id for r in refs})
                    kind = "while" if isinstance(n, ast.While) else "if"
                    self.emitter.emit(
                        "traced-branch",
                        f"Python {kind} on traced value(s) "
                        f"{names} inside {scope.qual!r} ({where}) — "
                        f"concretizes the tracer",
                        [(scope.file, n.lineno)] + sites_tail)

    def _check_effect_call(self, call, scope, where, sites_tail):
        d = _dotted(call.func)
        tail = _call_tail(d)
        effect = None
        if tail in ("counter", "gauge", "histogram") and call.args:
            effect = f"obs {tail}()"
        elif tail.startswith("record_"):
            effect = f"flight breadcrumb {tail}()"
        elif d == "os.getenv" or d.startswith("os.environ"):
            effect = f"env read {d}()"
        elif d == "print":
            effect = "print()"
        elif tail in _LOG_TAILS and self._logger_receiver(d):
            effect = f"logging call {d}()"
        if effect is None:
            return
        self.emitter.emit(
            "trace-time-effect",
            f"{effect} inside traced {scope.qual!r} ({where}) — "
            f"executes once at trace time, then never again per step",
            [(scope.file, call.lineno)] + sites_tail)

    @staticmethod
    def _logger_receiver(d: str) -> bool:
        """Does the dotted receiver look like a LOGGER (logging.info,
        log.warning, self._logger.error), not any object whose name
        merely contains 'log' (catalog.error, dialog.warning)?"""
        if d.startswith("logging."):
            return True
        head = d.rsplit(".", 1)[0].rsplit(".", 1)[-1].lower()
        return head in ("log", "logger") or head.endswith("_log") or \
            head.endswith("logger")

    def _check_host_op(self, call, traced, scope, where, sites_tail):
        d = _dotted(call.func)
        tail = _call_tail(d)
        bad = None
        if (d.startswith("np.") or d.startswith("numpy.")) and any(
                self._dynamic_refs(a, traced)
                for a in list(call.args)
                + [kw.value for kw in call.keywords]):
            bad = f"{d}(...)"
        elif tail in ("item", "cpu", "numpy", "tolist") and \
                not call.args and not call.keywords and \
                isinstance(call.func, ast.Attribute) and \
                self._dynamic_refs(call.func.value, traced):
            bad = f".{tail}()"
        elif isinstance(call.func, ast.Name) and \
                call.func.id in ("float", "int", "bool") and \
                len(call.args) == 1 and \
                self._dynamic_refs(call.args[0], traced):
            bad = f"{call.func.id}(...)"
        if bad is None:
            return
        self.emitter.emit(
            "host-op-on-traced",
            f"{bad} applied to a traced value inside {scope.qual!r} "
            f"({where}) — a device sync under capture",
            [(scope.file, call.lineno)] + sites_tail)

    # -- rules on program-building host code ---------------------------
    def _check_donation(self, scope: _FnScope):
        node = scope.node
        makers: dict[str, object] = {}   # bound name -> positions|'all'
        donated: list = []               # (name, call_line, call_end)
        # pass 1: donating-maker bindings (the walk is not in source
        # order, so makers must be complete before calls are judged)
        for n in self._own_nodes(node):
            if isinstance(n, (ast.Assign, ast.AnnAssign)) and \
                    isinstance(n.value, ast.Call):
                pos = _donate_positions(n.value)
                if pos is not None:
                    for t in _bind_targets(n):
                        if isinstance(t, ast.Name):
                            makers[t.id] = pos
        # pass 2: calls through a maker donate their positional args
        for n in self._own_nodes(node):
            if not isinstance(n, ast.Call):
                continue
            pos = None
            if isinstance(n.func, ast.Name) and n.func.id in makers:
                pos = makers[n.func.id]
            elif isinstance(n.func, ast.Call):
                pos = _donate_positions(n.func)   # maker()(args) form
            if pos is None:
                continue
            for i, a in enumerate(n.args):
                if pos != "all" and i not in pos:
                    continue
                if isinstance(a, ast.Name):
                    donated.append((a.id, n.lineno,
                                    n.end_lineno or n.lineno))
        if not donated:
            return
        names = {name for name, _l, _e in donated}
        # loads through static-under-donation accessors (.shape/.ndim/
        # len()/isinstance) are METADATA reads — legal on a donated
        # array (only data access dies), pruned like the traced-value
        # rules prune them
        loads = self._dyn_load_lines(node, names)
        stores: dict[str, list] = {}
        for n in self._own_nodes(node):
            if isinstance(n, ast.Name) and not isinstance(n.ctx,
                                                          ast.Load):
                stores.setdefault(n.id, []).append(n.lineno)
        for name, call_line, call_end in donated:
            for use in sorted(loads.get(name, [])):
                if use <= call_end:
                    # inside the (possibly multi-line) donating call
                    # itself: that load IS the donation, not a reuse
                    continue
                # the call line counts as a rebind site (the canonical
                # donate-and-rebind idiom `x = g(x)` stores g's RESULT
                # into x) — but a store ON the use line does not: in
                # `x = x + 1` the RHS reads the dead buffer BEFORE the
                # rebind lands
                st = [s for s in stores.get(name, [])
                      if call_line <= s < use]
                if st:
                    break   # rebound before the use: later uses see
                    # the NEW binding, not the donated buffer. (A loop
                    # target's own store sits at the FOR line, before
                    # call_line — it never exempts a same-iteration
                    # read of the dead buffer, which executes before
                    # the next rebind.)
                self.emitter.emit(
                    "donation-reuse",
                    f"{name!r} donated to a wrapped program at line "
                    f"{call_line} and read again at line {use} in "
                    f"{scope.qual!r} — the donated buffer is dead "
                    f"after dispatch",
                    [(scope.file, use), (scope.file, call_line),
                     (scope.file, getattr(scope.node, "lineno", 1))])
                break       # one finding per donated name

    def _check_churn(self, scope: _FnScope):
        node = scope.node
        # names whose program flows into a subscript store = the
        # retention pattern (per_fn[key] = graph / self._fns[k] = fn)
        cached_names: set = set()
        for n in self._own_nodes(node):
            if isinstance(n, ast.Assign):
                has_sub = any(isinstance(t, ast.Subscript)
                              for t in n.targets)
                if has_sub:
                    if isinstance(n.value, ast.Name):
                        cached_names.add(n.value.id)
                for t in n.targets:
                    if isinstance(t, ast.Name) and (
                            has_sub or self._is_setdefault(n.value)):
                        cached_names.add(t.id)
        decorated_cached = any(
            _call_tail(_dotted(d.func if isinstance(d, ast.Call) else d))
            in ("lru_cache", "cache")
            for d in getattr(node, "decorator_list", []))
        # a program that ESCAPES to the caller (returned directly, or via
        # its bound name) is the factory pattern — the caller owns
        # retention, not churn
        returned_names: set = set()
        returned_calls: set = set()
        for n in self._own_nodes(node):
            if isinstance(n, ast.Return) and n.value is not None:
                if isinstance(n.value, ast.Name):
                    returned_names.add(n.value.id)
                elif isinstance(n.value, ast.Call):
                    returned_calls.add(id(n.value))
        local_defs = {c.name for c in ast.iter_child_nodes(node)
                      if isinstance(c, (ast.FunctionDef,
                                        ast.AsyncFunctionDef))}
        if decorated_cached:
            return
        for n in self._own_nodes(node):
            if not isinstance(n, ast.Call):
                continue
            entry = _capture_fn_arg(n)
            if entry is None or entry[0] == "device_fn":
                continue
            # a program the call returns (a graph) may be kept by its
            # caller; the store's call() and compile_signature() return
            # results, so nothing of theirs can be kept
            makes = _call_tail(_dotted(n.func)) not in ("call",
                                                        "compile_signature")
            bound = self._bound_name(node, n)
            if makes and (bound in cached_names or
                          self._stored_in_subscript(node, n)):
                continue
            if makes and (id(n) in returned_calls or (
                    bound is not None and bound in returned_names)):
                continue
            fn_arg = entry[1]
            fresh_identity = isinstance(fn_arg, ast.Lambda) or (
                isinstance(fn_arg, ast.Name) and fn_arg.id in local_defs)
            if scope.func is None or not fresh_identity:
                # module scope runs once a process; a stable function
                # (a method, a module def, a kept closure) is the
                # retention pattern working
                continue
            d = _dotted(n.func) or "capture"
            self.emitter.emit(
                "jit-cache-churn",
                f"{d}(...) over a per-call fn identity in "
                f"{scope.qual!r} — the store and the captures key on "
                f"the live function, and a fresh lambda/closure per call "
                f"captures a new CUDA graph every time",
                [(scope.file, n.lineno),
                 (scope.file, getattr(scope.node, "lineno", 1))])

    def _dyn_load_lines(self, root, names: set) -> dict:
        """name -> [lineno] of DYNAMIC loads (data access) of
        ``names`` in this scope: nested defs are their own scope, and
        static-metadata contexts (_STATIC_ATTRS/_STATIC_CALLS/is-None)
        are pruned."""
        out: dict = {}

        def walk(n):
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                return
            if self._static_ctx(n):
                return
            if isinstance(n, ast.Name) and \
                    isinstance(n.ctx, ast.Load) and n.id in names:
                out.setdefault(n.id, []).append(n.lineno)
            if isinstance(n, ast.AugAssign) and \
                    isinstance(n.target, ast.Name) and \
                    n.target.id in names:
                # `x += 1` READS the pre-assignment value even though
                # the target's ctx is Store — on a donated buffer
                # that read is the dead-buffer bug
                out.setdefault(n.target.id, []).append(n.lineno)
            for c in ast.iter_child_nodes(n):
                walk(c)

        for c in ast.iter_child_nodes(root):
            walk(c)
        return out

    @staticmethod
    def _is_setdefault(value) -> bool:
        return isinstance(value, ast.Call) and \
            _call_tail(_dotted(value.func)) == "setdefault"

    @staticmethod
    def _bound_name(fnode, call) -> str | None:
        for n in ast.walk(fnode):
            if isinstance(n, (ast.Assign, ast.AnnAssign)) and \
                    n.value is call:
                for t in _bind_targets(n):
                    if isinstance(t, ast.Name):
                        return t.id
        return None

    @staticmethod
    def _stored_in_subscript(fnode, call) -> bool:
        for n in ast.walk(fnode):
            if isinstance(n, ast.Assign) and n.value is call and any(
                    isinstance(t, ast.Subscript) for t in n.targets):
                return True
            if isinstance(n, ast.Call) and call in n.args and \
                    _call_tail(_dotted(n.func)) == "setdefault":
                return True
        return False


# -- public API --------------------------------------------------------

def traced_functions(sources: dict, modules: dict | None = None
                     ) -> dict[str, TracedFn]:
    """The traced set itself (no findings): what the tests assert
    against and ``--json`` consumers can inspect."""
    linker, _supp, _errors = _link(sources, modules)
    tl = _TraceLinker(linker)
    tl.discover()
    return tl.traced


def analyze_sources(sources: dict, rules=None,
                    modules: dict | None = None,
                    supp_sink: dict | None = None,
                    linked=None) -> list[Finding]:
    """Run the trace rules over in-memory sources (``{relpath: src}``)
    — the fixture entry point and the CLI's shared-source path.
    ``linked`` (from :func:`concurrency.link_sources`) reuses one
    parse across the interprocedural halves."""
    linker, suppressions, _errors = (linked if linked is not None
                                     else _link(sources, modules))
    tl = _TraceLinker(linker)
    tl.discover()
    emitter = _Emitter(suppressions,
                       set(rules) if rules is not None else None)
    _RuleRunner(tl, emitter).run()
    if supp_sink is not None:
        supp_sink.update(suppressions)
    emitter.findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return emitter.findings


def analyze(paths, root: str = ".", rules=None
            ) -> tuple[list[Finding], list[str]]:
    """Run the trace rules over files/dirs — (findings, errors), the
    ``check_paths`` contract: unreadable AND unparseable files are
    errors (an unparseable file must never read as a clean one)."""
    sources, modules, errors = read_sources(paths, root=root)
    linked = _link(sources, modules)
    errors.extend(e for e in linked[2] if e not in errors)
    findings = analyze_sources(sources, rules=rules, modules=modules,
                               linked=linked)
    return findings, errors
