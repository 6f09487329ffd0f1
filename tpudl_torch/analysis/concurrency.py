"""Interprocedural concurrency analyzer: the lock graph + four rules.

Port of ``tpudl/analysis/concurrency.py`` over the port's tree: the
same graph and rules, lock sites resolved through the port's registry
(:mod:`tpudl_torch.analysis.locks`), and a device sync
(``torch.cuda.synchronize``, an event's or a stream's
``.synchronize()``) in the blocking catalog beside
``block_until_ready``.

Where :mod:`tpudl_torch.analysis.checker` judges one file at a time, this
module parses the WHOLE tree at once and reasons across calls
(CONCURRENCY.md):

1. it finds every lock construction site —
   ``threading.Lock/RLock/Condition`` or the house factory
   ``tpudl_torch.testing.tsan.named_lock("<registry name>")`` — as a module
   global, an instance attribute, or a function local;
2. it builds a call graph (name-based, may-analysis: an attribute call
   resolves to every plausibly-matching method, a plain call through
   imports) and tracks, lexically, which locks are held at every
   acquisition, call, blocking operation, and shared-state write;
3. it propagates acquisitions and blocking operations transitively
   through the call graph, yielding the **acquired-under** edge set:
   ``A → B`` when some path acquires B while A is held.

Four rules read that graph:

- ``lock-order``: a cycle in the acquired-under edges — the classic
  ABBA inversion, across any number of files and call hops;
- ``lock-held-blocking``: a lock held across a blocking operation
  (bounded queue ``put``, argless ``join()``/``result()``/``wait()``,
  ``block_until_ready``, a device sync, durable-path file IO, ``subprocess``,
  ``time.sleep``) directly or through a callee — the stall/deadlock
  class JOBS.md's flag-only SIGTERM rule exists for;
- ``signal-lock``: a lock acquisition interprocedurally reachable from
  a ``signal.signal``-registered handler (the deep version of the
  intra-procedural ``signal-handler`` rule);
- ``daemon-shared-write``: an attribute/global written both from a
  ``Thread(target=...)``/``submit``-reachable function and from
  foreground code, with no common lock held at the two write sites.

Findings carry the same ``# tpudl: ignore[rule] — reason`` suppression
contract as the per-file rules; an interprocedural finding accepts the
suppression at ANY of its witness sites (the call site, the callee's
``def`` line, the handler's ``def`` line), so one documented reason
covers a deliberate pattern instead of one comment per caller.

This is may-analysis by design: name-based call resolution
over-approximates, and the sweep (fix or reason-suppress every
finding, then gate on clean) is the accuracy mechanism — the same
deal the eight per-file rules make.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field

from . import locks as _locks
from .checker import (Finding, _HINTS, _DURABLE_RE, _FileChecker,
                      iter_python_files)

__all__ = ["CONCURRENCY_RULES", "LockSite", "LockGraph", "analyze",
           "analyze_sources", "build_lock_graph", "read_sources",
           "registry_coverage"]

CONCURRENCY_RULES = ("lock-order", "lock-held-blocking", "signal-lock",
                     "daemon-shared-write")

_LOCK_CTORS = {"threading.Lock": "lock", "threading.RLock": "rlock",
               "threading.Condition": "condition", "Lock": "lock",
               "RLock": "rlock", "Condition": "condition"}

# attribute calls resolved by bare method name are capped at this many
# candidates — a name matching more is too generic to mean anything
_METHOD_CANDIDATE_CAP = 6
# method names too generic for name-based resolution (the blocking
# catalog handles put/join/result/wait separately)
_SKIP_METHODS = frozenset({
    "get", "put", "set", "add", "pop", "append", "appendleft", "update",
    "items", "values", "keys", "join", "close", "read", "write", "open",
    "copy", "split", "strip", "encode", "decode", "format", "lower",
    "upper", "sort", "extend", "clear", "remove", "discard", "wait",
    "result", "done", "cancel", "shutdown", "acquire", "release",
    "tobytes", "reshape", "astype", "flush", "mean", "sum", "info",
    "debug", "warning", "error", "exception", "count", "index", "popleft",
})


def _dotted(node) -> str:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    if parts:
        # receiver is a call/subscript: keep the attr tail so
        # get_recorder().record_stall still resolves by method name
        return "().".join(["?"] + list(reversed(parts)))
    return ""


def _expr_idents(node):
    out = []
    for n in ast.walk(node):
        if isinstance(n, ast.Constant) and isinstance(n.value, str):
            out.append(n.value)
        elif isinstance(n, ast.Name):
            out.append(n.id)
        elif isinstance(n, ast.Attribute):
            out.append(n.attr)
    return out


@dataclass
class LockSite:
    lock_id: str          # canonical graph node id
    name: str | None      # named_lock registry literal (None = raw)
    kind: str             # lock | rlock | condition
    file: str             # repo-relative path
    line: int
    module: str
    cls: str | None = None
    attr: str | None = None   # instance-attribute name, if any


@dataclass
class _Func:
    key: str              # "<module>:<qualname>"
    module: str
    qual: str
    cls: str | None
    file: str
    line: int
    name: str
    params: tuple = ()
    # each entry carries the lexically-held descriptor tuple at that
    # point; descriptors are resolved to lock_ids in the link phase
    acquires: list = field(default_factory=list)  # (desc, line, held)
    calls: list = field(default_factory=list)     # (desc, line, held)
    blocking: list = field(default_factory=list)  # (what, line, held)
    writes: list = field(default_factory=list)    # (loc, line, held)


@dataclass
class LockGraph:
    """What `build_lock_graph` hands the coverage test and the CLI."""
    locks: list            # [LockSite]
    edges: dict            # (lock_id_a, lock_id_b) -> witness dict
    functions: dict        # key -> _Func

    def sites_by_name(self) -> dict:
        return {s.name: s for s in self.locks if s.name}

    def anonymous_sites(self) -> list:
        return [s for s in self.locks if s.name is None]


def _flat_targets(targets) -> list:
    """Flatten tuple/list/starred assignment targets — `_A, _B = ...`
    writes both names just as racily as the single-name form (the same
    hardening the per-file unlocked-global rule carries)."""
    out, stack = [], list(targets)
    while stack:
        t = stack.pop()
        if isinstance(t, (ast.Tuple, ast.List)):
            stack.extend(t.elts)
        elif isinstance(t, ast.Starred):
            stack.append(t.value)
        else:
            out.append(t)
    return out


class _ModuleScan:
    """One file's raw facts (phase 1). Resolution happens globally in
    phase 2 — an instance-attribute lock or a cross-module call can
    only be resolved once every file has been scanned."""

    def __init__(self, src: str, relpath: str, module: str | None = None):
        self.rel = relpath.replace(os.sep, "/")
        if module is None:
            mod = self.rel[:-3] if self.rel.endswith(".py") else self.rel
            if mod.endswith("/__init__"):
                # a package's __init__ IS the package for import
                # resolution (`import tpudl.native` must find its locks)
                mod = mod[: -len("/__init__")]
            module = mod.replace("/", ".")
        self.module = module
        self.tree = ast.parse(src, filename=relpath)
        self.imports: dict[str, str] = {}        # alias -> module
        self.from_imports: dict[str, tuple] = {}  # name -> (module, orig)
        self.locks: list[LockSite] = []
        self.funcs: dict[str, _Func] = {}        # qual -> _Func
        self.classes: dict[str, dict] = {}       # cls -> {meth: qual}
        self.class_attrs: dict[str, set] = {}    # cls -> attrs assigned
        self.signal_handlers: list = []          # (desc, line, qual)
        self.spawns: list = []                   # (desc, line, qual)
        self._scan_imports()
        self._scan(self.tree, qual="", cls=None, func=None, held=())

    # -- phase 1: the walk --------------------------------------------
    def _scan_imports(self):
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.imports[a.asname or a.name.split(".")[0]] = a.name
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    self.from_imports[a.asname or a.name] = (
                        node.module, a.name)

    def _lock_ctor(self, call: ast.Call):
        """(kind, registry_name) when ``call`` constructs a lock."""
        d = _dotted(call.func)
        tail = d.rsplit(".", 1)[-1]
        if tail == "named_lock":
            name = None
            if call.args and isinstance(call.args[0], ast.Constant) \
                    and isinstance(call.args[0].value, str):
                name = call.args[0].value
            kind = "lock"
            for kw in call.keywords:
                if kw.arg == "kind" and isinstance(kw.value, ast.Constant):
                    kind = str(kw.value.value)
            return kind, name
        if d in _LOCK_CTORS and (d.startswith("threading.")
                                 or tail in self.from_imports):
            return _LOCK_CTORS[d], None
        return None

    def _scan(self, node, qual, cls, func, held):
        for child in ast.iter_child_nodes(node):
            self._visit(child, qual, cls, func, held)

    def _visit(self, node, qual, cls, func, held):
        if isinstance(node, ast.ClassDef):
            self.classes.setdefault(node.name, {})
            self.class_attrs.setdefault(node.name, set())
            self._scan(node, qual=node.name, cls=node.name, func=None,
                       held=())
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fq = f"{qual}.{node.name}" if qual else node.name
            f = _Func(key=f"{self.module}:{fq}", module=self.module,
                      qual=fq, cls=cls, file=self.rel, line=node.lineno,
                      name=node.name,
                      params=tuple(a.arg for a in node.args.args))
            self.funcs[fq] = f
            if cls is not None and qual == cls:
                self.classes[cls][node.name] = fq
            self._scan(node, qual=fq, cls=cls, func=f, held=())
            return
        if isinstance(node, ast.With):
            new_held = held
            for item in node.items:
                desc = self._with_lock_desc(item.context_expr)
                if desc is not None:
                    if func is not None:
                        func.acquires.append((desc, node.lineno, new_held))
                    new_held = new_held + (desc,)
                else:
                    # a non-lock with-item runs with every lock from
                    # the EARLIER items already held: `with self._lock,
                    # open(manifest, "w"):` is durable IO under the
                    # lock, and nested calls in the item's expression
                    # keep their call edges
                    self._visit(item.context_expr, qual, cls, func,
                                new_held)
            for child in node.body:
                self._visit(child, qual, cls, func, new_held)
            return
        if isinstance(node, ast.Call):
            self._visit_call(node, qual, cls, func, held)
            self._scan(node, qual, cls, func, held)
            return
        if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            self._visit_assign(node, qual, cls, func, held)
            self._scan(node, qual, cls, func, held)
            return
        self._scan(node, qual, cls, func, held)

    def _with_lock_desc(self, expr):
        """A with-item that acquires a lock → its descriptor."""
        if isinstance(expr, (ast.Name, ast.Attribute)):
            d = _dotted(expr)
            if d:
                return ("lockref", d)
        return None

    def _visit_call(self, call: ast.Call, qual, cls, func, held):
        d = _dotted(call.func)
        tail = d.rsplit(".", 1)[-1] if d else ""

        # explicit .acquire() — an acquisition event (held-set is NOT
        # extended: the matching release is not lexically visible)
        if tail == "acquire" and "." in d and func is not None:
            func.acquires.append((("lockref", d.rsplit(".", 1)[0]),
                                  call.lineno, held))
            return

        # thread spawns
        if tail == "Thread":
            for kw in call.keywords:
                if kw.arg == "target":
                    t = _dotted(kw.value)
                    if t:
                        self.spawns.append((("call", t), call.lineno,
                                            qual))
        elif tail == "submit" and call.args:
            t = _dotted(call.args[0])
            if t:
                self.spawns.append((("call", t), call.lineno, qual))

        # signal handler registration
        if d == "signal.signal" and len(call.args) == 2:
            t = _dotted(call.args[1])
            if t:
                self.signal_handlers.append((("call", t), call.lineno,
                                             qual))

        if func is None:
            return

        # blocking catalog
        blk = self._blocking_kind(call, d, tail)
        if blk is not None:
            func.blocking.append((blk, call.lineno, held))

        # the call edge itself
        if d and tail not in ("Thread", "named_lock") \
                and d not in _LOCK_CTORS:
            func.calls.append((("call", d), call.lineno, held))

    def _blocking_kind(self, call, d, tail) -> str | None:
        if tail == "put" and "queue" in d.lower():
            return "bounded-queue put"
        if tail in ("join", "result", "wait") and not call.args \
                and not call.keywords and "." in d:
            return f"argless .{tail}() (unbounded wait)"
        if tail == "block_until_ready":
            return "block_until_ready (device sync)"
        if tail == "synchronize" and not call.args:
            return f"{d}() (device sync)"
        if d.startswith("subprocess."):
            return f"{d} (child process)"
        if d == "time.sleep":
            return "time.sleep"
        if d in ("np.save", "np.savez", "np.savez_compressed",
                 "numpy.save", "numpy.savez"):
            if call.args and _DURABLE_RE.search(
                    " ".join(_expr_idents(call.args[0])).lower()):
                return f"{d} (durable file IO)"
            return None
        if tail in ("open",) and d in ("open", "gzip.open") and call.args:
            mode = None
            if len(call.args) >= 2 and isinstance(call.args[1],
                                                  ast.Constant):
                mode = call.args[1].value
            for kw in call.keywords:
                if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
                    mode = kw.value.value
            if isinstance(mode, str) and mode[0] in "wa":
                ev = " ".join(_expr_idents(call.args[0])).lower()
                if _DURABLE_RE.search(ev):
                    return "durable file IO (write)"
        return None

    def _visit_assign(self, node, qual, cls, func, held):
        value = node.value
        targets = _flat_targets(
            node.targets if isinstance(node, ast.Assign)
            else [node.target] if node.target is not None else [])
        # lock construction sites
        ctor = (self._lock_ctor(value)
                if isinstance(value, ast.Call) else None)
        if ctor is not None:
            kind, name = ctor
            for t in targets:
                if isinstance(t, ast.Name) and func is None:
                    self.locks.append(LockSite(
                        lock_id=f"{self.module}.{t.id}", name=name,
                        kind=kind, file=self.rel, line=node.lineno,
                        module=self.module))
                elif isinstance(t, ast.Name) and func is not None:
                    self.locks.append(LockSite(
                        lock_id=f"{self.module}.{func.qual}.{t.id}",
                        name=name, kind=kind, file=self.rel,
                        line=node.lineno, module=self.module))
                elif isinstance(t, ast.Attribute) and \
                        isinstance(t.value, ast.Name) and \
                        t.value.id == "self" and cls is not None:
                    self.locks.append(LockSite(
                        lock_id=f"{self.module}.{cls}.{t.attr}",
                        name=name, kind=kind, file=self.rel,
                        line=node.lineno, module=self.module, cls=cls,
                        attr=t.attr))
            return
        # shared-state writes (only inside functions)
        if func is None:
            return
        if value is None:
            return  # annotation-only `self.x: T` — no store happens
        # `x += 1` is a read-modify-write — NEVER a GIL-atomic const
        # store, even though AugAssign.value is the Constant operand
        const_only = isinstance(value, ast.Constant) and \
            not isinstance(node, ast.AugAssign)
        for t in targets:
            if isinstance(t, ast.Attribute) and \
                    isinstance(t.value, ast.Name):
                if t.value.id == "self" and cls is not None:
                    if func.name not in ("__init__", "__new__"):
                        func.writes.append(
                            ((("attr", self.module, cls, t.attr),
                              const_only), node.lineno, held))
                    self.class_attrs.setdefault(cls, set()).add(t.attr)
                elif t.value.id != "self":
                    func.writes.append(
                        ((("xattr", t.attr), const_only),
                         node.lineno, held))
        # module-global rebinds: recorded as maybe-global; the linker
        # keeps only names the function actually declares `global`
        names = [t.id for t in targets if isinstance(t, ast.Name)]
        if names:
            func.writes.append(((("maybe-global", tuple(names)),
                                 const_only), node.lineno, held))


class _Linker:
    """Phase 2: resolve descriptors against the full scan set, build
    the transitive lock graph, and run the four rules."""

    def __init__(self, scans: list[_ModuleScan]):
        self.scans = scans
        self.by_module = {s.module: s for s in scans}
        self.funcs: dict[str, _Func] = {}
        self.method_index: dict[str, list[_Func]] = {}
        self.lock_sites: dict[str, LockSite] = {}
        self.lock_attr_index: dict[str, list[LockSite]] = {}
        self.global_decls: dict[str, set] = {}  # func key -> names
        for s in scans:
            for f in s.funcs.values():
                self.funcs[f.key] = f
                self.method_index.setdefault(f.name, []).append(f)
            for site in s.locks:
                self.lock_sites[site.lock_id] = site
                if site.attr:
                    self.lock_attr_index.setdefault(site.attr,
                                                    []).append(site)
        self._collect_global_decls()
        self._acq_memo: dict[str, dict] = {}
        self._blk_memo: dict[str, dict] = {}

    def _collect_global_decls(self):
        for s in self.scans:
            for node in ast.walk(s.tree):
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    names = set()
                    for n in ast.walk(node):
                        if isinstance(n, ast.Global):
                            names.update(n.names)
                    if names:
                        for f in s.funcs.values():
                            if f.line == node.lineno and \
                                    f.name == node.name:
                                self.global_decls[f.key] = names

    # -- descriptor resolution ----------------------------------------
    def resolve_lock(self, desc, f: _Func) -> str | None:
        """('lockref', dotted) → lock_id, or a synthetic node for a
        lock-looking name we can't place, or None (not a lock)."""
        _, d = desc
        s = self.by_module[f.module]
        head, _, rest = d.partition(".")
        if head == "self" and rest and f.cls is not None:
            attr = rest.split(".")[0]
            lid = f"{f.module}.{f.cls}.{attr}"
            if lid in self.lock_sites:
                return lid
            # an attr assigned in ANOTHER class of this module (mixin)
            for cls in s.classes:
                lid = f"{f.module}.{cls}.{attr}"
                if lid in self.lock_sites:
                    return lid
        if "." not in d:
            # local lock, then module global, then from-import
            lid = f"{f.module}.{f.qual}.{d}"
            if lid in self.lock_sites:
                return lid
            # enclosing function scopes (nested defs)
            parts = f.qual.split(".")
            for i in range(len(parts) - 1, 0, -1):
                lid = f"{f.module}.{'.'.join(parts[:i])}.{d}"
                if lid in self.lock_sites:
                    return lid
            lid = f"{f.module}.{d}"
            if lid in self.lock_sites:
                return lid
            if d in s.from_imports:
                mod, orig = s.from_imports[d]
                lid = f"{mod}.{orig}"
                if lid in self.lock_sites:
                    return lid
        else:
            if head in s.imports:
                lid = f"{s.imports[head]}.{rest}"
                if lid in self.lock_sites:
                    return lid
            # foreign instance attr (hb._iflock): unique attr wins
            attr = d.rsplit(".", 1)[-1]
            cands = self.lock_attr_index.get(attr, [])
            if len(cands) == 1:
                return cands[0].lock_id
        if "lock" in d.lower():
            # lock-looking but unplaceable: synthesize a per-module
            # node so held-across-blocking still sees it
            return f"?{f.module}.{d}"
        return None

    def resolve_call(self, desc, f: _Func) -> list[_Func]:
        _, d = desc
        s = self.by_module[f.module]
        head, _, rest = d.partition(".")
        tail = d.rsplit(".", 1)[-1]
        if tail == "check_guarded":
            # the sanitizer's assertion probe is NOT a call edge: its
            # breadcrumb path is muted from runtime edge-noting, and
            # its finding path only runs on a MISS — when the checked
            # lock is provably not held. Modeling it would manufacture
            # a by-construction-false order edge out of every probe
            # placed under the very lock it checks.
            return []
        if "." not in d:
            # nested sibling / enclosing scope
            parts = f.qual.split(".")
            for i in range(len(parts), -1, -1):
                q = ".".join(parts[:i] + [d]) if i else d
                g = s.funcs.get(q)
                if g is not None:
                    return [g]
            # classmethod-free constructor: C() runs C.__init__
            if d in s.classes:
                q = s.classes[d].get("__init__")
                if q:
                    return [s.funcs[q]]
            if d in s.from_imports:
                mod, orig = s.from_imports[d]
                ms = self.by_module.get(mod)
                if ms is not None and orig in ms.funcs:
                    return [ms.funcs[orig]]
            return []
        if head == "self" and f.cls is not None:
            meth = rest.split(".")[0]
            q = s.classes.get(f.cls, {}).get(meth)
            if q:
                return [s.funcs[q]]
            for cls, methods in s.classes.items():
                if meth in methods:
                    return [s.funcs[methods[meth]]]
        if head in s.imports:
            ms = self.by_module.get(s.imports[head])
            if ms is not None:
                q = rest.split(".")[0]
                if q in ms.funcs:
                    return [ms.funcs[q]]
        if head in s.from_imports:
            # from x import y; y.attr() — y may be a module or a class
            mod, orig = s.from_imports[head]
            ms = self.by_module.get(f"{mod}.{orig}") or \
                self.by_module.get(mod)
            if ms is not None:
                meth = rest.split(".")[0]
                if meth in ms.funcs:
                    return [ms.funcs[meth]]
        # name-based method resolution (may-analysis)
        if tail in _SKIP_METHODS or tail.startswith("__"):
            return []
        cands = self.method_index.get(tail, [])
        if 1 <= len(cands) <= _METHOD_CANDIDATE_CAP:
            return [g for g in cands if g.key != f.key]
        return []

    def resolve_held(self, held, f: _Func) -> tuple:
        out = []
        for desc in held:
            lid = self.resolve_lock(desc, f)
            if lid is not None:
                out.append(lid)
        return tuple(out)

    # -- transitive closures ------------------------------------------
    def acquires_of(self, f: _Func, _stack=None) -> dict:
        """lock_id -> witness (file, line, qual) acquired in f or any
        callee (cycle-tolerant DFS with memo). Only ROOT results are
        memoized: a closure computed while an ancestor is on the DFS
        stack is truncated by the cycle back-edge, and caching it
        would make findings depend on definition order."""
        if f.key in self._acq_memo:
            return self._acq_memo[f.key]
        is_root = not _stack
        _stack = _stack or set()
        if f.key in _stack:
            return {}
        _stack.add(f.key)
        out: dict = {}
        for desc, line, _held in f.acquires:
            lid = self.resolve_lock(desc, f)
            if lid is not None and lid not in out:
                out[lid] = (f.file, line, f.qual)
        for desc, line, _held in f.calls:
            for g in self.resolve_call(desc, f):
                for lid, w in self.acquires_of(g, _stack).items():
                    out.setdefault(lid, w)
        _stack.discard(f.key)
        if is_root:
            self._acq_memo[f.key] = out
        return out

    def blocking_of(self, f: _Func, _stack=None) -> dict:
        """what -> witness for blocking ops in f or any callee (memo
        on ROOT results only — see acquires_of)."""
        if f.key in self._blk_memo:
            return self._blk_memo[f.key]
        is_root = not _stack
        _stack = _stack or set()
        if f.key in _stack:
            return {}
        _stack.add(f.key)
        out: dict = {}
        for what, line, _held in f.blocking:
            out.setdefault(what, (f.file, line, f.qual))
        for desc, line, _held in f.calls:
            for g in self.resolve_call(desc, f):
                for what, w in self.blocking_of(g, _stack).items():
                    out.setdefault(what, w)
        _stack.discard(f.key)
        if is_root:
            self._blk_memo[f.key] = out
        return out

    # -- the lock graph -----------------------------------------------
    def _note_self_nest(self, lid: str, witness: dict):
        """h == lid nesting: for a non-reentrant lock this is a
        guaranteed self-deadlock (same instance) or an equal-rank
        violation (sibling instances of one per-instance class — equal
        ranks never nest, CONCURRENCY.md). RLocks/conditions are
        reentrant: legit."""
        site = self.lock_sites.get(lid)
        if site is not None and site.kind == "lock":
            self.self_nests.setdefault(lid, []).append(witness)

    def build_edges(self) -> dict:
        """(A, B) -> witness: B acquired (directly or transitively)
        while A held. Same-lock (h == lid) nesting is kept OUT of the
        edge set (a self-loop is not an order cycle) and recorded in
        ``self.self_nests`` instead."""
        edges: dict = {}
        self.self_nests: dict[str, list] = {}
        for f in self.funcs.values():
            for desc, line, held in f.acquires:
                lid = self.resolve_lock(desc, f)
                if lid is None:
                    continue
                for h in self.resolve_held(held, f):
                    if h != lid:
                        edges.setdefault((h, lid),
                                         {"file": f.file, "line": line,
                                          "func": f.qual, "via": None})
                    else:
                        self._note_self_nest(
                            lid, {"file": f.file, "line": line,
                                  "func": f.qual, "via": None})
            for desc, line, held in f.calls:
                hids = self.resolve_held(held, f)
                if not hids:
                    continue
                for g in self.resolve_call(desc, f):
                    for lid, w in self.acquires_of(g).items():
                        for h in hids:
                            if h != lid:
                                edges.setdefault(
                                    (h, lid),
                                    {"file": f.file, "line": line,
                                     "func": f.qual,
                                     "via": f"{g.qual} at {w[0]}:{w[1]}"})
                            else:
                                self._note_self_nest(
                                    lid,
                                    {"file": f.file, "line": line,
                                     "func": f.qual,
                                     "via": f"{g.qual} at {w[0]}:{w[1]}"})
        return edges

    # -- reachability sets --------------------------------------------
    def _closure(self, roots: list[_Func]) -> set:
        seen = set()
        stack = list(roots)
        while stack:
            f = stack.pop()
            if f.key in seen:
                continue
            seen.add(f.key)
            for desc, _line, _held in f.calls:
                stack.extend(self.resolve_call(desc, f))
        return seen


def _scc(edges: dict) -> list[list[str]]:
    """Tarjan over the lock graph; returns SCCs of size >= 2."""
    succ: dict[str, list] = {}
    nodes: set = set()
    for (a, b) in edges:
        succ.setdefault(a, []).append(b)
        nodes.add(a)
        nodes.add(b)
    index: dict[str, int] = {}
    low: dict[str, int] = {}
    on: set = set()
    stack: list = []
    out: list[list[str]] = []
    counter = [0]

    def strong(v):
        work = [(v, 0)]
        while work:
            node, pi = work[-1]
            if pi == 0:
                index[node] = low[node] = counter[0]
                counter[0] += 1
                stack.append(node)
                on.add(node)
            advanced = False
            for i in range(pi, len(succ.get(node, []))):
                w = succ[node][i]
                if w not in index:
                    work[-1] = (node, i + 1)
                    work.append((w, 0))
                    advanced = True
                    break
                if w in on:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            if low[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on.discard(w)
                    comp.append(w)
                    if w == node:
                        break
                if len(comp) >= 2:
                    out.append(sorted(comp))
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])

    for n in sorted(nodes):
        if n not in index:
            strong(n)
    return out


class _Emitter:
    """Suppression-aware finding sink over MANY files (an
    interprocedural finding may be silenced at any witness site)."""

    def __init__(self, suppressions: dict, rule_filter):
        # suppressions: file -> {line: [(rules, reason)]}
        self.suppressions = suppressions
        self.rule_filter = rule_filter
        self.findings: list[Finding] = []

    def emit(self, rule: str, message: str, sites: list):
        """``sites`` is [(file, line)], primary first."""
        if self.rule_filter is not None and rule not in self.rule_filter:
            return
        for file, line in sites:
            for sup in self.suppressions.get(file, {}).get(line, []):
                if rule in sup.rules:
                    sup.used.add(rule)
                    if not sup.reason:
                        self.findings.append(Finding(
                            file, line, 0, rule,
                            f"suppression for [{rule}] is missing its "
                            f"required reason",
                            "write the why after the bracket: "
                            "# tpudl: ignore[rule] — <reason>"))
                    return
        file, line = sites[0]
        self.findings.append(Finding(file, line, 0, rule, message,
                                     _HINTS.get(rule, "")))


def _short(lock_id: str) -> str:
    site_name = lock_id.lstrip("?")
    return site_name


def _package_module(path: str) -> str:
    """Dotted module name derived from the FILE, walking up while
    __init__.py exists — correct no matter what cwd or path shape the
    caller used (a cwd-relative fallback would silently break every
    cross-module resolution and report a false clean)."""
    name = os.path.splitext(os.path.basename(path))[0]
    parts = [] if name == "__init__" else [name]
    d = os.path.dirname(os.path.abspath(path))
    while os.path.exists(os.path.join(d, "__init__.py")):
        parts.insert(0, os.path.basename(d))
        d = os.path.dirname(d)
    return ".".join(parts) or name


def read_sources(paths, root: str = ".") -> tuple[dict, dict, list]:
    """Read every python file under ``paths`` ONCE: returns
    ``(sources, modules, errors)`` where sources maps relpath → text,
    and modules carries package-derived dotted names for any path that
    escapes ``root`` (cwd-independence). Shared by both checker halves
    so the gate reads the tree a single time."""
    sources: dict = {}
    modules: dict = {}
    errors: list[str] = []
    for path in iter_python_files(paths):
        rel = os.path.relpath(path, root)
        try:
            with open(path, encoding="utf-8") as f:
                sources[rel] = f.read()
        except (OSError, UnicodeDecodeError) as e:
            errors.append(f"{path}: {e}")
            continue
        # always package-derived: canonical whether the caller scanned
        # from the repo root, a subdir, or with absolute paths
        modules[rel] = _package_module(path)
    return sources, modules, errors


def _link(sources: dict, modules: dict | None = None
          ) -> tuple[_Linker, dict, list]:
    """sources: relpath -> src (modules: optional relpath -> dotted
    module override). Returns (linker, suppressions, parse_errors)."""
    scans = []
    suppressions: dict = {}
    errors: list[str] = []
    modules = modules or {}
    for rel, src in sorted(sources.items()):
        try:
            scans.append(_ModuleScan(src, rel, module=modules.get(rel)))
        except SyntaxError as e:
            errors.append(f"{rel}: {e}")
            continue
        fc = _FileChecker(src, rel, rel)
        fc._scan_comments()
        suppressions[rel.replace(os.sep, "/")] = fc.suppressions
    return _Linker(scans), suppressions, errors


def _run_rules(linker: _Linker, emitter: _Emitter):
    edges = linker.build_edges()

    # -- lock-order ----------------------------------------------------
    # same-lock nesting first: a non-reentrant lock acquired while
    # itself held — self-deadlock (same instance) or equal-rank
    # nesting (sibling instances), either way a contract violation
    for lid, ws in sorted(linker.self_nests.items()):
        ws = sorted(ws, key=lambda w: (w["file"], w["line"]))
        w = ws[0]
        via = f" via {w['via']}" if w.get("via") else ""
        emitter.emit(
            "lock-order",
            f"same-lock nested acquisition: non-reentrant "
            f"{_short(lid)} acquired while already held in "
            f"{w['func']}{via} — same instance self-deadlocks, "
            f"sibling instances are rank-equal (equal ranks never "
            f"nest)",
            [(x["file"], x["line"]) for x in ws])

    for comp in _scc(edges):
        comp_set = set(comp)
        witnesses = sorted(
            ((a, b, w) for (a, b), w in edges.items()
             if a in comp_set and b in comp_set),
            key=lambda t: (t[2]["file"], t[2]["line"]))
        cycle = " -> ".join(_short(c) for c in comp) \
            + f" -> {_short(comp[0])}"
        ws = "; ".join(f"{_short(a)}->{_short(b)} at "
                       f"{w['file']}:{w['line']}"
                       for a, b, w in witnesses[:4])
        emitter.emit(
            "lock-order",
            f"lock-order cycle (ABBA deadlock risk): {cycle} "
            f"[witnesses: {ws}]",
            [(w["file"], w["line"]) for _a, _b, w in witnesses])

    # -- lock-held-blocking -------------------------------------------
    for f in linker.funcs.values():
        for what, line, held in f.blocking:
            hids = linker.resolve_held(held, f)
            if hids:
                emitter.emit(
                    "lock-held-blocking",
                    f"{_short(hids[0])} held across {what} in "
                    f"{f.qual}",
                    [(f.file, line), (f.file, f.line)])
        for desc, line, held in f.calls:
            hids = linker.resolve_held(held, f)
            if not hids:
                continue
            for g in linker.resolve_call(desc, f):
                blocks = linker.blocking_of(g)
                if not blocks:
                    continue
                what, w = next(iter(sorted(blocks.items())))
                emitter.emit(
                    "lock-held-blocking",
                    f"{_short(hids[0])} held across call to "
                    f"{g.qual}, which reaches {what} at "
                    f"{w[0]}:{w[1]}",
                    [(f.file, line), (g.file, g.line),
                     (w[0], w[1])])
                break  # one finding per call site

    # -- signal-lock ---------------------------------------------------
    for s in linker.scans:
        for desc, reg_line, qual in s.signal_handlers:
            # resolve the handler in the registering function's scope
            ctx = s.funcs.get(qual) or _Func(
                key=f"{s.module}:<module>", module=s.module,
                qual="<module>", cls=None, file=s.rel, line=reg_line,
                name="<module>")
            if ctx.module not in linker.by_module:
                continue
            handlers = linker.resolve_call(desc, ctx)
            for h in handlers:
                acq = linker.acquires_of(h)
                for lid, w in sorted(acq.items()):
                    emitter.emit(
                        "signal-lock",
                        f"signal handler {h.qual!r} can reach a lock "
                        f"acquisition of {_short(lid)} at "
                        f"{w[0]}:{w[1]} — an interrupted frame may "
                        f"already hold it",
                        [(h.file, h.line), (s.rel, reg_line)])

    # -- daemon-shared-write ------------------------------------------
    entries: list[_Func] = []
    for s in linker.scans:
        for desc, _line, qual in s.spawns:
            ctx = s.funcs.get(qual) or _Func(
                key=f"{s.module}:<module>", module=s.module,
                qual="<module>", cls=None, file=s.rel, line=_line,
                name="<module>")
            entries.extend(linker.resolve_call(desc, ctx))
    bg = linker._closure(entries)
    writes: dict = {}  # loc -> {"bg": [...], "fg": [...]}
    for f in linker.funcs.values():
        if f.name.endswith("_locked"):
            continue  # the caller-holds-the-lock naming contract
        side = "bg" if f.key in bg else "fg"
        for (loc, const_only), line, held in f.writes:
            if const_only:
                continue  # GIL-atomic flag stores are the house idiom
            if loc[0] == "maybe-global":
                decls = linker.global_decls.get(f.key, set())
                names = [n for n in loc[1] if n in decls]
                # one record PER name: `_A, _B = ...` writes both just
                # as racily as the single-name form
                for n in names:
                    writes.setdefault(("global", f.module, n),
                                      {"bg": [], "fg": []})[side].append(
                        (f, line, linker.resolve_held(held, f)))
                continue
            elif loc[0] == "xattr":
                cands = [
                    (s.module, cls)
                    for s in linker.scans
                    for cls, attrs in s.class_attrs.items()
                    if loc[1] in attrs]
                if len(cands) != 1:
                    continue
                key = ("attr", cands[0][0], cands[0][1], loc[1])
            else:
                key = loc
            writes.setdefault(key, {"bg": [], "fg": []})[side].append(
                (f, line, linker.resolve_held(held, f)))
    for key, sides in sorted(writes.items(), key=lambda kv: str(kv[0])):
        if not sides["bg"] or not sides["fg"]:
            continue
        all_sites = sides["bg"] + sides["fg"]
        common = set(all_sites[0][2])
        for _f, _line, held in all_sites[1:]:
            common &= set(held)
        if common:
            continue
        loc_name = ".".join(str(p) for p in key[1:])
        bg_f, bg_line, _ = sides["bg"][0]
        fg_f, fg_line, _ = sides["fg"][0]
        emitter.emit(
            "daemon-shared-write",
            f"{loc_name} is written from thread-reachable "
            f"{bg_f.qual} ({bg_f.file}:{bg_line}) and foreground "
            f"{fg_f.qual} ({fg_f.file}:{fg_line}) with no common "
            f"lock",
            [(f.file, line) for f, line, _h in all_sites])


# -- public API --------------------------------------------------------

def link_sources(sources: dict, modules: dict | None = None
                 ) -> tuple["_Linker", dict, list]:
    """Parse + comment-scan the tree ONCE: ``(linker, suppressions,
    parse_errors)``. The CLI builds this once and hands it to both
    interprocedural halves (concurrency + traceguard) so the gate
    never re-parses per half; shared Suppression objects also merge
    usage marks for free."""
    return _link(sources, modules)


def analyze_sources(sources: dict, rules=None,
                    modules: dict | None = None,
                    supp_sink: dict | None = None,
                    linked=None) -> list[Finding]:
    """Run the concurrency rules over in-memory sources
    (``{relpath: src}``) — the fixture entry point (and, via
    ``modules``, the shared-source path the CLI uses). ``supp_sink``
    receives this pass's suppression records with usage marks (the
    stale-suppression audit merges them across halves); ``linked``
    (from :func:`link_sources`) skips the re-parse."""
    linker, suppressions, errors = (linked if linked is not None
                                    else _link(sources, modules))
    emitter = _Emitter(suppressions,
                       set(rules) if rules is not None else None)
    _run_rules(linker, emitter)
    if supp_sink is not None:
        supp_sink.update(suppressions)
    emitter.findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return emitter.findings


def analyze(paths, root: str = ".", rules=None
            ) -> tuple[list[Finding], list[str]]:
    """Run the concurrency rules over files/dirs. Returns
    (findings, errors); unreadable/unparseable files are errors, same
    contract as ``check_paths``."""
    sources, modules, errors = read_sources(paths, root=root)
    linker, suppressions, parse_errors = _link(sources, modules)
    errors.extend(parse_errors)
    emitter = _Emitter(suppressions,
                       set(rules) if rules is not None else None)
    _run_rules(linker, emitter)
    emitter.findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return emitter.findings, errors


def build_lock_graph(paths=None, root: str = ".",
                     sources: dict | None = None) -> LockGraph:
    """The lock graph itself (no findings): every construction site,
    the acquired-under edges, and the function table — what the
    coverage round-trip test audits against the registry
    (:mod:`tpudl_torch.analysis.locks`)."""
    modules = None
    if sources is None:
        sources, modules, _errors = read_sources(paths or [], root=root)
    linker, _supp, _errors = _link(sources, modules)
    return LockGraph(locks=list(linker.lock_sites.values()),
                     edges=linker.build_edges(),
                     functions=linker.funcs)


def registry_coverage(paths, root: str = ".") -> dict:
    """Declared-vs-constructed delta for the lock registry (the
    CONCURRENCY.md round-trip; mirrors the knob/metric audits):
    ``named`` = names seen at named_lock sites, ``anonymous`` = raw
    threading.* construction sites (allowed only in the sanitizer's
    own internals), plus the two drift directions."""
    graph = build_lock_graph(paths, root=root)
    named = {s.name for s in graph.locks if s.name}
    decls = set(_locks.LOCK_NAMES)
    return {
        "named": named,
        "anonymous": [f"{s.file}:{s.line}" for s in graph.locks
                      if s.name is None],
        "undeclared": sorted(named - decls),
        "unconstructed": sorted(decls - named),
    }
