"""A deliberately tiny SQL SELECT layer over the port's ``Frame``.

Copied from ``tpudl/frame/sql.py`` (host-only): the same grammar,

    SELECT <item> [, <item>...] FROM <table>
        [WHERE <pred> [AND <pred>...]]
        [GROUP BY col [, col...]]
        [ORDER BY ocol [ASC|DESC] [, ...]] [LIMIT n]
    item := * | col | fn(col) | agg | <any of those> AS alias
    agg  := COUNT(*) | COUNT(col) | SUM(col) | AVG(col)
            | MIN(col) | MAX(col)
    pred := col <op> literal | col IS [NOT] NULL
    op   := = | != | <> | < | <= | > | >=      literal := number | 'text'

and the same semantics: WHERE runs first, so filtered rows are never
featurized; without ORDER BY a LIMIT is pushed below the projection, so
rows past it are never featurized either; aggregates skip NULL/NaN, an
empty group yields NULL (``COUNT`` 0); NULL keys form one group; ORDER BY
names output columns, NULLs last in both directions. No JOIN, HAVING,
subqueries or DISTINCT. ``fn(col)`` calls a UDF of
:mod:`tpudl_torch.udf.registry`; aggregate names win over a same-named
UDF.
"""

from __future__ import annotations

import re

import numpy as np

from tpudl_torch.frame.frame import Frame, null_mask

__all__ = ["sql"]

# position-is-outside-quotes guard (even number of quotes remaining) —
# the same trick _AND_SPLIT_RE uses, so clause keywords inside WHERE
# string literals ('a order by b') never terminate the WHERE group
_Q = r"(?=(?:[^']*'[^']*')*[^']*$)"
_SELECT_RE = re.compile(
    r"^\s*select\s+(?P<items>.+?)\s+from\s+(?P<table>\w+)"
    rf"(?:\s+where\s+{_Q}(?P<where>.+?))?"
    rf"(?:\s+group\s+by\s+{_Q}(?P<group>.+?))?"
    rf"(?:\s+order\s+by\s+{_Q}(?P<order>.+?))?"
    rf"(?:\s+limit\s+{_Q}(?P<limit>\d+))?\s*;?\s*$",
    re.IGNORECASE | re.DOTALL,
)
_ITEM_RE = re.compile(
    r"^\s*(?:(?P<fn>\w+)\s*\(\s*(?P<arg>\w+)\s*\)|(?P<col>\w+))"
    r"(?:\s+as\s+(?P<alias>\w+))?\s*$",
    re.IGNORECASE,
)
_CMP_RE = re.compile(
    r"^\s*(?P<col>\w+)\s*(?P<op><=|>=|!=|<>|=|<|>)\s*"
    r"(?P<lit>-?\d+(?:\.\d+)?|'[^']*')\s*$")
_NULL_RE = re.compile(
    r"^\s*(?P<col>\w+)\s+is\s+(?P<neg>not\s+)?null\s*$", re.IGNORECASE)


_AGG_FNS = ("count", "sum", "avg", "mean", "min", "max")
_AGG_RE = re.compile(
    r"^\s*(?P<agg>" + "|".join(_AGG_FNS) + r")\s*\(\s*(?P<arg>\*|\w+)\s*\)"
    r"(?:\s+as\s+(?P<alias>\w+))?\s*$",
    re.IGNORECASE,
)


# copied from tpudl/frame/sql.py:sql
def sql(query: str, tables: dict[str, Frame]) -> Frame:
    m = _SELECT_RE.match(query)
    if not m:
        raise ValueError(
            "unsupported SQL (only 'SELECT items FROM table [WHERE preds] "
            f"[GROUP BY cols] [ORDER BY cols] [LIMIT n]'): {query!r}")
    table = m.group("table")
    if table not in tables:
        raise KeyError(f"unknown table {table!r}; registered: {sorted(tables)}")
    frame = tables[table]
    if m.group("where"):
        frame = frame.filter_rows(_where_mask(frame, m.group("where")))

    items = [_parse_item(raw) for raw in _split_items(m.group("items"))]
    group_cols = ([c.strip() for c in m.group("group").split(",")]
                  if m.group("group") else None)
    has_agg = any(kind == "agg" for kind, *_ in items)
    limit = int(m.group("limit")) if m.group("limit") is not None else None
    if group_cols is not None or has_agg:
        out = _aggregate(frame, items, group_cols or [])
    else:
        if limit is not None and not m.group("order"):
            # LIMIT pushdown: without ORDER BY the first n rows ARE the
            # answer, so a limited featurize query must only run the
            # UDF over n rows (the 'dropped rows are never featurized'
            # contract extends to rows past the limit)
            frame = frame.limit(limit)
            limit = None
        out = _project(frame, items)

    if m.group("order"):
        out = out.take(_order_perm(out, m.group("order")))
    if limit is not None:
        out = out.limit(limit)
    return out


def _parse_item(raw: str):
    """→ ("star", None, None) | ("col", col, name) |
    ("udf", (fn, arg), name) | ("agg", (fn, arg), name)."""
    if raw == "*":
        return ("star", None, None)
    am = _AGG_RE.match(raw)
    if am:
        fn = am.group("agg").lower()
        fn = "avg" if fn == "mean" else fn
        arg = am.group("arg")
        if arg == "*" and fn != "count":
            raise ValueError(f"{fn.upper()}(*) is not SQL; name a column")
        name = am.group("alias") or f"{fn}({arg})"
        return ("agg", (fn, arg), name)
    im = _ITEM_RE.match(raw)
    if not im:
        raise ValueError(f"unsupported select item: {raw!r}")
    if im.group("col"):
        return ("col", im.group("col"),
                im.group("alias") or im.group("col"))
    fn, arg = im.group("fn"), im.group("arg")
    return ("udf", (fn, arg), im.group("alias") or f"{fn}({arg})")


def _project(frame: Frame, items) -> Frame:
    out: dict[str, object] = {}

    def put(name, value):
        if name in out:
            raise ValueError(f"duplicate output column {name!r}")
        out[name] = value

    for kind, spec, name in items:
        if kind == "star":
            for col in frame.columns:
                put(col, frame[col])
        elif kind == "col":
            put(name, _col(frame, spec))
        else:  # udf
            from tpudl_torch.udf import registry

            fn, arg = spec
            udf = registry.get_udf(fn)
            result = udf(frame.select(arg)
                         .with_column_renamed(arg, udf.input_col))
            put(name, result[udf.output_col])
    return Frame(out)


def _aggregate(frame: Frame, items, group_cols: list[str]) -> Frame:
    for kind, spec, name in items:
        if kind == "star":
            raise ValueError("SELECT * cannot be combined with aggregates")
        if kind == "udf":
            raise ValueError(
                f"UDF {spec[0]!r} inside an aggregate query is "
                "unsupported; featurize first, then aggregate")
        if kind == "col" and spec not in group_cols:
            raise ValueError(
                f"column {spec!r} must appear in GROUP BY or inside an "
                "aggregate")
    # group keys → row indices, first-appearance order; NULL/NaN keys
    # normalize to one sentinel so they form a single group
    if group_cols:
        key_cols = [_col(frame, g) for g in group_cols]
        nulls = [null_mask(c) for c in key_cols]
        groups: dict[tuple, list[int]] = {}
        for i in range(len(frame)):
            key = tuple(None if n[i] else _hashable(c[i])
                        for c, n in zip(key_cols, nulls))
            groups.setdefault(key, []).append(i)
    else:
        groups = {(): list(range(len(frame)))}

    out: dict[str, list] = {}
    for kind, spec, name in items:
        if name in out:
            raise ValueError(f"duplicate output column {name!r}")
        out[name] = []
    for key, rows in groups.items():
        for kind, spec, name in items:
            if kind == "col":
                out[name].append(key[group_cols.index(spec)])
            else:
                fn, arg = spec
                out[name].append(_agg_one(frame, fn, arg, rows))
    return Frame({n: np.asarray(v) if _all_numeric(v) else
                  np.asarray(v, dtype=object)
                  for n, v in out.items()})


def _hashable(v):
    return v.item() if isinstance(v, np.generic) else v


def _all_numeric(vals) -> bool:
    return all(isinstance(v, (int, float, np.number)) and v is not None
               for v in vals)


def _agg_one(frame: Frame, fn: str, arg: str, rows: list[int]):
    if fn == "count" and arg == "*":
        return len(rows)
    col = _col(frame, arg)
    sub = col[rows] if len(rows) else col[:0]
    valid = ~null_mask(sub)
    vals = sub[valid]
    if fn == "count":
        return int(valid.sum())
    if len(vals) == 0:
        return None  # SQL: aggregate over empty/all-NULL is NULL
    pyvals = [(v.item() if isinstance(v, np.generic) else v) for v in vals]
    if fn == "min":
        return min(pyvals)
    if fn == "max":
        return max(pyvals)
    total = sum(pyvals)  # raises TypeError on non-numeric — correct
    return total / len(pyvals) if fn == "avg" else total


_ORDER_RE = re.compile(
    r"^\s*(?P<col>\w+)(?:\s+(?P<dir>asc|desc))?\s*$", re.IGNORECASE)


def _order_perm(frame: Frame, order: str) -> np.ndarray:
    """Row permutation for ORDER BY over OUTPUT columns: stable
    multi-key sort, NULL/NaN rows last in both directions."""
    perm = np.arange(len(frame))
    for part in reversed(order.split(",")):  # stable: minor keys first
        om = _ORDER_RE.match(part)
        if not om:
            raise ValueError(f"unsupported ORDER BY term {part!r} "
                             "(use col [ASC|DESC])")
        col = _col(frame, om.group("col"))[perm]
        desc = (om.group("dir") or "asc").lower() == "desc"
        nulls = null_mask(col)
        if not np.issubdtype(col.dtype, np.number):
            # object AND plain-string ('<U') columns: python-level sort
            # (astype(float) on '<U' would raise, not sort)
            keyed = sorted(
                range(len(col)),
                key=lambda i: (nulls[i],
                               _neg_key(col[i], desc) if not nulls[i]
                               else 0))
            idx = np.asarray(keyed, dtype=int)
        else:
            vals = col.astype(float, copy=True)
            # two-key stable sort, null flag primary: real ±inf values
            # keep their order and NULL/NaN rows still land last (a
            # ±inf SENTINEL for nulls would interleave them with real
            # infinities)
            vals[nulls] = 0.0
            idx = np.lexsort((-vals if desc else vals, nulls))
        perm = perm[idx]
    return perm


class _Reversed:
    """Total-order inverter for python-object sort keys (DESC on object
    columns without assuming numeric negation works)."""

    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v

    def __lt__(self, other):
        return other.v < self.v


def _neg_key(v, desc: bool):
    return _Reversed(v) if desc else v


# split on AND only OUTSIDE single-quoted literals (even-quote lookahead)
_AND_SPLIT_RE = re.compile(
    r"\s+and\s+(?=(?:[^']*'[^']*')*[^']*$)", re.IGNORECASE)


def _where_mask(frame: Frame, where: str) -> np.ndarray:
    """AND-conjunction of simple predicates → boolean row mask.

    NULL semantics follow SQL three-valued logic for both column kinds:
    object ``None`` and float ``NaN`` rows fail EVERY comparison
    (including ``!=``) and are selected only by ``IS NULL``."""
    mask = np.ones(len(frame), dtype=bool)
    for pred in _AND_SPLIT_RE.split(where.strip()):
        nm = _NULL_RE.match(pred)
        if nm:
            isnull = null_mask(_col(frame, nm.group("col")))
            mask &= ~isnull if nm.group("neg") else isnull
            continue
        cm = _CMP_RE.match(pred)
        if not cm:
            raise ValueError(
                f"unsupported WHERE predicate {pred!r} (use col <op> "
                "literal or col IS [NOT] NULL)")
        col = _col(frame, cm.group("col"))
        lit_raw = cm.group("lit")
        lit = lit_raw[1:-1] if lit_raw.startswith("'") else float(lit_raw)
        op = cm.group("op")
        if col.dtype == object:
            # per-row compare: None and type-mismatched values (e.g.
            # 'text' < 5) both fail the predicate, like SQL NULL
            mask &= np.array([_row_cmp(v, op, lit) for v in col], dtype=bool)
        else:
            if isinstance(lit, str):
                # numpy would broadcast a scalar False here, silently
                # selecting nothing; name the predicate instead
                raise ValueError(
                    f"WHERE predicate {pred!r} compares numeric column "
                    f"{cm.group('col')!r} against string literal {lit_raw}")
            res = np.asarray(_cmp(col, op, lit), dtype=bool)
            if np.issubdtype(col.dtype, np.floating):
                res &= ~np.isnan(col)  # NaN fails != too, not just ==/<
            mask &= res
    return mask


def _col(frame: Frame, name: str) -> np.ndarray:
    if name not in frame:
        raise KeyError(f"unknown column {name!r}; have {frame.columns}")
    return frame[name]


def _row_cmp(v, op: str, lit) -> bool:
    if v is None:
        return False
    try:
        return bool(_cmp(v, op, lit))
    except TypeError:
        return False  # 'text' < 5 etc: fails the predicate, not the query


def _cmp(a, op: str, b):
    if op == "=":
        return a == b
    if op in ("!=", "<>"):
        return a != b
    if op == "<":
        return a < b
    if op == "<=":
        return a <= b
    if op == ">":
        return a > b
    return a >= b


def _split_items(items: str) -> list[str]:
    # split on top-level commas (no nested parens in our grammar)
    return [p for p in (s.strip() for s in items.split(",")) if p]
