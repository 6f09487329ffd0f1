"""Typed Params — the stages' config layer.

Copied from ``tpudl/ml/params.py`` (``Param``, ``Params``,
``keyword_only``, ``HasInputCol``, ``HasOutputCol``: Spark ML's param-map
semantics with explicit and default maps). The ingest/Keras/loss
converters come with the stages that use them.
"""

from __future__ import annotations

import copy as _copy
import functools

__all__ = ["Param", "Params", "TypeConverters", "keyword_only",
           "HasInputCol", "HasOutputCol"]


class Param:
    """One typed parameter: name, doc, and a validating converter applied
    at set-time."""

    def __init__(self, parent, name, doc, typeConverter=None):
        self.parent = parent  # owning Params class name (set by metaclass)
        self.name = name
        self.doc = doc
        self.typeConverter = typeConverter or (lambda v: v)

    def __repr__(self):
        return f"Param({self.parent}.{self.name}: {self.doc})"

    def __hash__(self):
        return hash((self.parent, self.name))

    def __eq__(self, other):
        return (isinstance(other, Param)
                and (self.parent, self.name) == (other.parent, other.name))


class _ParamsMeta(type):
    """Stamp each class-level Param with its owner, so mixins compose."""

    def __new__(mcls, name, bases, ns):
        cls = super().__new__(mcls, name, bases, ns)
        for k, v in ns.items():
            if isinstance(v, Param):
                v.parent = name
                v.name = k
        return cls


class Params(metaclass=_ParamsMeta):
    """Base for everything with params: explicit values in ``_paramMap``,
    defaults in ``_defaultParamMap``."""

    def __init__(self):
        self._paramMap: dict[Param, object] = {}
        self._defaultParamMap: dict[Param, object] = {}

    @property
    def params(self) -> list[Param]:
        return sorted(
            (getattr(type(self), k) for k in dir(type(self))
             if isinstance(getattr(type(self), k, None), Param)),
            key=lambda p: p.name)

    def hasParam(self, name: str) -> bool:
        return isinstance(getattr(type(self), name, None), Param)

    def getParam(self, name: str) -> Param:
        p = getattr(type(self), name, None)
        if not isinstance(p, Param):
            raise AttributeError(
                f"{type(self).__name__} has no param {name!r}")
        return p

    def _resolve(self, param) -> Param:
        return self.getParam(param) if isinstance(param, str) else param

    def isSet(self, param) -> bool:
        return self._resolve(param) in self._paramMap

    def isDefined(self, param) -> bool:
        p = self._resolve(param)
        return p in self._paramMap or p in self._defaultParamMap

    def getOrDefault(self, param):
        p = self._resolve(param)
        if p in self._paramMap:
            return self._paramMap[p]
        if p in self._defaultParamMap:
            return self._defaultParamMap[p]
        raise KeyError(f"param {p.name!r} is neither set nor has a default")

    def set(self, param, value) -> "Params":
        p = self._resolve(param)
        self._paramMap[p] = p.typeConverter(value)
        return self

    def _set(self, **kwargs) -> "Params":
        for k, v in kwargs.items():
            if v is not None:
                self.set(self.getParam(k), v)
        return self

    def _setDefault(self, **kwargs) -> "Params":
        for k, v in kwargs.items():
            self._defaultParamMap[self.getParam(k)] = v
        return self

    def extractParamMap(self, extra: dict | None = None) -> dict:
        m = dict(self._defaultParamMap)
        m.update(self._paramMap)
        if extra:
            m.update(extra)
        return m

    def copy(self, extra: dict | None = None) -> "Params":
        """Shallow copy with ``extra`` {Param → value} merged in."""
        that = _copy.copy(self)
        that._paramMap = dict(self._paramMap)
        that._defaultParamMap = dict(self._defaultParamMap)
        if extra:
            for p, v in extra.items():
                p = that._resolve(p)
                that._paramMap[p] = p.typeConverter(v)
        return that

    def explainParams(self) -> str:
        lines = []
        for p in self.params:
            val = (f"current: {self._paramMap[p]!r}" if p in self._paramMap
                   else f"default: {self._defaultParamMap[p]!r}"
                   if p in self._defaultParamMap else "undefined")
            lines.append(f"{p.name}: {p.doc} ({val})")
        return "\n".join(lines)


def keyword_only(func):
    """Constructor decorator capturing kwargs into ``self._input_kwargs``."""

    @functools.wraps(func)
    def wrapper(self, *args, **kwargs):
        if args:
            raise TypeError(
                f"{func.__qualname__} accepts keyword arguments only")
        self._input_kwargs = kwargs
        return func(self, **kwargs)

    return wrapper


class TypeConverters:
    """Set-time validators."""

    @staticmethod
    def toString(v):
        if isinstance(v, str):
            return v
        raise TypeError(f"expected str, got {type(v).__name__}")


class HasInputCol(Params):
    inputCol = Param(None, "inputCol", "input column name",
                     TypeConverters.toString)

    def setInputCol(self, value):
        return self.set(self.inputCol, value)

    def getInputCol(self):
        return self.getOrDefault(self.inputCol)


class HasOutputCol(Params):
    outputCol = Param(None, "outputCol", "output column name",
                      TypeConverters.toString)

    def setOutputCol(self, value):
        return self.set(self.outputCol, value)

    def getOutputCol(self):
        return self.getOrDefault(self.outputCol)
