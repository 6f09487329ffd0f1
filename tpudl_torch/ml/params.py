"""Typed Params — the stages' config layer.

Copied from ``tpudl/ml/params.py`` (``Param``, ``Params``,
``keyword_only``, the shared mixins ``HasInputCol``, ``HasOutputCol``,
``HasLabelCol``, ``HasOutputMode``, ``HasKerasModel``,
``HasKerasOptimizer``, ``HasKerasLoss``: Spark ML's param-map semantics
with explicit and default maps) and its converters, the ingest ones over
the port's :class:`~tpudl_torch.ingest.TFInputGraph` and the Keras ones
over :mod:`tpudl_torch.ml.losses`. :func:`refuse_unported` is the port's
own: the stages' shared refusal of tpudl's knobs that have no counterpart
yet (:data:`EXECUTOR_KNOBS`, empty now that ``mesh`` is ported; the LM
stages refuse ``tp`` through it).
"""

from __future__ import annotations

import copy as _copy
import functools

__all__ = ["Param", "Params", "TypeConverters", "keyword_only",
           "HasInputCol", "HasOutputCol", "HasLabelCol", "HasOutputMode",
           "HasKerasModel", "HasKerasOptimizer", "HasKerasLoss",
           "EXECUTOR_KNOBS", "refuse_unported"]

# tpudl's executor knobs of every stage with no counterpart in the port
# yet → the ROADMAP Queue 1 item that brings them (none left)
EXECUTOR_KNOBS: dict = {}


def refuse_unported(stage: str, kwargs: dict, table: dict):
    """Pop every knob of ``table`` from a stage's constructor ``kwargs``:
    a knob that is set raises ``NotImplementedError`` naming its ROADMAP
    Queue 1 item."""
    for k, item in table.items():
        if kwargs.pop(k, None) not in (None, False):
            raise NotImplementedError(
                f"{stage}({k}=...) is not ported to tpudl_torch yet "
                f"(ROADMAP Queue 1, {item!r})")


# copied from tpudl/ingest/graphdef.py:tensor_name
def _tensor_name(name: str) -> str:
    """Canonicalize ``"x"`` → ``"x:0"`` (graph-output tensor form)."""
    name = name.lstrip("^")
    return name if ":" in name else name + ":0"


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

    @staticmethod
    def toInt(v):
        if isinstance(v, bool) or not isinstance(v, int):
            raise TypeError(f"expected int, got {type(v).__name__}")
        return int(v)

    @staticmethod
    def toFloat(v):
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            raise TypeError(f"expected float, got {type(v).__name__}")
        return float(v)

    @staticmethod
    def toBoolean(v):
        if not isinstance(v, bool):
            raise TypeError(f"expected bool, got {type(v).__name__}")
        return v

    @staticmethod
    def toTFInputGraph(v):
        from tpudl_torch.ingest import TFInputGraph

        if isinstance(v, TFInputGraph):
            return v
        raise TypeError(
            f"expected TFInputGraph, got {type(v).__name__} (build one via "
            "TFInputGraph.fromKeras)")

    @staticmethod
    def toOutputMode(v):
        if v in ("vector", "image"):
            return v
        raise TypeError(f"outputMode must be 'vector' or 'image', got {v!r}")

    # copied from tpudl/ml/params.py:TypeConverters.toChannelOrder
    @staticmethod
    def toChannelOrder(v):
        if v in ("RGB", "BGR", "L"):
            return v
        raise TypeError(f"channelOrder must be RGB, BGR or L; got {v!r}")

    @staticmethod
    def asColumnToTensorNameMap(v):
        """{column → tensor name}, canonicalized and sorted."""
        if not isinstance(v, dict):
            raise TypeError(f"expected dict col→tensor, got {type(v).__name__}")
        out = {}
        for col, tname in v.items():
            if not isinstance(col, str) or not isinstance(tname, str):
                raise TypeError(f"mapping entries must be str→str, got "
                                f"{col!r}→{tname!r}")
            out[col] = _tensor_name(tname)
        return dict(sorted(out.items()))

    @staticmethod
    def asTensorNameToColumnMap(v):
        if not isinstance(v, dict):
            raise TypeError(f"expected dict tensor→col, got {type(v).__name__}")
        out = {}
        for tname, col in v.items():
            if not isinstance(col, str) or not isinstance(tname, str):
                raise TypeError(f"mapping entries must be str→str, got "
                                f"{tname!r}→{col!r}")
            out[_tensor_name(tname)] = col
        return dict(sorted(out.items()))

    @staticmethod
    def toKerasLoss(v):
        from tpudl_torch.ml.losses import LOSSES

        if v in LOSSES:
            return v
        raise TypeError(
            f"named loss {v!r} unsupported; one of {sorted(LOSSES)}")

    @staticmethod
    def toKerasOptimizer(v):
        from tpudl_torch.ml.losses import OPTIMIZERS

        if v in OPTIMIZERS:
            return v
        raise TypeError(
            f"named optimizer {v!r} unsupported; one of {sorted(OPTIMIZERS)}")

    @staticmethod
    def supportedNameConverter(supported):
        """The value must be one of ``supported``'s names (a registry)."""

        def convert(v):
            if v in supported:
                return v
            raise TypeError(
                f"model name {v!r} unsupported; one of {sorted(supported)}")

        return convert


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


class HasLabelCol(Params):
    labelCol = Param(None, "labelCol", "label column name",
                     TypeConverters.toString)

    def setLabelCol(self, value):
        return self.set(self.labelCol, value)

    def getLabelCol(self):
        return self.getOrDefault(self.labelCol)


class HasOutputMode(Params):
    outputMode = Param(None, "outputMode",
                       "output form: 'vector' (flattened) or 'image' (struct)",
                       TypeConverters.toOutputMode)

    def setOutputMode(self, value):
        return self.set(self.outputMode, value)

    def getOutputMode(self):
        return self.getOrDefault(self.outputMode)


class HasKerasModel(Params):
    """modelFile (a ``.keras`` or ``.h5`` path) + kerasFitParams (the fit's
    keywords)."""

    modelFile = Param(None, "modelFile",
                      "path to a Keras model file (.keras / .h5)",
                      TypeConverters.toString)
    kerasFitParams = Param(None, "kerasFitParams",
                           "dict of fit kwargs (batch_size, epochs, verbose)")

    def setModelFile(self, value):
        return self.set(self.modelFile, value)

    def getModelFile(self):
        return self.getOrDefault(self.modelFile)

    def setKerasFitParams(self, value):
        return self.set(self.kerasFitParams, dict(value))

    def getKerasFitParams(self):
        return dict(self.getOrDefault(self.kerasFitParams))


class HasKerasOptimizer(Params):
    kerasOptimizer = Param(None, "kerasOptimizer",
                           "named optimizer (keras spelling, optax semantics)",
                           TypeConverters.toKerasOptimizer)

    def setKerasOptimizer(self, value):
        return self.set(self.kerasOptimizer, value)

    def getKerasOptimizer(self):
        return self.getOrDefault(self.kerasOptimizer)


class HasKerasLoss(Params):
    kerasLoss = Param(None, "kerasLoss", "named loss (keras spelling)",
                      TypeConverters.toKerasLoss)

    def setKerasLoss(self, value):
        return self.set(self.kerasLoss, value)

    def getKerasLoss(self):
        return self.getOrDefault(self.kerasLoss)
