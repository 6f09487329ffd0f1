"""Model selection: ParamGridBuilder + CrossValidator.

Copied from ``tpudl/ml/tuning.py`` (host-only) over the port's Params and
estimators: :class:`ParamGridBuilder` (``baseOn``/``addGrid``/``build``,
the cartesian grid), :class:`Evaluator` / :class:`FunctionEvaluator`
(any ``fn(frame) -> float``), and :class:`CrossValidator`, k-fold CV
whose folds come from ``np.random.default_rng(seed).permutation`` as
tpudl's, which evaluates each model as ``Estimator.fitMultiple`` yields it
(completion order) and refits the best map on all rows. Its metrics are
tpudl's (``tuning.cv_evaluations``, ``.cv_folds``, ``.cv_last_metric``,
``.cv_best_metric``); the per-fold tracer span is not ported yet (ROADMAP
Queue 1, 'The rest of observability').
"""

from __future__ import annotations

import itertools

import numpy as np

from tpudl_torch.ml.params import Param, Params, keyword_only
from tpudl_torch.ml.pipeline import Estimator, Model
from tpudl_torch.obs import metrics as _obs_metrics

__all__ = ["ParamGridBuilder", "CrossValidator", "CrossValidatorModel",
           "Evaluator", "FunctionEvaluator"]


# copied from tpudl/ml/tuning.py:ParamGridBuilder
class ParamGridBuilder:
    """Cartesian parameter grid (pyspark.ml.tuning.ParamGridBuilder API —
    the builder sparkdl's docs tell users to feed the estimator with)."""

    def __init__(self):
        self._param_grid: dict[Param, list] = {}

    def baseOn(self, *args, **kwargs):
        """Fix params across the whole grid. Accepts ``{param: value}``
        dicts / ``(param, value)`` pairs positionally."""
        if kwargs:
            raise TypeError(
                "baseOn takes {Param: value} dicts or (param, value) "
                "pairs, not keywords (Param objects are not identifiers)")
        for arg in args:
            if isinstance(arg, dict):
                for p, v in arg.items():
                    self.addGrid(p, [v])
            else:
                p, v = arg
                self.addGrid(p, [v])
        return self

    def addGrid(self, param: Param, values) -> "ParamGridBuilder":
        if not isinstance(param, Param):
            raise TypeError(f"addGrid needs a Param, got {type(param).__name__}")
        values = list(values)
        if not values:
            raise ValueError(f"empty value list for param {param.name!r}")
        self._param_grid[param] = values
        return self

    def build(self) -> list[dict]:
        keys = list(self._param_grid)
        if not keys:
            return [{}]
        grids = []
        for combo in itertools.product(*(self._param_grid[k] for k in keys)):
            grids.append(dict(zip(keys, combo)))
        return grids


# copied from tpudl/ml/tuning.py:Evaluator
class Evaluator(Params):
    """Scores a transformed frame. ``isLargerBetter`` orients selection
    (accuracy-style → True, loss-style → False), mirroring
    pyspark.ml.evaluation.Evaluator."""

    def evaluate(self, frame) -> float:  # pragma: no cover - abstract
        raise NotImplementedError

    def isLargerBetter(self) -> bool:
        return True


# copied from tpudl/ml/tuning.py:FunctionEvaluator
class FunctionEvaluator(Evaluator):
    """Adapter: any ``fn(frame) -> float`` as an Evaluator."""

    def __init__(self, fn, larger_is_better: bool = True):
        super().__init__()
        self._fn = fn
        self._larger = bool(larger_is_better)

    def evaluate(self, frame) -> float:
        return float(self._fn(frame))

    def isLargerBetter(self) -> bool:
        return self._larger


# copied from tpudl/ml/tuning.py:CrossValidator
class CrossValidator(Estimator):
    """k-fold cross-validation over an estimator's param grid
    (pyspark.ml.tuning.CrossValidator semantics).

    For each fold, every paramMap is trained via the estimator's
    ``fitMultiple`` — consumed AS TRIALS COMPLETE, so evaluation of
    early-finishing models overlaps the training of slow ones (and, for
    KerasImageFileEstimator on several cards, the trials themselves run
    concurrently, one a card). Metrics are averaged across folds;
    the best paramMap is refit on the FULL dataset for the returned
    model, exactly as Spark does.
    """

    estimator = Param(None, "estimator", "estimator to cross-validate")
    estimatorParamMaps = Param(None, "estimatorParamMaps",
                               "list of {Param: value} grids")
    evaluator = Param(None, "evaluator", "metric evaluator")
    numFolds = Param(None, "numFolds", "number of folds (>= 2)",
                     typeConverter=int)
    seed = Param(None, "seed", "fold-assignment rng seed",
                 typeConverter=int)

    @keyword_only
    def __init__(self, *, estimator=None, estimatorParamMaps=None,
                 evaluator=None, numFolds=3, seed=0):
        super().__init__()
        self._setDefault(numFolds=3, seed=0)
        self._set(**self._input_kwargs)

    def _folds(self, n: int):
        k = self.getOrDefault(self.numFolds)
        if k < 2:
            raise ValueError(f"numFolds must be >= 2, got {k}")
        if n < k:
            raise ValueError(f"{n} rows cannot be split into {k} folds")
        rng = np.random.default_rng(self.getOrDefault(self.seed))
        perm = rng.permutation(n)
        return [np.sort(part) for part in np.array_split(perm, k)]

    def _fit(self, frame):
        est = self.getOrDefault(self.estimator)
        maps = list(self.getOrDefault(self.estimatorParamMaps))
        ev = self.getOrDefault(self.evaluator)
        if est is None or ev is None or not maps:
            raise ValueError(
                "CrossValidator needs estimator, estimatorParamMaps and "
                "evaluator")
        n = len(frame)
        folds = self._folds(n)
        metrics = np.zeros((len(maps), len(folds)), dtype=np.float64)
        for f, val_idx in enumerate(folds):
            val_mask = np.zeros(n, dtype=bool)
            val_mask[val_idx] = True
            train = frame.filter_rows(~val_mask)
            val = frame.filter_rows(val_mask)
            # completion-order consumption: evaluate each model the
            # moment its trial finishes
            for i, model in est.fitMultiple(train, maps):
                metrics[i, f] = ev.evaluate(model.transform(val))
                _obs_metrics.counter("tuning.cv_evaluations").inc()
                _obs_metrics.gauge("tuning.cv_last_metric").set(
                    metrics[i, f])
        _obs_metrics.counter("tuning.cv_folds").inc(len(folds))
        avg = metrics.mean(axis=1)
        best = int(np.argmax(avg) if ev.isLargerBetter()
                   else np.argmin(avg))
        _obs_metrics.gauge("tuning.cv_best_metric").set(avg[best])
        best_model = est.fit(frame, maps[best])  # refit on ALL rows
        return CrossValidatorModel(best_model, avg.tolist(), best)


# copied from tpudl/ml/tuning.py:CrossValidatorModel
class CrossValidatorModel(Model):
    """The winning model + the per-paramMap average metrics."""

    def __init__(self, bestModel, avgMetrics, bestIndex):
        super().__init__()
        self.bestModel = bestModel
        self.avgMetrics = list(avgMetrics)
        self.bestIndex = int(bestIndex)

    def _transform(self, frame):
        return self.bestModel.transform(frame)
