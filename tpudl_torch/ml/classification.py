"""LogisticRegression — the downstream classifier of the flagship
transfer-learning pipeline ``Pipeline([DeepImageFeaturizer,
LogisticRegression])``.

Port of ``tpudl/ml/classification.py``: multinomial logistic regression
with Spark ML's param spellings (featuresCol, labelCol, predictionCol,
probabilityCol, maxIter, regParam as an L2 penalty, learningRate),
trained full-batch from zero weights for ``maxIter`` steps of optax's
adam, on ``device`` (default ``"cuda"``) in f32. The loss is the mean
softmax cross-entropy of integer labels plus ``regParam · Σ w²``; the
model keeps the losses of every step in ``history``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tpudl_torch.device import full_f32, resolve_device
from tpudl_torch.ml.params import (HasLabelCol, Param, TypeConverters,
                                   keyword_only)
from tpudl_torch.ml.pipeline import Estimator, Model
from tpudl_torch.train.optim import adam

__all__ = ["LogisticRegression", "LogisticRegressionModel"]

_DEFAULTS = dict(featuresCol="features", labelCol="label",
                 predictionCol="prediction", probabilityCol="probability",
                 maxIter=100, regParam=0.0, learningRate=0.1)


# copied from tpudl/ml/classification.py:_LRParams
class _LRParams(HasLabelCol):
    featuresCol = Param(None, "featuresCol", "feature-vector column",
                        TypeConverters.toString)
    predictionCol = Param(None, "predictionCol", "predicted class column",
                          TypeConverters.toString)
    probabilityCol = Param(None, "probabilityCol",
                           "class-probability column",
                           TypeConverters.toString)
    maxIter = Param(None, "maxIter", "training iterations",
                    TypeConverters.toInt)
    regParam = Param(None, "regParam", "L2 regularization strength",
                     TypeConverters.toFloat)
    learningRate = Param(None, "learningRate", "optimizer learning rate",
                         TypeConverters.toFloat)

    def setFeaturesCol(self, v):
        return self.set(self.featuresCol, v)

    def setPredictionCol(self, v):
        return self.set(self.predictionCol, v)


# copied from tpudl/ml/classification.py:_stack_features
def _stack_features(col) -> np.ndarray:
    if col.dtype == object:
        return np.stack([np.asarray(v, dtype=np.float32) for v in col])
    return np.asarray(col, dtype=np.float32)


class LogisticRegression(_LRParams, Estimator):
    @keyword_only
    def __init__(self, *, featuresCol="features", labelCol="label",
                 predictionCol="prediction", probabilityCol="probability",
                 maxIter=100, regParam=0.0, learningRate=0.1,
                 device="cuda"):
        super().__init__()
        self._setDefault(**_DEFAULTS)
        kwargs = dict(self._input_kwargs)
        self.device = kwargs.pop("device", device)
        self._set(**kwargs)

    def _fit(self, frame):
        X = _stack_features(frame[self.getOrDefault(self.featuresCol)])
        y = np.asarray(frame[self.getLabelCol()]).astype(np.int64)
        if len(X) == 0:
            raise ValueError("cannot fit on an empty frame (0 rows)")
        n_classes = int(y.max()) + 1
        dev = resolve_device(self.device)
        reg = self.getOrDefault(self.regParam)
        xb = torch.from_numpy(X).to(dev)
        yb = torch.from_numpy(y).to(dev)
        w = torch.zeros((X.shape[1], n_classes), device=dev,
                        requires_grad=True)
        b = torch.zeros((n_classes,), device=dev, requires_grad=True)
        opt = adam(self.getOrDefault(self.learningRate))([w, b])
        losses = []
        with torch.enable_grad(), full_f32():
            for _ in range(self.getOrDefault(self.maxIter)):
                opt.zero_grad(set_to_none=True)
                loss = (F.cross_entropy(xb @ w + b, yb)
                        + reg * torch.sum(torch.square(w)))
                loss.backward()
                opt.step()
                losses.append(loss.detach())
        model = LogisticRegressionModel(w.detach().cpu().numpy(),
                                        b.detach().cpu().numpy())
        model._paramMap = dict(self._paramMap)
        model._defaultParamMap = dict(self._defaultParamMap)
        model.history = torch.stack(losses).cpu().numpy()
        return model


class LogisticRegressionModel(_LRParams, Model):
    def __init__(self, w: np.ndarray, b: np.ndarray):
        super().__init__()
        self._setDefault(**_DEFAULTS)
        self.w = w
        self.b = b

    @property
    def numClasses(self) -> int:
        return self.b.shape[0]

    def _transform(self, frame):
        X = _stack_features(frame[self.getOrDefault(self.featuresCol)])
        logits = torch.from_numpy(X @ self.w + self.b)
        probs = torch.softmax(logits, dim=-1).numpy()
        pred = probs.argmax(axis=1).astype(np.int64)
        prob_col = np.empty(len(probs), dtype=object)
        prob_col[:] = list(probs)
        return (frame
                .with_column(self.getOrDefault(self.predictionCol), pred)
                .with_column(self.getOrDefault(self.probabilityCol),
                             prob_col))
