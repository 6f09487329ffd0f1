"""Transformer base.

Port of ``tpudl/ml/pipeline.py`` (``Transformer.transform`` with its
per-class metrics: ``ml.<Class>.transform_seconds``, ``.transforms``,
``.rows_in``, ``.rows_out``). tpudl's ``_cached_jit`` has no counterpart:
PyTorch runs eagerly. Estimators and Pipeline come with the training
slice.
"""

from __future__ import annotations

from tpudl_torch.ml.params import Params
from tpudl_torch.obs import metrics as _obs_metrics

__all__ = ["Transformer"]


class Transformer(Params):
    def transform(self, frame, params: dict | None = None):
        """Apply the stage; ``params`` ({Param → value}) overrides apply to
        a copy, as in Spark ML."""
        cls = type(self).__name__
        with _obs_metrics.timed(f"ml.{cls}.transform_seconds"):
            if params:
                out = self.copy(params)._transform(frame)
            else:
                out = self._transform(frame)
        _obs_metrics.counter(f"ml.{cls}.transforms").inc()
        _obs_metrics.counter(f"ml.{cls}.rows_in").inc(len(frame))
        _obs_metrics.counter(f"ml.{cls}.rows_out").inc(len(out))
        return out

    def _transform(self, frame):  # pragma: no cover - abstract
        raise NotImplementedError
