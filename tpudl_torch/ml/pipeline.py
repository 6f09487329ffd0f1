"""Transformer base.

Port of ``tpudl/ml/pipeline.py``: ``Transformer.transform`` with its
per-class metrics (``ml.<Class>.transform_seconds``, ``.transforms``,
``.rows_in``, ``.rows_out``), the executor knobs every batch stage plumbs
through (``_pipeline_opts``, ``_set_pipeline_opts``), and ``_cached_fn``,
the counterpart of tpudl's ``_cached_jit``: torch compiles nothing per
call, but the executor caches a fused CUDA graph on the per-batch
function, so a stage builds that function once per configuration.
Estimators and Pipeline come with the training slice.
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

    def _cached_fn(self, key, build):
        """``build()`` once per ``key`` and reuse it across ``transform``
        calls. The key covers everything the function closes over, the
        loaded model first; a rebuilt function would lose the CUDA graphs
        the executor cached on it. One function is kept per stage, so a
        new key (a reloaded model) drops the old function, and with it
        the old model and its graphs."""
        entry = getattr(self, "_fn_entry", None)
        if entry is not None and entry[0] == key:
            return entry[1]
        self._fn_entry = None  # the old fn goes before the new one is built
        fn = build()
        self._fn_entry = (key, fn)
        return fn

    # copied from tpudl/ml/pipeline.py:Transformer._pipeline_opts
    def _pipeline_opts(self) -> dict:
        """The ``Frame.map_batches`` executor knobs every batch stage
        plumbs through: prefetch depth (K), prepare workers (N), fused
        dispatch steps (M), the dispatch window depth (D) and the wire
        codec (tpudl's mesh and cache knobs are refused by the stages'
        constructors, so they never reach here). None resolves inside map_batches from the
        ``TPUDL_FRAME_*`` variables or their defaults, so a stage that
        never sets them still rides the pipeline."""
        return {
            "prefetch_depth": getattr(self, "prefetchDepth", None),
            "prepare_workers": getattr(self, "prepareWorkers", None),
            "fuse_steps": getattr(self, "fuseSteps", None),
            "dispatch_depth": getattr(self, "dispatchDepth", None),
            "wire_codec": getattr(self, "wireCodec", None),
        }

    # copied from tpudl/ml/pipeline.py:Transformer._set_pipeline_opts
    def _set_pipeline_opts(self, kwargs: dict):
        """Pop the executor knobs out of an ``_input_kwargs`` dict and pin
        them as plain attributes (they parameterize the executor, not the
        model)."""
        self.prefetchDepth = kwargs.pop("prefetchDepth", None)
        self.prepareWorkers = kwargs.pop("prepareWorkers", None)
        self.fuseSteps = kwargs.pop("fuseSteps", None)
        self.dispatchDepth = kwargs.pop("dispatchDepth", None)
        self.wireCodec = kwargs.pop("wireCodec", None)
