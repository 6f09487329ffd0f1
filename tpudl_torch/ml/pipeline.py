"""Transformer / Estimator / Pipeline bases.

Port of ``tpudl/ml/pipeline.py``: ``Transformer.transform`` with its
per-class metrics (``ml.<Class>.transform_seconds``, ``.transforms``,
``.rows_in``, ``.rows_out``), the executor knobs every batch stage plumbs
through (``_pipeline_opts``, ``_set_pipeline_opts``, the ``mesh`` among
them), ``_device_fn`` (one per-batch function a card of the mesh), and
``_cached_fn``,
the counterpart of tpudl's ``_cached_jit``: torch compiles nothing per
call, but the executor caches a fused CUDA graph on the per-batch
function, so a stage builds that function once per configuration.
``Estimator.fit`` (``ml.<Class>.fit_seconds``, ``.fits``; a list of param
maps fits each through ``fitMultiple``), ``Model``, ``Pipeline`` and
``PipelineModel`` are copied.
"""

from __future__ import annotations

from tpudl_torch.ml.params import Params
from tpudl_torch.obs import metrics as _obs_metrics
from tpudl_torch.obs import tracer as _obs_tracer

__all__ = ["Transformer", "Estimator", "Model", "Pipeline", "PipelineModel"]


class Transformer(Params):
    def transform(self, frame, params: dict | None = None):
        """Apply the stage; ``params`` ({Param → value}) overrides apply to
        a copy, as in Spark ML."""
        cls = type(self).__name__
        with _obs_metrics.timed(f"ml.{cls}.transform_seconds"), \
                _obs_tracer.span(f"ml.{cls}.transform", rows=len(frame)):
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

    def _home_device(self):
        """Where the stage loads its model: the mesh's first device under
        a mesh, else its ``device``."""
        mesh = getattr(self, "mesh", None)
        return mesh.device if mesh is not None else self.device

    def _device_fn(self, key, build):
        """The stage's per-batch function, cached as :meth:`_cached_fn`
        caches it: ``build(device)`` is the function on one device.
        Under a mesh one is built a distinct device of the mesh, each over
        that device's replica of the model, and they run as one
        :class:`~tpudl_torch.mesh.PerDevice` function (carrying their
        shared ``aot_token``), so the executor hands every card's shard to
        its own replica."""
        mesh = getattr(self, "mesh", None)
        if mesh is None:
            return self._cached_fn(key, lambda: build(self.device))
        from tpudl_torch.mesh import PerDevice

        def per_device():
            fns = {d: build(d) for d in mesh.distinct_devices()}
            out = PerDevice(fns)
            tokens = {getattr(f, "aot_token", None) for f in fns.values()}
            if len(tokens) == 1 and None not in tokens:
                # the program store's identity: the replicas' shared one
                out.aot_token = tokens.pop()
            return out

        return self._cached_fn(
            (*key, "mesh", tuple(map(str, mesh.devices))), per_device)

    # copied from tpudl/ml/pipeline.py:Transformer._pipeline_opts
    def _pipeline_opts(self) -> dict:
        """The ``Frame.map_batches`` executor knobs every batch stage
        plumbs through: the ``mesh`` (data-parallel over its cards),
        prefetch depth (K), prepare workers (N), fused dispatch steps (M),
        the dispatch window depth (D), plus the data layer's knobs — wire
        codec, shard-cache directory and device cache. None resolves
        inside map_batches from the ``TPUDL_FRAME_*``/
        ``TPUDL_WIRE_CODEC``/``TPUDL_DATA_*`` variables or their
        defaults, so a stage that never sets them still rides the
        pipeline."""
        return {
            "mesh": getattr(self, "mesh", None),
            "prefetch_depth": getattr(self, "prefetchDepth", None),
            "prepare_workers": getattr(self, "prepareWorkers", None),
            "fuse_steps": getattr(self, "fuseSteps", None),
            "dispatch_depth": getattr(self, "dispatchDepth", None),
            "wire_codec": getattr(self, "wireCodec", None),
            "cache_dir": getattr(self, "cacheDir", None),
            "device_cache": getattr(self, "deviceCache", None),
        }

    # copied from tpudl/ml/pipeline.py:Transformer._set_pipeline_opts
    def _set_pipeline_opts(self, kwargs: dict):
        """Pop the executor knobs (and the ``mesh``, which tpudl's stages
        pop beside them) out of an ``_input_kwargs`` dict and pin them as
        plain attributes (they parameterize the executor, not the
        model)."""
        self.mesh = kwargs.pop("mesh", None)
        self.prefetchDepth = kwargs.pop("prefetchDepth", None)
        self.prepareWorkers = kwargs.pop("prepareWorkers", None)
        self.fuseSteps = kwargs.pop("fuseSteps", None)
        self.dispatchDepth = kwargs.pop("dispatchDepth", None)
        self.wireCodec = kwargs.pop("wireCodec", None)
        self.cacheDir = kwargs.pop("cacheDir", None)
        self.deviceCache = kwargs.pop("deviceCache", None)


class Model(Transformer):
    """A fitted Transformer (keeps Spark's Estimator→Model naming)."""


# copied from tpudl/ml/pipeline.py:Estimator, without its tracer span
class Estimator(Params):
    def fit(self, frame, params=None):
        cls = type(self).__name__
        with _obs_metrics.timed(f"ml.{cls}.fit_seconds"), \
                _obs_tracer.span(f"ml.{cls}.fit", rows=len(frame)):
            if isinstance(params, (list, tuple)):
                models = [None] * len(params)
                for i, m in self.fitMultiple(frame, list(params)):
                    models[i] = m
                out = models
            elif params:
                out = self.copy(params)._fit(frame)
            else:
                out = self._fit(frame)
        _obs_metrics.counter(f"ml.{cls}.fits").inc()
        return out

    def fitMultiple(self, frame, paramMaps):
        """Iterator of (index, model) as each fit finishes: a sequential
        fit of ``self.copy(pm)`` for each map."""
        def gen():
            for i, pm in enumerate(paramMaps):
                yield i, self.copy(pm)._fit(frame)

        return gen()

    def _fit(self, frame):  # pragma: no cover - abstract
        raise NotImplementedError


# copied from tpudl/ml/pipeline.py:Pipeline
class Pipeline(Estimator):
    """Ordered stages of Transformers/Estimators."""

    def __init__(self, stages=None):
        super().__init__()
        self._stages = list(stages or [])

    def setStages(self, stages):
        self._stages = list(stages)
        return self

    def getStages(self):
        return list(self._stages)

    def _fit(self, frame):
        bad = [s for s in self._stages
               if not isinstance(s, (Transformer, Estimator))]
        if bad:
            raise TypeError(
                f"pipeline stage must be Transformer or Estimator, got "
                f"{type(bad[0]).__name__}")
        # stages after the last estimator need no fit-time data pass
        last_est = max((i for i, s in enumerate(self._stages)
                        if isinstance(s, Estimator)), default=-1)
        fitted = []
        cur = frame
        for i, stage in enumerate(self._stages):
            if isinstance(stage, Estimator):
                stage = stage.fit(cur)
            fitted.append(stage)
            if i < last_est:
                cur = stage.transform(cur)
        return PipelineModel(fitted)


# copied from tpudl/ml/pipeline.py:PipelineModel
class PipelineModel(Model):
    def __init__(self, stages):
        super().__init__()
        self._stages = list(stages)

    def getStages(self):
        return list(self._stages)

    def _transform(self, frame):
        for stage in self._stages:
            frame = stage.transform(frame)
        return frame
