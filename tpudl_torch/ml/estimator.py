"""KerasImageFileEstimator — fine-tune a Keras model file (``.keras`` or a
legacy ``.h5``) over image files.

Port of ``tpudl/ml/estimator.py`` (``KerasImageFileEstimator``: ``fit``,
``_validateFitParams``, ``_getNumpyFeaturesAndLabels``, ``_ingest``,
``_train_one``, ``_save_trained``) on torch. ``fit`` loads the images
once (``imageLoader``), ingests the file once
(``TFInputGraph.fromKerasTrainable``), runs one train step a batch on
``device`` (default ``"cuda"``) in f32 (``device.full_f32``), writes the
trained weights to a new ``.keras`` file (whatever it read, as tpudl's
``_save_trained`` does) with
:func:`~tpudl_torch.ingest.kerasfile.save_keras_file` and returns a
:class:`~tpudl_torch.ml.keras_image.KerasImageFileTransformer` over it.

The step is tpudl's: the loss (``kerasLoss``) of the model's inference
call, so BatchNormalization normalizes with its moving statistics and
Dropout is off, differentiated in every variable of the file, the moving
statistics included, and an optimizer (``kerasOptimizer``) with optax's
update and defaults (:mod:`tpudl_torch.ml.losses`). The batch order is
tpudl's too: ``np.random.default_rng(seed)`` draws a permutation an epoch
(``shuffle``), batches are ``batch_size`` rows, and the ragged tail wraps
around to the epoch's first rows. An epoch's loss is the mean of its
batches'. The returned transformer carries ``history``:
``{"epoch_loss": [...], "step_loss": [...]}``.

``kerasFitParams`` keys: ``batch_size``, ``epochs``, ``verbose``,
``shuffle``, ``learning_rate``, ``seed``.

``fitMultiple`` (and ``fit`` over a list of param maps) is tpudl's: one
shared ``(X, y)`` and one ingested graph for every map that tunes only
training knobs, the trials scheduled by
:class:`~tpudl_torch.ml.hpo.TrialScheduler` (one in flight a card,
yielded in completion order, each re-attempted under
``trialRetryPolicy`` when its failure is transient), and a private
``_fit`` for a map that overrides ``modelFile``, ``inputCol``,
``labelCol`` or ``imageLoader`` (compared by value). Refused by name:
``mesh`` and with it mesh-wide trials ('Training, rest'), ``modelAxis``
and ``paramShardings`` ('LM parallelism'), ``wireCodec``, ``cacheDir``
and ``deviceCache`` ('Data layer').
"""

from __future__ import annotations

import math
import os
import tempfile

import numpy as np
import torch

from tpudl_torch.device import full_f32, resolve_device
from tpudl_torch.ml.image_params import CanLoadImage
from tpudl_torch.ml.keras_image import KerasImageFileTransformer
from tpudl_torch.ml.losses import (get_loss, get_optimizer_dynamic,
                                   set_learning_rate)
from tpudl_torch.ml.params import (HasInputCol, HasKerasLoss, HasKerasModel,
                                   HasKerasOptimizer, HasLabelCol,
                                   HasOutputCol, keyword_only,
                                   refuse_unported)
from tpudl_torch.ml.pipeline import Estimator
from tpudl_torch.obs import metrics as _obs_metrics

__all__ = ["KerasImageFileEstimator"]

_ALLOWED_FIT_PARAMS = {"batch_size", "epochs", "verbose", "shuffle",
                       "learning_rate", "seed"}

_UNPORTED = {"mesh": "Training, rest", "modelAxis": "LM parallelism",
             "paramShardings": "LM parallelism", "wireCodec": "Data layer",
             "cacheDir": "Data layer", "deviceCache": "Data layer"}


class KerasImageFileEstimator(Estimator, HasInputCol, HasOutputCol,
                              HasLabelCol, HasKerasModel, HasKerasOptimizer,
                              HasKerasLoss, CanLoadImage):
    @keyword_only
    def __init__(self, *, inputCol=None, outputCol=None, labelCol=None,
                 imageLoader=None, modelFile=None, kerasOptimizer=None,
                 kerasLoss=None, kerasFitParams=None, device="cuda",
                 mesh=None, prefetchDepth=None, prepareWorkers=None,
                 fuseSteps=None, dispatchDepth=None, wireCodec=None,
                 cacheDir=None, deviceCache=None, trialRetryPolicy=None,
                 modelAxis=None, paramShardings=None):
        super().__init__()
        self._setDefault(kerasFitParams={"batch_size": 32, "epochs": 1,
                                         "verbose": 0})
        kwargs = dict(self._input_kwargs)
        refuse_unported(type(self).__name__, kwargs, _UNPORTED)
        self.device = kwargs.pop("device", device)
        # executor knobs, handed to the transformer that fit returns
        self.prefetchDepth = kwargs.pop("prefetchDepth", None)
        self.prepareWorkers = kwargs.pop("prepareWorkers", None)
        self.fuseSteps = kwargs.pop("fuseSteps", None)
        self.dispatchDepth = kwargs.pop("dispatchDepth", None)
        # per-trial retry (a RetryPolicy) for fitMultiple's scheduler;
        # None falls back to TPUDL_HPO_TRIAL_ATTEMPTS
        self.trialRetryPolicy = kwargs.pop("trialRetryPolicy", None)
        self._set(**kwargs)

    # copied from tpudl/ml/estimator.py:_validateFitParams
    def _validateFitParams(self, fit_params: dict):
        unknown = set(fit_params) - _ALLOWED_FIT_PARAMS
        if unknown:
            raise ValueError(
                f"unsupported kerasFitParams keys {sorted(unknown)}; "
                f"allowed: {sorted(_ALLOWED_FIT_PARAMS)}")
        return fit_params

    # copied from tpudl/ml/estimator.py:_getNumpyFeaturesAndLabels
    def _getNumpyFeaturesAndLabels(self, frame):
        if len(frame) == 0:
            raise ValueError("cannot fit on an empty frame (0 rows)")
        X = self.loadImagesInternal(frame, self.getInputCol())
        y_col = frame[self.getLabelCol()]
        if y_col.dtype == object:
            y = np.stack([np.asarray(v, dtype=np.float32) for v in y_col])
        else:
            y = np.asarray(y_col, dtype=np.float32)
        if len(y) != len(X):
            raise ValueError(f"{len(X)} images but {len(y)} labels")
        return X, y

    def _ingest(self):
        from tpudl_torch.ingest import TFInputGraph

        return TFInputGraph.fromKerasTrainable(self.getModelFile())

    def _train_one(self, gin, X, y, device=None):
        """Train on ``(X, y)`` from ``gin.params`` on ``device`` (default
        the estimator's): ``(params, epoch losses, step losses)``,
        ``params`` as torch tensors on that device in Keras's layout."""
        fit_params = self._validateFitParams(self.getKerasFitParams())
        batch_size = int(fit_params.get("batch_size", 32))
        epochs = int(fit_params.get("epochs", 1))
        shuffle = bool(fit_params.get("shuffle", True))
        seed = int(fit_params.get("seed", 0))
        lr = fit_params.get("learning_rate")
        n = len(X)
        if n == 0:
            raise ValueError("cannot fit on an empty frame (0 images)")
        dev = resolve_device(self.device if device is None else device)
        loss_fn = get_loss(self.getKerasLoss())
        factory, default_lr = get_optimizer_dynamic(self.getKerasOptimizer())
        # every floating variable trains, as tpudl's step differentiates
        # them all (BN's moving statistics too); an integer one (a
        # Normalization's count) rides along
        params = {k: torch.tensor(np.asarray(v), device=dev,
                                  requires_grad=np.asarray(v).dtype.kind
                                  == "f")
                  for k, v in gin.params.items()}
        opt = factory([t for t in params.values() if t.requires_grad])
        set_learning_rate(opt, lr if lr is not None else default_lr)
        apply_fn = gin.make_fn()

        rng = np.random.default_rng(seed)
        epoch_losses, step_losses = [], []
        with torch.enable_grad(), full_f32():
            for _epoch in range(epochs):
                order = rng.permutation(n) if shuffle else np.arange(n)
                batch_losses = []     # on the device; one fetch an epoch
                for start in range(0, n, batch_size):
                    idx = order[start:start + batch_size]
                    if len(idx) < batch_size:   # the ragged tail wraps
                        reps = math.ceil((batch_size - len(idx)) / n)
                        fill = np.concatenate(
                            [order] * reps)[: batch_size - len(idx)]
                        idx = np.concatenate([idx, fill])
                    xb = torch.from_numpy(X[idx]).to(dev, non_blocking=True)
                    yb = torch.from_numpy(y[idx]).to(dev, non_blocking=True)
                    opt.zero_grad(set_to_none=True)
                    pred = apply_fn(params, xb)
                    loss = loss_fn(pred, yb)
                    loss.backward()
                    opt.step()
                    batch_losses.append(loss.detach())
                losses = torch.stack(batch_losses).cpu()
                step_losses += losses.tolist()
                epoch_losses.append(float(losses.mean()))
        _obs_metrics.counter("estimator.trials").inc()
        _obs_metrics.counter("estimator.train_steps").inc(len(step_losses))
        if epoch_losses:
            _obs_metrics.gauge("estimator.trial_final_loss").set(
                epoch_losses[-1])
        return params, epoch_losses, step_losses

    def _save_trained(self, gin, params):
        """Write the trained params to a new ``.keras`` file (the ingested
        file's config; a ``.h5`` file's too), so the returned transformer
        reads a standard artifact."""
        from tpudl_torch.ingest.kerasfile import save_keras_file

        weights = {k: t.detach().cpu().numpy() for k, t in params.items()}
        fd, path = tempfile.mkstemp(suffix=".keras", prefix="tpudl_trained_")
        os.close(fd)
        return save_keras_file(path, gin.config, weights, gin.layout)

    def _make_transformer(self, model_path, device=None):
        return KerasImageFileTransformer(
            inputCol=self.getInputCol(), outputCol=self.getOutputCol(),
            modelFile=model_path, imageLoader=self.getImageLoader(),
            device=self.device if device is None else device,
            prefetchDepth=self.prefetchDepth,
            prepareWorkers=self.prepareWorkers, fuseSteps=self.fuseSteps,
            dispatchDepth=self.dispatchDepth)

    def _trained_model(self, gin, X, y, device=None):
        """Train, write the trained file and return its transformer, with
        the losses as its ``history``."""
        params, epoch_losses, step_losses = self._train_one(gin, X, y, device)
        model = self._make_transformer(self._save_trained(gin, params),
                                       device)
        model.history = {"epoch_loss": epoch_losses,
                         "step_loss": step_losses}
        return model

    def _fit(self, frame, device=None):
        X, y = self._getNumpyFeaturesAndLabels(frame)
        return self._trained_model(self._ingest(), X, y, device)

    # copied from tpudl/ml/estimator.py:_overrides_shared
    def _overrides_shared(self, conf):
        """Does ``conf`` override a data/model param vs self? Compared by
        VALUE (an equal-valued override must not force the expensive
        private path); identity is the fallback for un-comparable values
        (e.g. loader callables)."""
        for p in (self.modelFile, self.inputCol, self.labelCol,
                  self.imageLoader):
            if p not in conf._paramMap:
                continue
            new = conf._paramMap[p]
            old = self.getOrDefault(p) if self.isDefined(p) else None
            try:
                if not bool(new == old):
                    return True
            except Exception:
                if new is not old:
                    return True
        return False

    def fitMultiple(self, frame, paramMaps):
        """Iterator of ``(index, model)`` as each trial finishes: one
        shared dataset and one ingested graph for the maps that tune
        training knobs, a private ``_fit`` for a map that overrides the
        data or the model file. Trials run one a card (on the CPU, one
        at a time)."""
        from tpudl_torch.ml.hpo import TrialScheduler

        paramMaps = list(paramMaps)

        def gen():
            confs = [self.copy(pm) for pm in paramMaps]
            private = {i for i, c in enumerate(confs)
                       if self._overrides_shared(c)}
            X = y = gin = None
            if len(private) < len(confs):
                X, y = self._getNumpyFeaturesAndLabels(frame)
                gin = self._ingest()
            sched = TrialScheduler(device=self.device)

            def trial(i, _pm, slice_devs):
                # a wider slice trains on its first card (mesh-wide
                # trials wait for mesh=, 'Training, rest')
                if i in private:
                    return confs[i]._fit(frame, slice_devs[0])
                return confs[i]._trained_model(gin, X, y, slice_devs[0])

            yield from sched.run(paramMaps, trial,
                                 retry=self.trialRetryPolicy)

        return gen()
