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
:class:`~tpudl_torch.ml.hpo.TrialScheduler` over the mesh's cards (or
every visible card; one trial in flight a slice, yielded in completion
order, each re-attempted under ``trialRetryPolicy`` when its failure is
transient), and a private ``_fit`` for a map that overrides
``modelFile``, ``inputCol``, ``labelCol`` or ``imageLoader`` (compared by
value).

Data-parallel training, as tpudl's sub-mesh trials: ``fit`` on an
estimator with a ``mesh`` (a local :class:`~tpudl_torch.mesh.Mesh`)
trains over the whole mesh, and a trial slice of several cards trains
over its slice. The batch rounds up to a multiple of the slice's width
and batches stride by it (fresh rows, as tpudl draws them); each card
holds a replica of the variables and runs the step on its contiguous
shard; the gradients, each weighted by its shard's share of the rows,
are summed onto the first card (:func:`tpudl_torch.mesh.reduce_add`),
one optimizer step runs there, and the new variables are copied back to
the other cards (:func:`tpudl_torch.mesh.broadcast`). BatchNormalization
normalizes with its moving statistics in this step (the inference call,
as tpudl's), so a replica's shard computes exactly what its rows
contribute to tpudl's global SPMD step, and no cross-card statistics
are needed.

The data layer, as in tpudl: ``cacheDir`` (default
``TPUDL_DATA_CACHE_DIR``) shards the bulk image load, so a re-fit over
the same files decodes nothing; a loader with ``output_dtype='uint8'``
ships uint8 batches and the u8 codec's prologue (``_train_codec``)
restores them inside the step; ``deviceCache`` (default
``TPUDL_DATA_DEVICE_CACHE``) puts the whole ``(X, y)`` on the trial's card
once (``bulk_resident``), and every step gathers its batch there — the
pin is released when the trial ends, failed or not, and trials over the
same data share the entry. The three knobs pass into the returned
transformer, as does the ``mesh``. The bulk residency stays on one card,
as in tpudl: a data-parallel trial ships its shards every step. Refused
by name: ``modelAxis`` and ``paramShardings`` ('LM parallelism').
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
from tpudl_torch.obs import attribution as _attr
from tpudl_torch.obs import metrics as _obs_metrics
from tpudl_torch.obs import tracer as _obs_tracer
from tpudl_torch.obs import watchdog as _obs_watchdog

__all__ = ["KerasImageFileEstimator", "sharded_backward"]

_ALLOWED_FIT_PARAMS = {"batch_size", "epochs", "verbose", "shuffle",
                       "learning_rate", "seed"}

_UNPORTED = {"modelAxis": "LM parallelism",
             "paramShardings": "LM parallelism"}


def sharded_backward(apply_fn, loss_fn, replicas, shards, devices,
                     codec=None) -> tuple[dict, torch.Tensor]:
    """The backward of one data-parallel step: entry ``i`` of the mesh
    runs ``loss_fn(apply_fn(replicas[i], x_i), y_i)`` on its shard
    ``shards[i] = (x_i, y_i)`` (restored by ``codec`` first), weighted by
    the shard's share of the batch's rows, and backpropagates it into its
    replica; the gradients of every variable that requires one are then
    summed onto the first entry (:func:`tpudl_torch.mesh.reduce_add`).
    Returns ``({name: gradient on devices[0]}, the batch's mean loss on
    devices[0])``: what one device computes on the whole batch, in
    another order of sums."""
    from tpudl_torch import mesh as M

    rows = sum(int(x.shape[0]) for x, _ in shards)
    first = torch.device(devices[0])
    losses = []
    for dev, rep, (xs, ys) in zip(devices, replicas, shards):
        with M.on_device(dev):
            for t in rep.values():
                t.grad = None
            if codec is not None:
                xs = codec.prologue(xs)
            loss = loss_fn(apply_fn(rep, xs), ys) * (xs.shape[0] / rows)
            loss.backward()
            losses.append(loss.detach().to(first))
    names = [k for k, t in replicas[0].items() if t.requires_grad]
    grads = M.reduce_add([[rep[k].grad for k in names] for rep in replicas],
                         devices)
    return dict(zip(names, grads)), torch.stack(losses).sum()


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
        # the data-parallel mesh: fit trains over it, fitMultiple carves
        # its cards into trial slices, and the returned transformer runs
        # over it
        self.mesh = kwargs.pop("mesh", None)
        # executor knobs, handed to the transformer that fit returns
        self.prefetchDepth = kwargs.pop("prefetchDepth", None)
        self.prepareWorkers = kwargs.pop("prepareWorkers", None)
        self.fuseSteps = kwargs.pop("fuseSteps", None)
        self.dispatchDepth = kwargs.pop("dispatchDepth", None)
        # data-layer knobs: the bulk load's shard cache, the card-resident
        # bulk, and the codec the returned transformer ships with
        self.wireCodec = kwargs.pop("wireCodec", None)
        self.cacheDir = kwargs.pop("cacheDir", None)
        self.deviceCache = kwargs.pop("deviceCache", None)
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
        X = self.loadImagesInternal(frame, self.getInputCol(),
                                    cache_dir=self.cacheDir)
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

    # copied from tpudl/ml/estimator.py:_train_codec
    def _train_codec(self, X):
        """The u8 wire codec when the loaded batch ships as RAW uint8
        (a loader built with ``output_dtype='uint8'`` — its deferred
        ``* scale`` normalize MUST run on device or the model trains on
        un-normalized pixels). None for float32 batches: the loader
        already normalized, today's exact path."""
        if getattr(X, "dtype", None) != np.uint8:
            return None
        from tpudl_torch.data import U8Codec

        loader = self.getImageLoader()
        return U8Codec(scale=getattr(loader, "wire_scale", 1.0),
                       offset=getattr(loader, "wire_offset", 0.0))

    def _bulk_pin(self, X, y, dev):
        """With ``deviceCache`` on, ``(X, y)`` resident on ``dev`` (a
        pinned entry of the shared device cache, keyed on their content),
        or None (off, or over the budget)."""
        dc_on = (bool(self.deviceCache) if self.deviceCache is not None
                 else os.environ.get("TPUDL_DATA_DEVICE_CACHE", "0") == "1")
        if not dc_on:
            return None
        from tpudl_torch.data import device_cache as _dc

        # content tokens in the RUN component (key[0]), so a new
        # dataset's bulk can evict a finished one's
        key = (f"estimator-bulk|{_dc.array_token(X)}|"
               f"{_dc.array_token(y)}|{_dc.device_token(dev)}", 0)
        return _dc.bulk_resident(key, (X, y), device=dev)

    def _devices(self, devices) -> list:
        """A trial's slice as a list of devices: ``devices`` (one device or
        a list), else the mesh's cards, else the estimator's device."""
        if devices is None:
            devices = (list(self.mesh.devices) if self.mesh is not None
                       else [self.device])
        elif isinstance(devices, (str, torch.device)):
            devices = [devices]
        return [resolve_device(d) for d in devices]

    def _train_one(self, gin, X, y, devices=None):
        """Train on ``(X, y)`` from ``gin.params`` on a slice of
        ``devices`` (default: the mesh's cards, else the estimator's
        device; one device may be passed alone): ``(params, epoch losses,
        step losses)``, ``params`` as torch tensors on the slice's first
        device in Keras's layout. A slice of several entries trains
        data-parallel (see the module docstring)."""
        fit_params = self._validateFitParams(self.getKerasFitParams())
        batch_size = int(fit_params.get("batch_size", 32))
        epochs = int(fit_params.get("epochs", 1))
        shuffle = bool(fit_params.get("shuffle", True))
        seed = int(fit_params.get("seed", 0))
        lr = fit_params.get("learning_rate")
        n = len(X)
        if n == 0:
            raise ValueError("cannot fit on an empty frame (0 images)")
        devs = self._devices(devices)
        dev, width = devs[0], len(devs)
        # batches split evenly over the slice: the batch rounds up to a
        # multiple of its width and batches stride by that many fresh
        # rows, as tpudl's sub-mesh trials draw them
        target = math.ceil(batch_size / width) * width
        codec = self._train_codec(X)
        loss_fn = get_loss(self.getKerasLoss())
        factory, default_lr = get_optimizer_dynamic(self.getKerasOptimizer())
        # every floating variable trains, as tpudl's step differentiates
        # them all (BN's moving statistics too); an integer one (a
        # Normalization's count) rides along
        if width > 1:
            from tpudl_torch import mesh as M

            # every card of the slice holds the whole variables: tpudl's
            # replicated placement gate, before any copy
            M.require_hbm_fit(gin.params, None, what="replicated tree")
        params = {k: torch.tensor(np.asarray(v), device=dev,
                                  requires_grad=np.asarray(v).dtype.kind
                                  == "f")
                  for k, v in gin.params.items()}
        trained = [k for k, t in params.items() if t.requires_grad]
        opt = factory([params[k] for k in trained])
        set_learning_rate(opt, lr if lr is not None else default_lr)
        apply_fn = gin.make_fn()
        # one replica of the variables an entry of the slice after the
        # first, which trains the originals
        replicas = [params] + [
            {k: t.detach().to(d, copy=True).requires_grad_(t.requires_grad)
             for k, t in params.items()} for d in devs[1:]]
        if width > 1:
            mesh = M.build_mesh(devices=devs)

        def step(xb, yb):
            """One optimizer step on the batch ``(xb, yb)`` (host numpy;
            device tensors when resident): its loss, on ``dev``."""
            if width == 1:
                if not isinstance(xb, torch.Tensor):
                    xb = torch.from_numpy(xb).to(dev, non_blocking=True)
                    yb = torch.from_numpy(yb).to(dev, non_blocking=True)
                if codec is not None:
                    xb = codec.prologue(xb)
                opt.zero_grad(set_to_none=True)
                loss = loss_fn(apply_fn(params, xb), yb)
                loss.backward()
                opt.step()
                return loss.detach()
            grads, loss = sharded_backward(
                apply_fn, loss_fn, replicas, M.shard_batch((xb, yb), mesh),
                devs, codec)
            for k, g in grads.items():
                params[k].grad = g
            opt.step()
            M.broadcast([params[k] for k in trained],
                        [[rep[k] for k in trained] for rep in replicas],
                        devs)
            return loss

        rng = np.random.default_rng(seed)
        epoch_losses, step_losses = [], []
        # the bulk residency stays on one card, as in tpudl: a
        # data-parallel slice ships its shards every step
        bulk = self._bulk_pin(X, y, dev) if width == 1 else None
        # everything past the bulk acquisition runs under the releasing
        # finally: a failed trial must not strand its pin in the budget
        try:
            Xr, yr = bulk.arrays if bulk is not None else (X, y)
            with torch.enable_grad(), full_f32(), \
                    _obs_watchdog.heartbeat(
                        "estimator.train_trial", epochs=epochs,
                        steps_total=epochs * -(-n // target)) as hb, \
                    _obs_tracer.span("estimator.train_trial",
                                     epochs=epochs, batch_size=target,
                                     slice_width=width):
                for _epoch in range(epochs):
                    order = rng.permutation(n) if shuffle else np.arange(n)
                    batch_losses = []     # on the device; one fetch an epoch
                    for start in range(0, n, target):
                        # one beat a step: a hung step flags a stall
                        # naming the epoch and step it froze at
                        hb.beat(epoch=_epoch, step=len(step_losses)
                                + len(batch_losses))
                        idx = order[start:start + target]
                        if len(idx) < target:   # the ragged tail wraps
                            reps = math.ceil((target - len(idx)) / n)
                            fill = np.concatenate(
                                [order] * reps)[: target - len(idx)]
                            idx = np.concatenate([idx, fill])
                        if bulk is not None:
                            # X/y live on the card: gather there
                            sel = torch.from_numpy(idx).to(dev)
                            batch_losses.append(step(Xr[sel], yr[sel]))
                        else:
                            batch_losses.append(step(X[idx], y[idx]))
                    losses = torch.stack(batch_losses).cpu()
                    step_losses += losses.tolist()
                    epoch_losses.append(float(losses.mean()))
        finally:
            if bulk is not None:
                # the bulk stays resident (warm for a re-fit) but unpinned
                bulk.release()
        n_steps = len(step_losses)
        _obs_metrics.counter("estimator.trials").inc()
        _obs_metrics.counter("estimator.train_steps").inc(n_steps)
        if codec is not None and n_steps and bulk is None:
            # wire accounting: encoded bytes a fixed-size step ships vs
            # the float32 the prologue reconstitutes (a resident trial
            # ships its dataset once, counted by the data.hbm counters)
            row = int(X.nbytes) / max(1, len(X))
            shipped = int(n_steps * target * row)
            dense = int(n_steps * target * (X.size / max(1, len(X))) * 4)
            _obs_metrics.counter("data.wire.bytes_shipped").inc(shipped)
            _attr.charge("wire_bytes", shipped)
            _obs_metrics.counter("data.wire.bytes_dense").inc(dense)
            if dense > shipped:
                _obs_metrics.counter("data.wire.bytes_saved").inc(
                    dense - shipped)
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
            mesh=self.mesh, prefetchDepth=self.prefetchDepth,
            prepareWorkers=self.prepareWorkers, fuseSteps=self.fuseSteps,
            dispatchDepth=self.dispatchDepth, wireCodec=self.wireCodec,
            cacheDir=self.cacheDir, deviceCache=self.deviceCache)

    def _trained_model(self, gin, X, y, devices=None):
        """Train on ``devices`` (a device, or a trial's slice), write the
        trained file and return its transformer (on the slice's first
        device, or over the mesh), with the losses as its ``history``."""
        params, epoch_losses, step_losses = self._train_one(gin, X, y,
                                                            devices)
        model = self._make_transformer(
            self._save_trained(gin, params),
            None if devices is None else self._devices(devices)[0])
        model.history = {"epoch_loss": epoch_losses,
                         "step_loss": step_losses}
        return model

    def _fit(self, frame, devices=None):
        X, y = self._getNumpyFeaturesAndLabels(frame)
        return self._trained_model(self._ingest(), X, y, devices)

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
        data or the model file. The mesh's cards (else every visible
        card; on the CPU, the one device) are carved into one slice a
        trial in flight (:func:`tpudl_torch.ml.hpo.device_slices`), and a
        trial trains data-parallel over its slice."""
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
            sched = TrialScheduler(
                devices=(list(self.mesh.devices) if self.mesh is not None
                         else None), device=self.device)

            def trial(i, _pm, slice_devs):
                # a slice of several entries trains data-parallel over it
                if i in private:
                    return confs[i]._fit(frame, slice_devs)
                return confs[i]._trained_model(gin, X, y, slice_devs)

            yield from sched.run(paramMaps, trial,
                                 retry=self.trialRetryPolicy)

        return gen()
