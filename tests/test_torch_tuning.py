"""Model selection in the port held to tpudl on the CPU: ``device_slices``
carving, ``TrialScheduler`` completion order and per-trial retry,
``ParamGridBuilder`` grids, ``CrossValidator`` folds, and
``CrossValidator`` over ``KerasImageFileEstimator.fitMultiple`` on
``bench.py``'s ``measure_estimator_fit`` set (32 PNGs, its CNN, adam),
plus ``fitMultiple``'s private path for a ``modelFile`` override and the
retry of a transient trial failure.

Tolerances: carving, order, grids, folds and ``bestIndex`` exact;
``avgMetrics`` (mean cross-entropy of the validation folds) within 1e-5,
the limit ``test_torch_keras_train.py`` holds per-step losses to; the port's own
runs (fitMultiple against a loop of fit, a retried sweep against a clean
one) bit for bit."""

import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch

keras = pytest.importorskip("keras")

import torch_keras_models as M  # noqa: E402
from PIL import Image  # noqa: E402

from tpudl.frame import Frame as JaxFrame  # noqa: E402
from tpudl.jobs.retry import RetryPolicy as JaxRetryPolicy  # noqa: E402
from tpudl.ml import KerasImageFileEstimator as JaxEstimator  # noqa: E402
from tpudl.ml import hpo as jax_hpo  # noqa: E402
from tpudl.ml import tuning as jax_tuning  # noqa: E402
from tpudl_torch.frame import Frame  # noqa: E402
from tpudl_torch.jobs import RetryPolicy  # noqa: E402
from tpudl_torch.ml import (CrossValidator, FunctionEvaluator,  # noqa: E402
                            KerasImageFileEstimator, ParamGridBuilder)
from tpudl_torch.ml import hpo  # noqa: E402
from tpudl_torch.ml.tuning import CrossValidatorModel  # noqa: E402
from tpudl_torch.obs import metrics  # noqa: E402
from tpudl_torch.train import Preempted  # noqa: E402

torch.set_num_threads(1)
METRIC_ATOL = 1e-5


@pytest.mark.parametrize("n_devices", range(1, 9))
def test_device_slices_match_tpudl(n_devices):
    devices = [f"dev{i}" for i in range(n_devices)]
    for n_trials in range(1, 10):
        ours = hpo.device_slices(n_trials, devices)
        assert ours == jax_hpo.device_slices(n_trials, devices)
        assert sum(ours, []) == devices
    assert [len(s) for s in hpo.device_slices(3, [0] * 8)] == [3, 3, 2]


def test_visible_devices():
    assert hpo.visible_devices("cpu") == [torch.device("cpu")]
    with pytest.raises(RuntimeError, match="cuda"):     # no card here
        hpo.visible_devices()


def _sleepy(sleeps):
    def trial(i, item, devs):
        time.sleep(sleeps[i])
        return (item, tuple(devs))
    return trial


def test_scheduler_yields_in_completion_order_like_tpudl():
    sleeps = [0.4, 0.05, 0.25, 0.0]
    items = ["a", "b", "c", "d"]
    devices = ["d0", "d1", "d2", "d3"]
    ours = list(hpo.TrialScheduler(devices).run(items, _sleepy(sleeps)))
    theirs = list(jax_hpo.TrialScheduler(devices).run(items,
                                                      _sleepy(sleeps)))
    assert [i for i, _ in ours] == [i for i, _ in theirs] == [3, 1, 2, 0]
    assert sorted(r[0] for _, r in ours) == items
    assert all(len(r[1]) == 1 for _, r in ours)
    # one slice: one trial at a time, in submission order
    one = list(hpo.TrialScheduler(["only"]).run(items, _sleepy(sleeps)))
    assert [i for i, _ in one] == [0, 1, 2, 3]
    assert list(hpo.TrialScheduler(["x"]).run([], _sleepy(sleeps))) == []


def _flaky(fail_first, exc):
    lock, seen = threading.Lock(), set()

    def trial(i, item, devs):
        with lock:
            first = i not in seen
            seen.add(i)
        if i == fail_first and first:
            raise exc
        return item * 2
    return trial


@pytest.mark.parametrize("package", ["port", "tpudl"])
def test_scheduler_retries_transient_not_fatal(package):
    sched_cls = (hpo.TrialScheduler if package == "port"
                 else jax_hpo.TrialScheduler)
    policy_cls = RetryPolicy if package == "port" else JaxRetryPolicy
    retry = policy_cls(max_attempts=3, backoff_s=0.0, jitter=0.0)
    before = metrics.counter("hpo.trial_retries").value
    out = dict(sched_cls(["d0", "d1"]).run(
        [1, 2, 3], _flaky(1, OSError("flaky disk")), retry=retry))
    assert out == {0: 2, 1: 4, 2: 6}
    if package == "port":
        assert metrics.counter("hpo.trial_retries").value == before + 1
    failed = metrics.counter("hpo.trials_failed").value
    with pytest.raises(Preempted):
        list(sched_cls(["d0"]).run([1, 2], _flaky(0, Preempted(3)),
                                   retry=retry))
    with pytest.raises(OSError):          # no policy: the first failure
        list(sched_cls(["d0"]).run([1], _flaky(0, OSError("x"))))
    if package == "port":
        assert metrics.counter("hpo.trials_failed").value == failed + 2


@pytest.mark.parametrize("exc,fails", [(OSError("disk"), 1),
                                       (TimeoutError(), 5),
                                       (ValueError("bug"), 1),
                                       (Preempted(2), 1)])
def test_retry_call_matches_tpudl(exc, fails):
    """``RetryPolicy.call`` (copied): the same attempts, sleeps and
    outcome as tpudl's on a function that fails ``fails`` times."""
    def run(policy_cls):
        sleeps, calls = [], []

        def fn(x):
            calls.append(x)
            if len(calls) <= fails:
                raise exc
            return x + 1

        policy = policy_cls(max_attempts=4, seed=9, sleep=sleeps.append)
        try:
            out = policy.call(fn, 41, kind="test")
        except BaseException as e:
            out = type(e)
        return out, calls, sleeps

    assert run(RetryPolicy) == run(JaxRetryPolicy)


def test_scheduler_takes_attempts_from_the_environment(monkeypatch):
    monkeypatch.setenv("TPUDL_HPO_TRIAL_ATTEMPTS", "2")
    out = dict(hpo.TrialScheduler(["d0"]).run(
        [5], _flaky(0, TimeoutError())))
    assert out == {0: 10}


def test_param_grid_builder_matches_tpudl():
    ours_est = KerasImageFileEstimator(device="cpu")
    theirs_est = JaxEstimator()
    fits = [{"learning_rate": 1e-2}, {"learning_rate": 1e-3}]

    def named(grid):
        return [{p.name: v for p, v in m.items()} for m in grid]

    ours = (ParamGridBuilder()
            .baseOn({ours_est.kerasOptimizer: "adam"})
            .addGrid(ours_est.kerasFitParams, fits)
            .addGrid(ours_est.kerasLoss, ["categorical_crossentropy",
                                          "mean_squared_error"]).build())
    theirs = (jax_tuning.ParamGridBuilder()
              .baseOn({theirs_est.kerasOptimizer: "adam"})
              .addGrid(theirs_est.kerasFitParams, fits)
              .addGrid(theirs_est.kerasLoss, ["categorical_crossentropy",
                                              "mean_squared_error"]).build())
    assert named(ours) == named(theirs) and len(ours) == 4
    assert ParamGridBuilder().build() == jax_tuning.ParamGridBuilder().build()
    for bad, exc in ((lambda b: b.addGrid("kerasLoss", ["x"]), TypeError),
                     (lambda b: b.addGrid(ours_est.kerasLoss, []),
                      ValueError),
                     (lambda b: b.baseOn(kerasLoss="x"), TypeError)):
        with pytest.raises(exc):
            bad(ParamGridBuilder())


@pytest.mark.parametrize("n,k,seed", [(32, 2, 0), (10, 3, 1), (7, 7, 5),
                                      (100, 4, 42)])
def test_cross_validator_folds_match_tpudl(n, k, seed):
    ours = CrossValidator(numFolds=k, seed=seed)._folds(n)
    theirs = jax_tuning.CrossValidator(numFolds=k, seed=seed)._folds(n)
    assert len(ours) == len(theirs) == k
    for a, b in zip(ours, theirs):
        assert np.array_equal(a, b)
    with pytest.raises(ValueError):
        CrossValidator(numFolds=1)._folds(n)
    with pytest.raises(ValueError):
        CrossValidator(numFolds=n + 1)._folds(n)


# -- CrossValidator over the estimator --------------------------------------
def _loader(uri):
    img = Image.open(uri).convert("RGB").resize((32, 32), Image.BILINEAR)
    return np.asarray(img, dtype=np.float32) / 255.0


@pytest.fixture(scope="module")
def fit_set(tmp_path_factory):
    d = tmp_path_factory.mktemp("cv")
    rng = np.random.default_rng(0)
    uris, labels = [], []
    for i in range(32):
        arr = rng.integers(0, 255, size=(48, 48, 3), dtype=np.uint8)
        if i % 2:
            arr[:24] //= 4
        p = str(d / f"im{i}.png")
        Image.fromarray(arr).save(p)
        uris.append(p)
        labels.append(np.eye(2, dtype=np.float32)[i % 2])
    lab = np.empty(len(labels), dtype=object)
    lab[:] = labels
    path = M.saved("cnn", d)
    copy = str(d / "cnn_copy.keras")
    shutil.copy(path, copy)
    return path, copy, np.array(uris, dtype=object), lab


def _kw(path):
    return dict(inputCol="uri", outputCol="out", labelCol="label",
                imageLoader=_loader, modelFile=path, kerasOptimizer="adam",
                kerasLoss="categorical_crossentropy",
                kerasFitParams={"epochs": 2, "batch_size": 8})


def _log_loss(frame):
    p = np.stack([np.asarray(v) for v in frame["out"]])
    y = np.stack([np.asarray(v) for v in frame["label"]])
    return float(-np.mean(np.sum(y * np.log(np.clip(p, 1e-7, 1.0)), axis=1)))


GRID_LRS = (3e-2, 1e-3, 1e-4)


def _grid(est, builder):
    return builder().addGrid(est.kerasFitParams, [
        {"epochs": 2, "batch_size": 8, "learning_rate": lr}
        for lr in GRID_LRS]).build()


def test_cross_validator_over_the_estimator_matches_tpudl(fit_set):
    """tpudl gets a one-device mesh: on the tests' 8 simulated devices
    its trials would otherwise train data-parallel over slices of 3, 3
    and 2 devices (sums in another order, which adam's ~lr·sign(g) first
    steps amplify), where the port trains each trial on one device."""
    import jax

    from tpudl import mesh as jax_mesh

    path, _copy, uris, labels = fit_set
    ours_est = KerasImageFileEstimator(device="cpu", **_kw(path))
    theirs_est = JaxEstimator(mesh=jax_mesh.build_mesh(
        devices=jax.devices()[:1]), **_kw(path))
    ours = CrossValidator(
        estimator=ours_est, estimatorParamMaps=_grid(ours_est,
                                                     ParamGridBuilder),
        evaluator=FunctionEvaluator(_log_loss, larger_is_better=False),
        numFolds=2, seed=7).fit(Frame({"uri": uris, "label": labels}))
    theirs = jax_tuning.CrossValidator(
        estimator=theirs_est,
        estimatorParamMaps=_grid(theirs_est, jax_tuning.ParamGridBuilder),
        evaluator=jax_tuning.FunctionEvaluator(_log_loss,
                                               larger_is_better=False),
        numFolds=2, seed=7).fit(JaxFrame({"uri": uris, "label": labels}))
    assert isinstance(ours, CrossValidatorModel)
    np.testing.assert_allclose(ours.avgMetrics, theirs.avgMetrics,
                               atol=METRIC_ATOL, rtol=0)
    assert ours.bestIndex == theirs.bestIndex
    assert len(set(np.round(ours.avgMetrics, 3))) == len(GRID_LRS)
    out = ours.transform(Frame({"uri": uris[:4]}))
    assert np.stack(list(out["out"])).shape == (4, 2)
    for m in (ours, theirs):
        os.remove(m.bestModel.getModelFile())


def test_fit_multiple_equals_a_loop_of_fits(fit_set):
    path, _copy, uris, labels = fit_set
    est = KerasImageFileEstimator(device="cpu", **_kw(path))
    maps = _grid(est, ParamGridBuilder)
    frame = Frame({"uri": uris, "label": labels})
    before = metrics.counter("hpo.trials_completed").value
    swept = dict(est.fitMultiple(frame, maps))
    assert sorted(swept) == [0, 1, 2]
    assert metrics.counter("hpo.trials_completed").value == before + 3
    listed = est.fit(frame, maps)
    for i, pm in enumerate(maps):
        alone = est.fit(frame, pm)
        assert swept[i].history == listed[i].history == alone.history
        for m in (swept[i], listed[i], alone):
            os.remove(m.getModelFile())


def test_overrides_shared_matches_tpudl(fit_set):
    path, copy, _uris, _labels = fit_set
    ours, theirs = KerasImageFileEstimator(device="cpu", **_kw(path)), \
        JaxEstimator(**_kw(path))

    def loader(uri):
        return _loader(uri)

    changes = [{}, {"modelFile": path}, {"modelFile": copy},
               {"inputCol": "uri"}, {"inputCol": "other"},
               {"labelCol": "label"}, {"labelCol": "y"},
               {"imageLoader": _loader}, {"imageLoader": loader},
               {"kerasLoss": "mean_squared_error"},
               {"kerasFitParams": {"epochs": 3}}]
    for change in changes:
        got = ours._overrides_shared(ours.copy(
            {ours.getParam(k): v for k, v in change.items()}))
        want = theirs._overrides_shared(theirs.copy(
            {theirs.getParam(k): v for k, v in change.items()}))
        assert got == want, change


def test_fit_multiple_private_path_for_a_model_file_override(fit_set):
    path, copy, uris, labels = fit_set
    est = KerasImageFileEstimator(device="cpu", **_kw(path))
    frame = Frame({"uri": uris, "label": labels})
    maps = [{}, {est.modelFile: copy}, {est.modelFile: path}]
    confs = [est.copy(pm) for pm in maps]
    assert [est._overrides_shared(c) for c in confs] == [False, True, False]
    private = []
    fit = KerasImageFileEstimator._fit

    def spy(self, frame, device=None):
        private.append(self.getModelFile())
        return fit(self, frame, device)

    KerasImageFileEstimator._fit = spy
    try:
        out = dict(est.fitMultiple(frame, maps))
    finally:
        KerasImageFileEstimator._fit = fit
    assert private == [copy]
    # the copy holds the same weights: every trial trains the same model
    assert out[0].history == out[1].history == out[2].history
    for m in out.values():
        os.remove(m.getModelFile())


class _FailsOnce(KerasImageFileEstimator):
    """The first trial of each sweep raises a transient error once."""

    failed: list = []

    def _trained_model(self, gin, X, y, device=None):
        if not self.failed:
            self.failed.append(True)
            raise OSError("transient read error")
        return super()._trained_model(gin, X, y, device)


def test_fit_multiple_retries_a_transient_trial(fit_set):
    path, _copy, uris, labels = fit_set
    frame = Frame({"uri": uris, "label": labels})
    policy = RetryPolicy(max_attempts=2, backoff_s=0.0, jitter=0.0)
    est = KerasImageFileEstimator(device="cpu", **_kw(path))
    maps = _grid(est, ParamGridBuilder)[:2]
    clean = dict(est.fitMultiple(frame, maps))
    flaky = _FailsOnce(device="cpu", trialRetryPolicy=policy, **_kw(path))
    flaky.failed.clear()
    before = metrics.counter("hpo.trial_retries").value
    retried = dict(flaky.fitMultiple(frame, maps))
    assert metrics.counter("hpo.trial_retries").value == before + 1
    assert [retried[i].history for i in (0, 1)] == \
        [clean[i].history for i in (0, 1)]
    for m in list(clean.values()) + list(retried.values()):
        os.remove(m.getModelFile())
    flaky.trialRetryPolicy = None        # no policy: the failure propagates
    flaky.failed.clear()
    with pytest.raises(OSError, match="transient"):
        dict(flaky.fitMultiple(frame, maps))
