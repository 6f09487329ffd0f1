"""Task-parallel hyperparameter search over device slices.

Port of ``tpudl/ml/hpo.py``: the device pool is carved into one slice
per in-flight trial (:func:`device_slices`, tpudl's carving: 8 devices /
3 trials → widths 3, 3, 2), trials run from a thread pool with at most
one in flight per slice, and results are yielded in COMPLETION order
(the CrossValidator contract). Devices are ``torch.device``\\ s: by
default every visible CUDA device, ``[cpu]`` when the caller asks for
the CPU (``device="cpu"``). The trials share host RAM; torch releases
the GIL in its kernels and copies, so trials on distinct cards overlap.

A slice wider than one card trains its trial on its first card:
data-parallel trials wait for the estimator's ``mesh=`` (ROADMAP Queue
1, 'Training, rest'). The per-trial metrics are tpudl's
(``hpo.trials_started``/``_completed``/``_failed``, ``hpo.trial_retries``
and the ``hpo.trial_seconds`` histogram); its watchdog heartbeat, tracer
span, flight recorder and attribution carry are not ported yet ('The
rest of observability').
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from typing import Callable, Iterator, Sequence

import torch

from tpudl_torch.device import resolve_device
from tpudl_torch.obs import metrics as _obs_metrics

__all__ = ["TrialScheduler", "device_slices", "visible_devices"]


def visible_devices(device="cuda") -> list[torch.device]:
    """The trial pool for ``device``: every visible CUDA card for
    ``"cuda"`` (raising without one), else ``[device]``."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


# copied from tpudl/ml/hpo.py:device_slices (the pool is always given)
def device_slices(n_trials: int, devices: Sequence) -> list[list]:
    """Carve the device pool into one slice per concurrently-running
    trial. With fewer trials than devices, slices are widened; with more
    trials than devices, slices are one device each and the pool
    throttles concurrency. A non-dividing pool spreads the remainder:
    8 devices / 3 trials → widths 3, 3, 2 — no device is dropped."""
    devs = list(devices)
    n_slices = max(1, min(n_trials, len(devs)))
    width, rem = divmod(len(devs), n_slices)
    slices, at = [], 0
    for i in range(n_slices):
        w = width + (1 if i < rem else 0)
        slices.append(devs[at:at + w])
        at += w
    return slices


class TrialScheduler:
    """Run ``trial_fn(index, item, devices)`` for every item, at most one
    in-flight trial per device slice, yielding ``(index, result)`` as
    trials FINISH (not in submission order).

    ``devices`` is the pool (default: :func:`visible_devices` of
    ``device``). ``trial_fn`` must be thread-safe apart from its slice."""

    def __init__(self, devices: Sequence | None = None,
                 max_parallel: int | None = None, *, device="cuda"):
        self._devices = (list(devices) if devices is not None
                         else visible_devices(device))
        self._max_parallel = max_parallel

    # copied from tpudl/ml/hpo.py:TrialScheduler.run, without its
    # heartbeat, span, flight record and attribution carry
    def run(self, items: Sequence, trial_fn: Callable, *,
            retry=None) -> Iterator[tuple[int, object]]:
        """``retry`` (a :class:`tpudl_torch.jobs.RetryPolicy`) re-attempts
        a trial whose failure classifies as TRANSIENT on its own slice
        before the sweep fails; each re-attempt counts
        ``hpo.trial_retries``. Default (or ``TPUDL_HPO_TRIAL_ATTEMPTS``
        unset/1): the first failure propagates. Fatal failures are never
        retried."""
        items = list(items)
        if not items:
            return
        if retry is None:
            from tpudl_torch.jobs.retry import RetryPolicy, _env_int

            attempts = _env_int("TPUDL_HPO_TRIAL_ATTEMPTS", 1)
            if attempts > 1:
                retry = RetryPolicy(max_attempts=attempts,
                                    backoff_s=0.05, max_backoff_s=5.0)
        slices = device_slices(len(items), self._devices)
        if self._max_parallel:
            slices = slices[: self._max_parallel]
        free = list(range(len(slices)))
        free_lock = threading.Lock()
        ended = []             # trial indices in the order the trials ended

        def run_one(i, item):
            with free_lock:
                s = free.pop()
            _obs_metrics.counter("hpo.trials_started").inc()
            t0 = time.perf_counter()
            try:
                if retry is not None:
                    out = i, retry.call(
                        trial_fn, i, item, slices[s], kind="hpo.trial",
                        on_retry=lambda e, a: _obs_metrics.counter(
                            "hpo.trial_retries").inc())
                else:
                    out = i, trial_fn(i, item, slices[s])
                _obs_metrics.counter("hpo.trials_completed").inc()
                return out
            except BaseException:
                _obs_metrics.counter("hpo.trials_failed").inc()
                raise
            finally:
                _obs_metrics.histogram("hpo.trial_seconds").observe(
                    time.perf_counter() - t0)
                with free_lock:
                    free.append(s)
                    ended.append(i)

        with ThreadPoolExecutor(max_workers=len(slices)) as pool:
            index = {pool.submit(run_one, i, item): i
                     for i, item in enumerate(items)}
            futures = set(index)
            while futures:
                done, futures = wait(futures, return_when=FIRST_COMPLETED)
                # one wait may return several trials: in the order they ended
                for f in sorted(done, key=lambda f: ended.index(index[f])):
                    yield f.result()
