"""The retry policy that paces ``HorovodRunner``'s gang restarts and
re-attempts a tuning trial.

Port of the parts of ``tpudl/jobs/retry.py`` the runner and the trial
scheduler use: :func:`is_fatal`, and :class:`RetryPolicy`'s
classification (:meth:`~RetryPolicy.is_transient`), backoff
(:meth:`~RetryPolicy.backoff_s`), the retry loop (:meth:`~RetryPolicy.call`)
and :meth:`~RetryPolicy.record`. ``record`` counts into
:mod:`tpudl_torch.obs.metrics` and files the retry in the flight
recorder's error ring, and charges the caller's attribution scope one
``retries`` beside ``retry.attempts``. :func:`io_policy` is the
shared IO policy the shard cache, the image reads and the supervisor's
transfer retries run under.

Classification contract, as in tpudl: exceptions carrying
``tpudl_fatal = True`` (:class:`tpudl_torch.train.Preempted`) are never
retried — a preemption is an orderly shutdown request.
"""

from __future__ import annotations

import os
import random
import time

from tpudl_torch.obs import attribution as _attr
from tpudl_torch.obs import metrics as _metrics

__all__ = ["RetryPolicy", "is_fatal", "io_policy", "PROGRAMMING_ERRORS"]

# copied from tpudl/jobs/retry.py: never retried regardless of policy
_ALWAYS_FATAL = (SystemExit, KeyboardInterrupt, GeneratorExit,
                 MemoryError)
# the conservative transient default: IO-shaped failures
_DEFAULT_TRANSIENT = (OSError, TimeoutError, ConnectionError,
                      InterruptedError)
# programming errors a retry can never cure: even the retry-anything
# gang-restart policy ("all") refuses these
PROGRAMMING_ERRORS = (AttributeError, TypeError, NameError, ImportError,
                      SyntaxError)


# copied from tpudl/jobs/retry.py:is_fatal
def is_fatal(exc: BaseException) -> bool:
    """True when ``exc`` must never be retried by ANY policy."""
    return (isinstance(exc, _ALWAYS_FATAL)
            or bool(getattr(exc, "tpudl_fatal", False)))


# copied from tpudl/jobs/retry.py:RetryPolicy
class RetryPolicy:
    """Bounded retries with exponential backoff + deterministic jitter.

    ``max_attempts`` counts TOTAL attempts (1 = no retries).
    ``transient`` is a tuple of exception types (default: the IO set)
    or the string ``"all"`` (retry anything non-fatal — the gang-
    restart semantics); ``classify`` overrides it with a predicate
    ``exc -> bool``. ``sleep`` is injectable for tests; ``seed`` makes
    the jitter reproducible.
    """

    def __init__(self, max_attempts: int = 3, *, backoff_s: float = 0.1,
                 backoff_factor: float = 2.0, max_backoff_s: float = 30.0,
                 jitter: float = 0.1, transient=None, classify=None,
                 sleep=time.sleep, seed: int | None = None):
        self.max_attempts = max(1, int(max_attempts))
        self.backoff_base_s = float(backoff_s)
        self.backoff_factor = float(backoff_factor)
        self.max_backoff_s = float(max_backoff_s)
        self.jitter = float(jitter)
        self._transient = transient if transient is not None \
            else _DEFAULT_TRANSIENT
        self._classify = classify
        self._sleep = sleep
        self._rng = random.Random(seed)

    def is_transient(self, exc: BaseException) -> bool:
        if is_fatal(exc):
            return False
        if self._classify is not None:
            return bool(self._classify(exc))
        if self._transient == "all":
            return not isinstance(exc, PROGRAMMING_ERRORS)
        return isinstance(exc, tuple(self._transient))

    def backoff_s(self, attempt: int) -> float:
        """Sleep before re-attempt number ``attempt + 1`` (attempt is
        1-based: the first FAILED attempt computes backoff_s(1))."""
        base = self.backoff_base_s * (
            self.backoff_factor ** max(0, int(attempt) - 1))
        base = min(base, self.max_backoff_s)
        if self.jitter > 0:
            base += self._rng.uniform(0, self.jitter * base)
        return base

    def call(self, fn, *args, kind: str = "op", on_retry=None, **kwargs):
        """``fn(*args, **kwargs)`` with retries. Transient failures back
        off and re-attempt up to ``max_attempts`` total tries; fatal or
        classified-permanent failures (and the final transient one)
        re-raise the ORIGINAL exception. Every retry is recorded;
        ``on_retry(exc, attempt)`` also notifies the caller."""
        attempt = 0
        while True:
            attempt += 1
            try:
                return fn(*args, **kwargs)
            except BaseException as e:
                if attempt >= self.max_attempts or not self.is_transient(e):
                    raise
                delay = self.backoff_s(attempt)
                self.record(kind, e, attempt=attempt, backoff_s=delay)
                if on_retry is not None:
                    on_retry(e, attempt)
                if delay > 0:
                    self._sleep(delay)

    def record(self, kind: str, exc: BaseException, *, attempt: int,
               backoff_s: float | None = None):
        """Count one retry (``retry.attempts``, ``retry.<kind>`` and the
        ``retry.backoff_s`` histogram) and file it in the flight
        recorder's error ring (kind ``retry.<kind>``)."""
        _metrics.counter("retry.attempts").inc()
        # the attribution pairing of retry.attempts
        _attr.charge("retries")
        _metrics.counter(f"retry.{kind}").inc()
        if backoff_s is not None:
            _metrics.histogram("retry.backoff_s").observe(float(backoff_s))
        from tpudl_torch.obs import flight as _flight

        _flight.record_error(
            f"retry.{kind}", exc, attempt=int(attempt),
            max_attempts=self.max_attempts,
            backoff_s=round(float(backoff_s), 4)
            if backoff_s is not None else None)


# copied from tpudl/jobs/retry.py:_env_int
def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


# copied from tpudl/jobs/retry.py:_env_float
def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


_IO_POLICIES: dict = {}


# copied from tpudl/jobs/retry.py:io_policy
def io_policy() -> RetryPolicy:
    """The shared IO retry policy (shard cache, bulk image load, lazy
    file reads): ``TPUDL_RETRY_IO_ATTEMPTS`` total attempts (default 3;
    1 disables retries), base backoff ``TPUDL_RETRY_IO_BACKOFF_S``
    (default 0.05s). Instances are cached per knob pair — this sits on
    per-file/per-row hot paths, where constructing a fresh
    ``random.Random()`` each call would cost more than the open it
    guards — while env changes (tests) still take effect immediately.
    The shared jitter RNG across threads only smears the jitter, which
    is its job."""
    key = (_env_int("TPUDL_RETRY_IO_ATTEMPTS", 3),
           _env_float("TPUDL_RETRY_IO_BACKOFF_S", 0.05))
    pol = _IO_POLICIES.get(key)
    if pol is None:
        pol = _IO_POLICIES[key] = RetryPolicy(
            max_attempts=key[0], backoff_s=key[1], max_backoff_s=2.0)
    return pol
