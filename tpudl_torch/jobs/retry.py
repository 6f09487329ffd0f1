"""The retry policy that paces ``HorovodRunner``'s gang restarts and
re-attempts a tuning trial.

Port of the parts of ``tpudl/jobs/retry.py`` the runner and the trial
scheduler use: :func:`is_fatal`, and :class:`RetryPolicy`'s
classification (:meth:`~RetryPolicy.is_transient`), backoff
(:meth:`~RetryPolicy.backoff_s`), the retry loop (:meth:`~RetryPolicy.call`)
and :meth:`~RetryPolicy.record`. ``record`` counts into
:mod:`tpudl_torch.obs.metrics`; tpudl's flight recorder and attribution
ledger are not ported yet (ROADMAP Queue 1, 'The rest of observability').
``io_policy`` has no user in the port yet.

Classification contract, as in tpudl: exceptions carrying
``tpudl_fatal = True`` (:class:`tpudl_torch.train.Preempted`) are never
retried — a preemption is an orderly shutdown request.
"""

from __future__ import annotations

import os
import random
import time

from tpudl_torch.obs import metrics as _metrics

__all__ = ["RetryPolicy", "is_fatal", "PROGRAMMING_ERRORS"]

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
        """Count one retry: ``retry.attempts``, ``retry.<kind>`` and the
        ``retry.backoff_s`` histogram. ``exc`` and ``attempt`` are what
        tpudl also files into its flight recorder."""
        _metrics.counter("retry.attempts").inc()
        _metrics.counter(f"retry.{kind}").inc()
        if backoff_s is not None:
            _metrics.histogram("retry.backoff_s").observe(float(backoff_s))


# copied from tpudl/jobs/retry.py:_env_int
def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default
