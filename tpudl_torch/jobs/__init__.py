"""tpudl_torch.jobs — the preemption-survivable job runtime.

Port of ``tpudl.jobs``: a ``Trainer.fit``, an estimator fit, a bulk
featurize or a trial sweep is describable as a :class:`JobSpec`; a
:class:`JobRuntime` runs it with persistent resume state (checkpoint,
data cursor and trial ledger in one atomic manifest), turns SIGTERM into
checkpoint-then-exit with ``RC_PREEMPTED`` (75), and resumes a relaunched
identical spec with bounded rework. :class:`RetryPolicy` is the shared
transient-failure policy (gang restarts, shard and image IO, trials,
the supervisor's transfer retries).

Imports are lazy (PEP 562), as tpudl's: the runtime pulls in
``tpudl_torch.train``, which imports ``tpudl_torch.jobs.retry``.
"""

import importlib

_LAZY = {
    "JobSpec": "tpudl_torch.jobs.spec",
    "fingerprint_material": "tpudl_torch.jobs.spec",
    "JobRuntime": "tpudl_torch.jobs.runtime",
    "JobContext": "tpudl_torch.jobs.runtime",
    "JobPreempted": "tpudl_torch.jobs.runtime",
    "RC_PREEMPTED": "tpudl_torch.jobs.runtime",
    "load_manifest": "tpudl_torch.jobs.runtime",
    "RetryPolicy": "tpudl_torch.jobs.retry",
    "io_policy": "tpudl_torch.jobs.retry",
    "is_fatal": "tpudl_torch.jobs.retry",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(
        f"module 'tpudl_torch.jobs' has no attribute {name!r}")


def __dir__():
    return sorted(__all__)
