"""The training loop.

Port of the one-device subset of ``tpudl/train/runner.py``: ``Trainer``
(``fit`` with ``log_every``, ``opt_state`` and the cooperative ``stop``)
and ``Preempted``. tpudl's ``fit`` copies the caller's params and returns
new ones; this one trains the module in place (torch's way: no second
copy of the weights on the card) and returns it. The optimizer object
holds its own state and takes the place of tpudl's ``opt_state``.

Not ported yet, and refused by name: ``mesh=`` (data parallelism) and
``checkpoint_dir=`` (``CheckpointManager``) — ROADMAP Queue 1, 'Training,
rest', with ``TrainContext`` and ``HorovodRunner`` — and
``param_shardings=`` (ROADMAP Queue 1, 'LM parallelism').
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from tpudl_torch.obs import metrics as _obs_metrics
from tpudl_torch.train.step import make_train_step

__all__ = ["Trainer", "Preempted"]

log = logging.getLogger("tpudl_torch.train")

# tpudl Trainer options with no counterpart yet → the ROADMAP Queue 1 item
_NOT_PORTED = {"mesh": "Training, rest", "checkpoint_dir": "Training, rest",
               "param_shardings": "LM parallelism"}


class Preempted(Exception):
    """Cooperative-stop signal: ``Trainer.fit(stop=...)`` saw the stop
    flag before ``step`` and unwound (steps ``0..step-1`` ran). Copied
    from ``tpudl/train/runner.py``; the port saves no checkpoint yet, so
    ``fit`` raises it with ``saved=False``."""

    def __init__(self, step: int, saved: bool = True):
        super().__init__(f"preempted at step {step}"
                         + ("" if saved else " (no checkpoint dir — "
                            "state NOT saved)"))
        self.step = int(step)
        self.saved = bool(saved)


class Trainer:
    """Step loop: host batches → the model's device → one train step,
    with throughput metrics.

    ``loss_fn(model, *batch)`` is the batch-mean loss (for example
    ``TinyCausalLM.loss_fn()``); ``optimizer`` is a factory ``params ->
    torch.optim.Optimizer`` (:mod:`tpudl_torch.train.optim`).
    ``data_fn(step) -> array or tuple of arrays`` (host numpy) must be
    stateless in ``step``."""

    def __init__(self, loss_fn, optimizer, *, mesh=None,
                 checkpoint_dir=None, log_every: int = 0,
                 param_shardings=None):
        given = {"mesh": mesh, "checkpoint_dir": checkpoint_dir,
                 "param_shardings": param_shardings}
        for name, item in _NOT_PORTED.items():
            if given[name] is not None:
                raise NotImplementedError(
                    f"Trainer({name}=...) is not ported to tpudl_torch yet "
                    f"(ROADMAP Queue 1, {item!r})")
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.log_every = log_every
        self.history: list[dict] = []
        self._step_fn = make_train_step(loss_fn)

    def fit(self, model, data_fn, steps: int, *, opt_state=None, stop=None):
        """Train ``model`` (an ``nn.Module``, in place) for ``steps``
        steps. Returns ``(model, optimizer, history)``; pass the optimizer
        back as ``opt_state`` to continue with its state.

        ``history`` gets ``{"step", "loss", "examples_per_sec"}`` every
        ``log_every`` steps (each such entry reads the loss back from the
        device) and after the last step if that one was not logged.
        ``stop`` (optional zero-arg callable → bool) is polled before
        every step; when it turns truthy ``fit`` raises
        :class:`Preempted`."""
        self.history = []  # per-fit; stale entries would misreport results
        optimizer = (opt_state if opt_state is not None
                     else self.optimizer(model.parameters()))
        device = next(model.parameters()).device
        t0 = time.perf_counter()
        examples = 0
        executed = 0
        loss = None
        # per-step host loop time: the step does not wait for the card,
        # so this is the dispatch cadence; examples_per_sec in history is
        # the wall-clock rate
        step_hist = _obs_metrics.histogram("train.step_seconds")
        step_gauge = _obs_metrics.gauge("train.last_step")
        try:
            for step in range(steps):
                if stop is not None and stop():
                    raise Preempted(step, saved=False)
                t_step = time.perf_counter()
                batch = data_fn(step)
                if not isinstance(batch, tuple):
                    batch = (batch,)
                batch = tuple(torch.as_tensor(np.asarray(b)).to(device)
                              for b in batch)
                loss = self._step_fn(model, optimizer, *batch)
                step_hist.observe(time.perf_counter() - t_step)
                step_gauge.set(step + 1)
                executed += 1
                examples += int(batch[0].shape[0])
                done = step + 1
                if self.log_every and done % self.log_every == 0:
                    self._record(done, loss, examples, t0)
            if loss is not None and (not self.history
                                     or self.history[-1]["step"] != steps):
                self._record(steps, loss, examples, t0)
        finally:
            _obs_metrics.counter("train.steps").inc(executed)
            _obs_metrics.counter("train.examples").inc(examples)
        return model, optimizer, self.history

    def _record(self, step, loss, examples, t0):
        value = float(loss)  # waits for the card: the logged step is done
        rate = examples / max(time.perf_counter() - t0, 1e-9)
        self.history.append({"step": step, "loss": value,
                             "examples_per_sec": rate})
        log.info("step %d loss %.5f (%.1f ex/s)", step, value, rate)
