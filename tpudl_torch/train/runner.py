"""HorovodRunner, its TrainContext, and the training loop.

Port of ``tpudl/train/runner.py``: ``HorovodRunner(np=N).run(train_fn,
**kwargs)``, ``TrainContext``, ``Trainer`` (``fit`` with ``mesh=``,
``checkpoint_dir=``, ``save_every=``, ``log_every``, ``opt_state``, the
cooperative ``stop``), ``Preempted`` and ``RestartsExhausted``.

tpudl runs ``train_fn`` once, as the one SPMD program over a jax mesh,
and its ``ctx.rank`` is always 0. The port runs one process per rank,
Horovod's and torch's own idiom:

- ``np=1``, and the default ``np=-1``, run ``train_fn`` in the caller's
  process as a one-rank group; ``np=N`` (or ``-N``, tpudl's local debug
  form) with N > 1 starts N processes with the ``spawn`` method, rank r
  on ``cuda:r`` with NCCL, or on the CPU with gloo under
  ``device="cpu"``. ``np`` above the device count raises ``ValueError``.
  The default device is the card; without one, ``run`` raises.
- ``ctx.rank`` is the process rank and ``ctx.size`` the data axis's
  size (the world size without a model axis, tpudl's ``ctx.size``), and
  ``run`` returns rank 0's return value. Under ``TPUDL_MESH_MODEL=m``
  (which must divide the rank count, as tpudl's) the ranks fold into an
  ``(np/m, m)`` grid, tpudl's ``_build_mesh``: ``ctx.mesh`` carries this
  rank's entry and the sub-groups of its row and column, over which
  ``TinyCausalLM(mesh=, tp=True)`` runs its tensor and expert
  parallelism and its ring. A spawned rank imports
  ``train_fn`` by name, so it must be defined at the top level of an
  importable module, and its arguments and return value are pickled.
- A rank's result or exception comes back pickled over a queue, so
  ``Preempted`` stays ``Preempted`` (never restarted) and a failure keeps
  its type; the first rank to fail names the failure, with its
  traceback in a note. Collectives time out after
  :data:`tpudl_torch.distributed.COLLECTIVE_TIMEOUT_S`, so a dead rank
  cannot leave its siblings blocked; every rank leaves the process group
  on every exit path.

``Trainer.fit`` trains the module in place (torch's way: no second copy
of the weights on the card) and returns it; the optimizer object holds
its own state and takes the place of tpudl's ``opt_state``. Under a mesh
each rank feeds its rows of ``data_fn(step)`` (the global batch), the
gradients are averaged over the group (:func:`make_train_step`), and
``fit`` starts by broadcasting rank 0's parameters and buffers (and a
passed-in optimizer's state). Checkpoints hold the module's
``state_dict``, the optimizer's tensors and the step; rank 0 writes, and
every rank passes a barrier after each save.

Gang restart: on a transient failure ``run`` relaunches every rank, paced
by :class:`~tpudl_torch.jobs.retry.RetryPolicy` (``train.restarts``,
``train.restart_backoff_s``), and ``Trainer.fit`` resumes from the newest
valid checkpoint; ``RestartsExhausted`` (with ``__cause__``) ends it.
Each restart, with its cause and the step the gang died at, is filed in
the flight recorder (``record_restart``), and ``Trainer.fit`` fires
tpudl's ``train.step`` fault point before every step (a ``FaultPlan``'s
``kill_at_step`` preempts there). Each launch is a ``train.run`` host
span; ``fit`` holds a ``train.fit`` watchdog heartbeat beaten once a step
(with the step and the examples so far) and charges the caller's
attribution scope the rows of every batch (``rows_in``).
On a local mesh (the cards of this process, ``build_mesh(devices=...)``)
``fit`` runs one step over the whole batch on the model's device: the
model spreads its forward over the cards itself (README's long-context
recipe, ``Trainer(lm.loss_fn(mesh=mesh), adamw(3e-4), mesh=mesh)``, puts
the ring inside the loss), and nothing is averaged over a group.
``param_shardings=`` lays the model out by it (``shard_params``) before
``fit`` builds the optimizer. Over a process group's grid with a model
axis, ``fit`` broadcasts rank 0's whole leaves over the world and each
split leaf's slice over its column; a checkpoint gathers the split leaves
(``split_parameters``) and their optimizer state over each row, so rank 0
writes the whole arrays, the file an unsplit run writes, and a resume
gives each rank its slice back. A loss whose ``whole_batch`` is True
(``TinyCausalLM.loss_fn(mesh=)``'s ring over the data axis) takes the
whole global batch on every rank.
"""

from __future__ import annotations

import logging
import os
import pickle
import queue
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from tpudl_torch import collectives as C
from tpudl_torch import distributed as D
from tpudl_torch import mesh as M
from tpudl_torch.device import resolve_device
from tpudl_torch.jobs.retry import RetryPolicy, is_fatal
from tpudl_torch.obs import attribution as _attr
from tpudl_torch.obs import flight as _obs_flight
from tpudl_torch.obs import metrics as _obs_metrics
from tpudl_torch.obs import tracer as _obs_tracer
from tpudl_torch.obs import watchdog as _obs_watchdog
from tpudl_torch.testing import faults as _faults
from tpudl_torch.train.checkpoint import CheckpointManager
from tpudl_torch.train.step import _layout_mesh, make_train_step

__all__ = ["HorovodRunner", "TrainContext", "Trainer", "Preempted",
           "RestartsExhausted"]

log = logging.getLogger("tpudl_torch.train")

# how long the runner waits, after a rank failed, for the others to fail
# too (they do so within a collective's timeout) before it terminates them
_REAP_GRACE_S = D.COLLECTIVE_TIMEOUT_S + 30.0


class Preempted(Exception):
    """Cooperative-stop signal: ``Trainer.fit(stop=...)`` saw the stop
    flag before ``step``, force-saved a checkpoint at ``step`` (when a
    ``checkpoint_dir`` is set) and unwound. Marked ``tpudl_fatal`` so no
    retry layer fights the preemption."""

    tpudl_fatal = True

    def __init__(self, step: int, saved: bool = True):
        super().__init__(f"preempted at step {step}"
                         + ("" if saved else " (no checkpoint dir — "
                            "state NOT saved)"))
        self.step = int(step)
        self.saved = bool(saved)

    def __reduce__(self):  # it crosses from a rank to the runner pickled
        return type(self), (self.step, self.saved)


class RestartsExhausted(RuntimeError):
    """The gang-restart budget ran out. Carries the LAST cause (also
    chained as ``__cause__``) and embeds its message."""

    def __init__(self, attempts: int, last_cause: BaseException):
        super().__init__(
            f"gang restart budget exhausted after {attempts} attempt(s); "
            f"last cause: {type(last_cause).__name__}: {last_cause}")
        self.attempts = int(attempts)
        self.last_cause = last_cause


# copied from tpudl/train/runner.py:_restart_backoff_base_s
def _restart_backoff_base_s() -> float:
    try:
        return float(os.environ.get("TPUDL_TRAIN_RESTART_BACKOFF_S",
                                    "") or 0.1)
    except ValueError:
        return 0.1


class TrainContext:
    """What a ``train_fn`` gets instead of the hvd.* globals."""

    def __init__(self, mesh: M.Mesh, checkpoint_dir=None, save_every=100):
        self.mesh = mesh
        self.checkpoint_dir = checkpoint_dir
        self.save_every = save_every
        self.attempt = 0  # restart count, set by the runner

    @property
    def size(self) -> int:
        """The data axis's size (tpudl's ``mesh.shape['data']``)."""
        return self.mesh.size

    @property
    def rank(self) -> int:
        """The process rank."""
        return self.mesh.rank

    @property
    def device(self) -> torch.device:
        """This rank's device: build the model here."""
        return self.mesh.device

    def shard_batch(self, tree):
        return M.shard_batch(tree, self.mesh)

    def replicate(self, tree):
        return M.replicate(tree, self.mesh)

    def checkpoints(self, subdir: str | None = None) -> CheckpointManager | None:
        if self.checkpoint_dir is None:
            return None
        d = self.checkpoint_dir if subdir is None else f"{self.checkpoint_dir}/{subdir}"
        return CheckpointManager(d, save_every=self.save_every)

    def trainer(self, loss_fn, optimizer, **kw) -> "Trainer":
        kw.setdefault("checkpoint_dir", self.checkpoint_dir)
        kw.setdefault("save_every", self.save_every)
        return Trainer(loss_fn, optimizer, mesh=self.mesh, **kw)


class HorovodRunner:
    """``HorovodRunner(np=2).run(train_fn)`` — the reference's public
    training entry point, one process per rank (see the module
    docstring)."""

    def __init__(self, np: int = -1, *, checkpoint_dir: str | None = None,
                 save_every: int = 100, max_restarts: int = 0,
                 device="cuda", retry_policy: RetryPolicy | None = None):
        self._np = int(np)
        self.checkpoint_dir = checkpoint_dir
        self.save_every = save_every
        self.max_restarts = int(max_restarts)
        self.device = device
        # exponential backoff + jitter between re-launches, so a gang
        # dying in a tight loop does not hammer what it depends on
        self.retry_policy = retry_policy or RetryPolicy(
            max_attempts=self.max_restarts + 1,
            backoff_s=_restart_backoff_base_s(), max_backoff_s=30.0,
            transient="all")

    def _ranks(self) -> tuple[int, torch.device, int]:
        if dist.is_initialized():
            raise RuntimeError(
                "HorovodRunner.run creates and destroys its own process "
                "group, and this process already holds one")
        dev = resolve_device(self.device)
        have = (torch.cuda.device_count() if dev.type == "cuda"
                else os.cpu_count() or 1)
        n = abs(self._np) if self._np != 0 else have
        if n > have:
            raise ValueError(
                f"HorovodRunner(np={self._np}) needs {n} devices, have "
                f"{have} ({dev.type})")
        # TPUDL_MESH_MODEL folds the n ranks into a (data, model) grid:
        # np keeps meaning every card, the model axis comes out of it
        n_model = M.model_axis_size()
        if n % n_model:
            raise ValueError(
                f"HorovodRunner(np={self._np}): {n} devices do not "
                f"divide into TPUDL_MESH_MODEL={n_model} model shards")
        if dev.type == "cuda" and n == 1 and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return n, dev, n_model

    def run(self, main, **kwargs):
        """Run ``main(ctx, **kwargs)`` on every rank and return rank 0's
        result; on a transient exception, relaunch every rank up to
        ``max_restarts`` times (gang restart — ``main`` resumes from its
        checkpoints; ``Trainer`` does)."""
        n, dev, n_model = self._ranks()
        attempt = 0
        while True:
            try:
                with _obs_tracer.span("train.run", attempt=attempt,
                                      mesh_size=n):
                    return self._launch(n, dev, n_model, main, kwargs,
                                        attempt)
            except Exception as e:
                if is_fatal(e) or not self.retry_policy.is_transient(e):
                    # a Preempted unwind, or a permanent failure, is an
                    # orderly stop: restarting would fight the caller
                    raise
                attempt += 1
                # the cause and the step the gang died at go into the
                # black box: exhaustion then explains why, not how often
                last_step = _obs_metrics.gauge("train.last_step").value
                _obs_flight.get_recorder().record_restart(
                    attempt, e, step=last_step,
                    max_restarts=self.max_restarts)
                if attempt > self.max_restarts:
                    _obs_flight.record_error(
                        "train.exhausted", e, attempts=attempt,
                        max_restarts=self.max_restarts, step=last_step)
                    raise RestartsExhausted(attempt, e) from e
                _obs_metrics.counter("train.restarts").inc()
                self.retry_policy.record("train.restart", e,
                                         attempt=attempt)
                delay = self.retry_policy.backoff_s(attempt)
                _obs_metrics.histogram(
                    "train.restart_backoff_s").observe(delay)
                log.warning(
                    "train_fn failed (%s: %s); gang restart %d/%d from "
                    "the last checkpoint in %.2fs", type(e).__name__, e,
                    attempt, self.max_restarts, delay)
                if delay > 0:
                    # tpudl: ignore[adhoc-retry] — the pacing COMES
                    # from the shared RetryPolicy (recorded above);
                    # this sleep is the gang-restart boundary itself
                    time.sleep(delay)

    def _launch(self, n, dev, n_model, main, kwargs, attempt):
        with tempfile.TemporaryDirectory(prefix="tpudl-rdzv-") as tmp:
            spec = {"world": n, "model": n_model, "device": dev,
                    "init": "file://" + os.path.join(tmp, "rendezvous"),
                    "checkpoint_dir": self.checkpoint_dir,
                    "save_every": self.save_every, "attempt": attempt}
            if n > 1:
                return _spawn(spec, main, kwargs)
            try:
                return _run_rank(0, spec, main, kwargs)
            finally:
                if dist.is_initialized():
                    dist.destroy_process_group()


def _run_rank(rank: int, spec: dict, main, kwargs):
    """One rank: join the group, build its grid (every launch makes its
    sub-groups anew) and run ``main(ctx, **kwargs)``; the caller leaves
    the group."""
    dev = spec["device"]
    if dev.type == "cuda" and spec["world"] > 1:
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    D.initialize(spec["init"], spec["world"], rank,
                 backend="nccl" if dev.type == "cuda" else "gloo")
    mesh = M.build_mesh(spec["world"] // spec["model"], spec["model"],
                        device=dev)
    ctx = TrainContext(mesh, spec["checkpoint_dir"], spec["save_every"])
    ctx.attempt = spec["attempt"]
    with M.use_mesh(mesh):
        return main(ctx, **kwargs)


def _pickled_failure(rank: int, exc: BaseException) -> bytes:
    """``exc`` pickled, with the rank's traceback in a note; an exception
    that does not survive pickling becomes a RuntimeError naming it."""
    exc.add_note(f"raised on rank {rank}:\n"
                 + "".join(traceback.format_exception(exc)))
    try:
        data = pickle.dumps(exc)
        pickle.loads(data)
        return data
    except Exception:
        return pickle.dumps(RuntimeError(
            f"rank {rank}: {type(exc).__name__}: {exc}\n"
            + "".join(traceback.format_exception(exc))))


def _rank_entry(rank: int, spec: dict, main, kwargs, results):
    """A spawned rank: its result (rank 0's; the others send None) or its
    exception goes back pickled, stamped with the time it ended. The rank
    leaves the group only after that, so a sibling's error about the lost
    connection comes later than the failure that caused it."""
    try:
        result = _run_rank(rank, spec, main, kwargs)
        out = ("ok", rank, time.time(),
               pickle.dumps(result if rank == 0 else None))
    except BaseException as e:  # every failure goes back to the runner
        out = ("err", rank, time.time(), _pickled_failure(rank, e))
    try:
        results.put(out)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _earliest_failure(done: dict):
    """The exception of the rank that failed first, or None. ``done`` maps
    a rank to ``(kind, time, pickled payload)``; ranks that failed in the
    same clock tick are taken in rank order (exceptions do not compare)."""
    failures = sorted((at, rank) for rank, (kind, at, _) in done.items()
                      if kind == "err")
    if not failures:
        return None
    return pickle.loads(done[failures[0][1]][2])


def _spawn(spec: dict, main, kwargs):
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_entry, name=f"tpudl-rank-{r}",
                         args=(r, spec, main, kwargs, results))
             for r in range(spec["world"])]
    for p in procs:
        p.start()
    done: dict[int, tuple] = {}
    dead_since: dict[int, float] = {}
    reap_at = None
    try:
        while len(done) < len(procs):
            try:
                kind, rank, at, payload = results.get(timeout=0.5)
                done[rank] = (kind, at, payload)
                if kind == "err" and reap_at is None:
                    reap_at = time.monotonic() + _REAP_GRACE_S
                continue
            except queue.Empty:
                pass
            now = time.monotonic()
            for r, p in enumerate(procs):
                if r in done or p.exitcode is None:
                    continue
                # a rank that exited without a word (killed, or crashed
                # in native code); its message may still be in the pipe
                if now - dead_since.setdefault(r, now) > 2.0:
                    done[r] = ("err", time.time(), pickle.dumps(
                        RuntimeError(f"rank {r} exited with code "
                                     f"{p.exitcode} without a result")))
                    if reap_at is None:
                        reap_at = now + _REAP_GRACE_S
            if reap_at is not None and now > reap_at:
                break
    finally:
        for p in procs:
            p.join(timeout=5.0)
            if p.is_alive():
                p.terminate()
                p.join()
    failure = _earliest_failure(done)
    if failure is not None:
        raise failure
    if len(done) < len(procs):
        raise RuntimeError(
            f"ranks {sorted(set(range(len(procs))) - set(done))} gave no "
            "result")
    return pickle.loads(done[0][2])


class Trainer:
    """Step loop: host batches → the model's device (this rank's rows under
    a mesh) → one train step, with checkpoints, resume and throughput
    metrics.

    ``loss_fn(model, *batch)`` is the batch-mean loss (for example
    ``TinyCausalLM.loss_fn()``); ``optimizer`` is a factory ``params ->
    torch.optim.Optimizer`` (:mod:`tpudl_torch.train.optim`).
    ``data_fn(step) -> array or tuple of arrays`` (the global batch) must
    be stateless in ``step``, which makes the data cursor exactly the step
    counter — resume is then correct by construction. An array is host
    numpy, or a tensor (a ``Dataset``'s batch resident on the card, fed as
    it is: ``.to`` the model's device copies nothing when it is there
    already, as tpudl's ``device_put`` of a device array)."""

    def __init__(self, loss_fn, optimizer, *, mesh: M.Mesh | None = None,
                 checkpoint_dir=None, save_every: int = 100,
                 log_every: int = 0, param_shardings=None):
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.mesh = mesh
        self.checkpoint_dir = checkpoint_dir
        self.save_every = save_every
        self.log_every = log_every
        self.history: list[dict] = []
        self.param_shardings = param_shardings
        self._step_fn = make_train_step(loss_fn, mesh=mesh,
                                        param_shardings=param_shardings)

    # -- the group ---------------------------------------------------------
    @property
    def _group(self):
        """The process-group mesh, or None (no mesh, or a local one)."""
        return None if self.mesh is None or self.mesh.local else self.mesh

    @property
    def _primary(self) -> bool:
        return self._group is None or self._group.rank == 0

    @property
    def _ranks(self) -> int:
        return 1 if self._group is None else self._group.world

    @property
    def _whole_batch(self) -> bool:
        """Whether every rank takes the whole batch (a ring loss)."""
        return getattr(self.loss_fn, "whole_batch", False)

    def _agreed(self, flag: bool, device) -> bool:
        """``flag`` if any rank raised it (ranks must stop together)."""
        if self._ranks == 1:
            return flag
        t = torch.tensor([float(flag)], device=device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.mesh.group)
        return bool(t.item())

    # -- checkpoints -------------------------------------------------------
    def _restore(self, model, optimizer) -> tuple[CheckpointManager, int]:
        """Rank 0 restores first (dropping corrupt steps), then the
        others read the same directory; returns (manager, first step)."""
        def restore():
            mgr = CheckpointManager(self.checkpoint_dir,
                                    save_every=self.save_every)
            t_ck = time.perf_counter()
            state = mgr.restore()
            if state is None:
                return mgr, 0
            _load_state(model, optimizer, state, self.mesh)
            _obs_metrics.histogram(
                "train.checkpoint_restore_seconds").observe(
                    time.perf_counter() - t_ck)
            return mgr, int(state["step"])

        if self._primary:
            mgr, start = restore()
        if self._ranks > 1:
            M.barrier(self.mesh)
        if not self._primary:
            mgr, start = restore()
        if self._ranks > 1:
            steps = torch.tensor([start, -start],
                                 device=self.mesh.device)
            dist.all_reduce(steps, op=dist.ReduceOp.MAX,
                            group=self.mesh.group)
            if steps.tolist() != [start, -start]:
                raise RuntimeError(
                    f"ranks resumed from different steps (this rank "
                    f"{start}; the newest {int(steps[0])}, the oldest "
                    f"{-int(steps[1])})")
        if start:
            log.info("resumed from checkpoint at step %d", start)
        return mgr, start

    def _save(self, mgr, step, model, optimizer, *, force=False) -> bool:
        if not force and (mgr.save_every <= 0 or step % mgr.save_every):
            return False
        # split leaves are gathered over each row: all its ranks take part
        if self._primary or _split_parameters(model):
            t_ck = time.perf_counter()
            state = _state(model, optimizer, step, self.mesh)
            if self._primary:
                mgr.save(step, state, force=True)
                _obs_metrics.histogram(
                    "train.checkpoint_save_seconds").observe(
                        time.perf_counter() - t_ck)
        if self._ranks > 1:
            M.barrier(self.mesh)  # the step is on disk for every rank
        return True

    # -- the loop ----------------------------------------------------------
    def fit(self, model, data_fn, steps: int, *, opt_state=None, stop=None):
        """Train ``model`` (an ``nn.Module``, in place) for ``steps`` total
        steps, resumed ones included. Returns ``(model, optimizer,
        history)``; pass the optimizer back as ``opt_state`` to continue
        with its state.

        ``history`` gets ``{"step", "loss", "examples_per_sec"}`` every
        ``log_every`` steps (each such entry reads the loss — the group
        mean — back from the device) and after the last step if that one
        was not logged; ``examples_per_sec`` counts the global batch.
        ``stop`` (optional zero-arg callable → bool) is polled before
        every step (under a mesh, any rank's stop stops all); when it
        turns truthy ``fit`` force-saves a checkpoint at the current step
        (when a ``checkpoint_dir`` is set) and raises
        :class:`Preempted`."""
        self.history = []  # per-fit; stale entries would misreport results
        if self.param_shardings is not None and opt_state is None:
            model.shard_params(_layout_mesh(self.param_shardings))
        optimizer = (opt_state if opt_state is not None
                     else self.optimizer(model.parameters()))
        device = next(model.parameters()).device
        if self._group is not None:
            if device != self.mesh.device:
                raise ValueError(
                    f"the model is on {device}, this rank's device is "
                    f"{self.mesh.device} (build it on ctx.device)")
            split = {id(p) for p, _ in _split_parameters(model)}
            held = [p for g in optimizer.param_groups for p in g["params"]
                    if opt_state is not None and p in optimizer.state]
            for axis, keep in ((None, False), (M.DATA_AXIS, True)):
                # whole leaves from rank 0; split ones down their column
                if axis is None or split:
                    M.replicate(
                        [t for t in (*model.parameters(), *model.buffers())
                         if (id(t) in split) == keep]
                        + [optimizer.state[p] for p in held
                           if (id(p) in split) == keep], self.mesh, axis)
        start, mgr = 0, None
        if self.checkpoint_dir is not None:
            mgr, start = self._restore(model, optimizer)
        t0 = time.perf_counter()
        examples = 0
        executed = 0
        loss = None
        # per-step host loop time: the step does not wait for the card,
        # so this is the dispatch cadence; examples_per_sec in history is
        # the wall-clock rate
        step_hist = _obs_metrics.histogram("train.step_seconds")
        step_gauge = _obs_metrics.gauge("train.last_step")
        # one beat a step: a wedged data_fn or a hung dispatch flags a
        # stall naming the step it froze at
        hb = _obs_watchdog.heartbeat("train.fit", steps=steps, start=start)
        try:
            for step in range(start, steps):
                if stop is not None and self._agreed(bool(stop()), device):
                    # checkpoint-then-exit: the state BEFORE this step is
                    # saved at `step`, so a relaunch redoes nothing
                    if mgr is not None:
                        self._save(mgr, step, model, optimizer, force=True)
                    raise Preempted(step, saved=mgr is not None)
                # step and examples ride the beat: obs top shows training
                # progress from the heartbeat's info
                hb.beat(step=step, examples=examples)
                # the fault point of the preemption tests: a FaultPlan
                # can send SIGTERM or raise at an exact step
                _faults.fire("train.step", step=step)
                t_step = time.perf_counter()
                batch = data_fn(step)
                if not isinstance(batch, tuple):
                    batch = (batch,)
                rows = int(np.shape(batch[0])[0])
                if self._group is not None and not self._whole_batch:
                    batch = M.shard_batch(batch, self.mesh)
                else:
                    batch = tuple(_as_tensor(b).to(device) for b in batch)
                loss = self._step_fn(model, optimizer, *batch)
                step_hist.observe(time.perf_counter() - t_step)
                step_gauge.set(step + 1)
                executed += 1
                examples += rows
                # training rows consumed under the caller's scope (fit
                # runs on the calling thread, so no carry is needed)
                _attr.charge("rows_in", rows)
                done = step + 1
                if mgr is not None and done < steps:
                    self._save(mgr, done, model, optimizer)
                if self.log_every and done % self.log_every == 0:
                    self._record(done, loss, examples, t0)
            if loss is not None and (not self.history
                                     or self.history[-1]["step"] != steps):
                self._record(steps, loss, examples, t0)
            if mgr is not None and steps > start:
                self._save(mgr, steps, model, optimizer, force=True)
        finally:
            hb.__exit__(None, None, None)
            _obs_metrics.counter("train.steps").inc(executed)
            _obs_metrics.counter("train.examples").inc(examples)
        return model, optimizer, self.history

    def _record(self, step, loss, examples, t0):
        if self._ranks > 1:
            loss = loss.clone()
            M.all_reduce_mean([loss], self.mesh)
        value = float(loss)  # waits for the card: the logged step is done
        rate = examples / max(time.perf_counter() - t0, 1e-9)
        self.history.append({"step": step, "loss": value,
                             "examples_per_sec": rate})
        log.info("step %d loss %.5f (%.1f ex/s)", step, value, rate)


def _as_tensor(b) -> torch.Tensor:
    """One batch array as a tensor: a tensor as it is, anything else
    through numpy (bfloat16 bits as ``torch.bfloat16``)."""
    if isinstance(b, torch.Tensor):
        return b
    from tpudl_torch.data.codec import host_tensor

    return host_tensor(np.asarray(b))


def _state(model, optimizer, step: int, mesh=None) -> dict:
    """The checkpointed state: the module's ``state_dict``, the tensors of
    the optimizer's per-parameter state, and the step. The leaves that a
    process group's layout splits over the model axis
    (``split_parameters``), and the optimizer's tensors shaped like them,
    come whole, gathered over ``mesh``'s row: every rank of it calls
    this, as tpudl's single-host save gathers its sharded arrays."""
    whole = _Split(model, mesh).whole
    order = [p for g in optimizer.param_groups for p in g["params"]]
    named = dict(model.named_parameters())
    opt = {str(i): {k: whole(v, order[i]) for k, v in s.items()
                    if isinstance(v, torch.Tensor)}
           for i, s in optimizer.state_dict()["state"].items()}
    return {"params": {n: whole(t, named.get(n))
                       for n, t in model.state_dict().items()},
            "opt_state": {"state": opt},
            "step": np.asarray(step, np.int64)}


def _split_parameters(model) -> list:
    """``[(param, dim)]`` of a model laid out over a process group's model
    axis (``TinyCausalLM.split_parameters``); empty for any other."""
    return getattr(model, "split_parameters", list)()


class _Split:
    """A model's split leaves over ``mesh``'s model axis: :meth:`whole`
    gathers a tensor shaped like a split parameter over the row,
    :meth:`mine` takes this rank's slice of one shaped like the whole
    parameter; anything else passes as it is."""

    def __init__(self, model, mesh):
        self.dims = {id(p): d for p, d in _split_parameters(model)}
        if self.dims:
            self.row = mesh.axis_group(M.MODEL_AXIS)
            self.m = mesh.shape[M.MODEL_AXIS]
            self.j = mesh.axis_index(M.MODEL_AXIS)

    def whole(self, t, p):
        d = self.dims.get(id(p))
        if d is None or t.shape != p.shape:
            return t
        return C.all_gather(t.detach(), self.row, d)

    def mine(self, t, p):
        d = self.dims.get(id(p))
        if d is None or t.dim() != p.dim() or t.shape[d] == p.shape[d]:
            return t
        return t.chunk(self.m, dim=d)[self.j].contiguous()


def _load_state(model, optimizer, state: dict, mesh=None) -> None:
    """Load a restored :func:`_state` tree into ``model`` and
    ``optimizer`` (bit for bit: every tensor keeps its saved dtype; a
    split leaf and its optimizer state take this rank's slice on
    ``mesh``)."""
    mine = _Split(model, mesh).mine
    own = model.state_dict()
    named = dict(model.named_parameters())
    params = state.get("params", {})
    if sorted(params) != sorted(own):
        raise ValueError(
            f"checkpoint params {sorted(params)[:4]}... do not match the "
            f"model's {sorted(own)[:4]}...")
    with torch.no_grad():
        for name, t in own.items():
            t.copy_(mine(params[name], named.get(name)))
    order = [p for g in optimizer.param_groups for p in g["params"]]
    saved = state.get("opt_state", {}).get("state", {})
    optimizer.load_state_dict({
        "state": {int(i): {k: mine(v, order[int(i)]) for k, v in s.items()}
                  for i, s in saved.items()},
        "param_groups": optimizer.state_dict()["param_groups"]})
