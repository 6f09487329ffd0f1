"""JobRuntime: preemption-survivable execution of one JobSpec.

Port of ``tpudl/jobs/runtime.py``. It binds the checkpoint manager
(:mod:`tpudl_torch.train.checkpoint`), the prepared-batch caches
(:mod:`tpudl_torch.data`), the flight recorder
(:mod:`tpudl_torch.obs.flight`) and the trial scheduler
(:mod:`tpudl_torch.ml.hpo`) into a runtime where a SIGTERM is a recovery
event:

- ``JobRuntime(spec).run(fn)`` runs ``fn(ctx)`` with a persistent
  **resume manifest** (``job-manifest.json`` in the spec's workdir, in
  tpudl's schema and version, written tmp + ``os.replace``): the
  checkpoint pointer, the data cursor and the trial ledger;
- on **SIGTERM** the runtime sets a stop flag; the run reaches its next
  step, batch or trial boundary, checkpoints, persists the cursor, writes
  a ``preempted_resumable`` flight dump into the workdir (tpudl's ``obs
  doctor`` classifies it so) and exits with ``RC_PREEMPTED`` (75,
  EX_TEMPFAIL) under ``run(..., exit_on_preempt=True)``. While a job
  runs, its handler holds SIGTERM (the flight recorder's handler, when
  :func:`~tpudl_torch.obs.flight.install` put one there, is the one it
  takes over from and gives back after the run): the kill is a
  checkpoint, not a death, and the recorder's dump is written at the
  boundary with the manifest's pointer;
- a relaunched runtime over the SAME spec picks up the cursor and the
  checkpoint, with at most ``save_every`` train steps and one batch of
  data preparation reworked; a workdir that another fingerprint wrote,
  or a relaunch on another mesh topology, is refused;
- on a resume with ``TPUDL_COMPILE_AOT`` armed, the program store's
  ``warm_start(block=True)`` captures the manifest's signatures before
  the first dispatch.

:meth:`JobRuntime.run_fit` drives ``Trainer.fit``, which trains the
module in place in the port: it takes the module where tpudl takes
``params``.
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time

from tpudl_torch.jobs.spec import JobSpec
from tpudl_torch.testing import tsan as _tsan

__all__ = ["JobRuntime", "JobContext", "JobPreempted", "RC_PREEMPTED",
           "MANIFEST_NAME", "MANIFEST_SCHEMA", "MANIFEST_VERSION",
           "load_manifest"]

RC_PREEMPTED = 75  # EX_TEMPFAIL: preempted but resumable — re-run me
MANIFEST_NAME = "job-manifest.json"
MANIFEST_SCHEMA = "tpudl-job-manifest"
MANIFEST_VERSION = 1

STATUSES = ("running", "preempted", "done", "failed")


# copied from tpudl/jobs/runtime.py:JobPreempted
class JobPreempted(Exception):
    """The run was preempted at a safe boundary; its resume state is
    persisted in ``manifest_path``. Marked ``tpudl_fatal``: no retry
    layer may swallow a preemption."""

    tpudl_fatal = True

    def __init__(self, manifest_path: str, cursor: dict):
        super().__init__(
            f"job preempted at cursor {cursor}; resume state in "
            f"{manifest_path} (relaunch the same JobSpec to resume)")
        self.manifest_path = manifest_path
        self.cursor = dict(cursor)
        self.rc = RC_PREEMPTED


# copied from tpudl/jobs/runtime.py:load_manifest
def load_manifest(workdir: str) -> dict | None:
    """The resume manifest in ``workdir``, or None (absent/unreadable
    — a torn manifest write cannot happen by construction, but a
    foreign file can)."""
    path = os.path.join(workdir, MANIFEST_NAME)
    try:
        with open(path) as f:
            m = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    if isinstance(m, dict) and m.get("schema") == MANIFEST_SCHEMA:
        return m
    return None


# copied from tpudl/jobs/runtime.py:JobContext
class JobContext:
    """What a job payload gets: the persisted cursor/ledger + the stop
    flag, all backed by the atomic manifest."""

    def __init__(self, runtime: "JobRuntime", manifest: dict):
        self._rt = runtime
        self.spec = runtime.spec
        self.workdir = runtime.spec.workdir
        self.checkpoint_dir = os.path.join(self.workdir, "checkpoints")
        self.manifest = manifest

    # -- stop flag ---------------------------------------------------------
    def stop_requested(self) -> bool:
        return self._rt._stop.is_set()

    def request_stop(self):
        """Programmatic preemption (tests; cooperative schedulers)."""
        self._rt._stop.set()

    # -- checkpoints -------------------------------------------------------
    def checkpoints(self, save_every: int | None = None):
        from tpudl_torch.train.checkpoint import CheckpointManager

        return CheckpointManager(
            self.checkpoint_dir,
            save_every=save_every if save_every is not None
            else self.spec.save_every)

    # -- cursor ------------------------------------------------------------
    @property
    def cursor(self) -> dict:
        return dict(self.manifest.get("cursor") or {})

    def update_cursor(self, **fields):
        cur = self.manifest.setdefault("cursor", {})
        cur.update({k: int(v) for k, v in fields.items()})
        self._rt._persist()

    def set_bounds(self, **fields):
        """Dataset/step bounds for the manifest audit
        (tools/validate_job.py: cursor ≤ bounds)."""
        b = self.manifest.setdefault("bounds", {})
        b.update({k: int(v) for k, v in fields.items()})
        self._rt._persist()

    # -- trial ledger ------------------------------------------------------
    def trials_done(self) -> set[int]:
        return {int(k) for k in
                (self.manifest.get("trials") or {}).get("done", {})}

    def mark_trial_started(self, index: int):
        t = self.manifest.setdefault(
            "trials", {"done": {}, "in_flight": [], "pending": []})
        if int(index) not in t["in_flight"]:
            t["in_flight"].append(int(index))
        if int(index) in t["pending"]:
            t["pending"].remove(int(index))
        self._rt._persist()

    def mark_trial_done(self, index: int, **meta):
        t = self.manifest.setdefault(
            "trials", {"done": {}, "in_flight": [], "pending": []})
        t["done"][str(int(index))] = {"ts": time.time(), **meta}
        if int(index) in t["in_flight"]:
            t["in_flight"].remove(int(index))
        if int(index) in t["pending"]:
            t["pending"].remove(int(index))
        self._rt._persist()

    def set_trials_pending(self, indices):
        t = self.manifest.setdefault(
            "trials", {"done": {}, "in_flight": [], "pending": []})
        t["pending"] = [int(i) for i in indices
                        if str(int(i)) not in t["done"]]
        self._rt._persist()

    # -- data-plane helpers ------------------------------------------------
    def iter_batches(self, dataset, epochs: int):
        """Resume-aware epoch iteration over a :class:`tpudl_torch.data.
        Dataset`: yields ``(epoch, batch_index, batch)`` starting at
        the persisted cursor, advancing it after every yielded batch
        (rework on preemption: ≤ 1 batch of data prep). With the
        dataset's ``cache_dir`` set, batches prepared before the kill
        replay from the shard cache — zero re-decodes past the
        cursor."""
        cur = self.cursor
        e0, b0 = int(cur.get("epoch", 0)), int(cur.get("batch", 0))
        nb = dataset.num_batches
        self.set_bounds(epochs=epochs, batches_per_epoch=nb)
        for epoch in range(e0, int(epochs)):
            for b in range(b0 if epoch == e0 else 0, nb):
                if self.stop_requested():
                    self.update_cursor(epoch=epoch, batch=b)
                    raise self._rt._preempted()
                yield epoch, b, dataset.get_batch(b)
                self.update_cursor(epoch=epoch, batch=b + 1)
        self.update_cursor(epoch=int(epochs), batch=0)

    def run_trials(self, items, trial_fn, *, scheduler=None, retry=None):
        """Resume-aware trial sweep: already-done trials (per the
        ledger) are skipped; fresh ones run on the
        :class:`~tpudl_torch.ml.hpo.TrialScheduler` and are marked done as
        they complete. Yields ``(index, result)`` for FRESH trials only
        (completed ones have no recreatable result object — their
        artifacts are the caller's, keyed by index)."""
        from tpudl_torch.ml.hpo import TrialScheduler

        items = list(items)
        done = self.trials_done()
        todo = [(i, it) for i, it in enumerate(items) if i not in done]
        self.set_bounds(trials=len(items))
        self.set_trials_pending([i for i, _ in todo])
        if not todo:
            return
        mapping = [i for i, _ in todo]
        sched = scheduler or TrialScheduler()

        def wrapped(j, item, devs):
            # in_flight marks trials that actually STARTED (here, in
            # the scheduler's worker), not everything queued: a kill
            # mid-sweep leaves a ledger an operator can read literally
            self.mark_trial_started(mapping[j])
            return trial_fn(mapping[j], item, devs)

        for j, res in sched.run([it for _, it in todo], wrapped,
                                retry=retry):
            i = mapping[j]
            self.mark_trial_done(i)
            yield i, res
            if self.stop_requested():
                raise self._rt._preempted()


class JobRuntime:
    """Run a JobSpec with persistent resume state (module docstring)."""

    # copied from tpudl/jobs/runtime.py:JobRuntime.__init__
    def __init__(self, spec: JobSpec, *, install_signals: bool = True):
        self.spec = spec
        self._install_signals = bool(install_signals)
        self._stop = threading.Event()
        self._lock = _tsan.named_lock("jobs.runtime.manifest")
        self._manifest: dict | None = None
        self._prev_sigterm = None
        # device topology this attempt runs on ({axis: size}, {} =
        # single-card, None = unknown); seeded from the spec, refined
        # by run_fit from its Trainer's mesh. _begin records it in the
        # manifest and refuses a resume whose topology CHANGED.
        self._mesh_axes = spec.mesh_axes

    # -- manifest persistence ---------------------------------------------
    # copied from tpudl/jobs/runtime.py:JobRuntime.manifest_path
    def manifest_path(self) -> str:
        return os.path.join(self.spec.workdir, MANIFEST_NAME)

    # copied from tpudl/jobs/runtime.py:JobRuntime._persist
    def _persist(self):
        with self._lock:
            m = self._manifest
            if m is None:
                return
            m["updated_ts"] = time.time()
            tmp = self.manifest_path() + f".tmp.{os.getpid()}"
            try:
                with open(tmp, "w") as f:
                    json.dump(m, f)
                os.replace(tmp, self.manifest_path())
            except OSError:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass

    # copied from tpudl/jobs/runtime.py:JobRuntime._begin
    def _begin(self) -> JobContext:
        os.makedirs(self.spec.workdir, exist_ok=True)
        prev = load_manifest(self.spec.workdir)
        fp = self.spec.fingerprint()
        if prev is not None and prev.get("fingerprint") != fp:
            raise ValueError(
                f"workdir {self.spec.workdir} holds resume state for a "
                f"DIFFERENT job (manifest fingerprint "
                f"{str(prev.get('fingerprint'))[:12]} != spec {fp[:12]}); "
                "refusing to resume foreign state — use a fresh workdir")
        # topology guard: a sharded checkpoint resumed on a
        # different mesh would be silently RESHARDED (CheckpointManager
        # restores with like=); a smaller mesh may not even hold it.
        # Both sides must KNOW their topology for the check to fire —
        # run_fit always does (it reads the Trainer's mesh).
        prev_mesh = prev.get("mesh") if prev is not None else None
        if (prev is not None and prev_mesh is not None
                and self._mesh_axes is not None
                and prev_mesh != self._mesh_axes):
            raise ValueError(
                f"workdir {self.spec.workdir} was checkpointed on mesh "
                f"topology {prev_mesh} but this relaunch runs on "
                f"{self._mesh_axes}; refusing to silently reshard the "
                "resume state — relaunch on the original topology, or "
                "start a fresh workdir to retrain on the new one")
        m = prev or {
            "schema": MANIFEST_SCHEMA, "version": MANIFEST_VERSION,
            "fingerprint": fp, "kind": self.spec.kind,
            "name": self.spec.name, "save_every": self.spec.save_every,
            "created_ts": time.time(), "attempt": 0,
            "cursor": {}, "bounds": {},
            "trials": {"done": {}, "in_flight": [], "pending": []},
            "checkpoint": {"dir": "checkpoints", "step": None},
        }
        if self._mesh_axes is not None:
            # record (or backfill — a pre-topology manifest learns its
            # mesh on the first attempt that knows it) the topology the
            # guard above compares against
            m["mesh"] = self._mesh_axes
        m["attempt"] = int(m.get("attempt", 0)) + 1
        m["status"] = "running"
        m["pid"] = os.getpid()
        try:
            from tpudl_torch import compile as _compile

            if _compile.aot_enabled():
                # warm restart: record the program store this job
                # captures into, and on a RESUME capture the manifest's
                # signatures before the payload's first dispatch, so a
                # relaunched job does not pay its captures again
                m["program_store"] = _compile.store_dir()
                if prev is not None:
                    restored = _compile.warm_start(block=True)
                    from tpudl_torch.obs import flight as _flight

                    _flight.get_recorder().record_event(
                        "job.aot_warm_start", restored=restored,
                        store=m["program_store"])
        # tpudl: ignore[swallowed-except] — the warm start is an
        # accelerator: a broken/foreign store must never block a
        # resume (the run just captures cold)
        except Exception:
            pass
        self._manifest = m
        self._persist()
        try:
            from tpudl_torch.obs import flight as _flight

            _flight.get_recorder().record_event(
                "job.start", job_kind=self.spec.kind,
                name=self.spec.name, fingerprint=fp[:12],
                attempt=m["attempt"], resumed=prev is not None,
                manifest=self.manifest_path())
        # tpudl: ignore[swallowed-except] — guards the job.start
        # breadcrumb itself; the run must start regardless
        except Exception:
            pass
        return JobContext(self, m)

    # -- signals -----------------------------------------------------------
    # copied from tpudl/jobs/runtime.py:JobRuntime._arm_sigterm
    def _arm_sigterm(self):
        if not self._install_signals:
            return
        try:
            self._prev_sigterm = signal.getsignal(signal.SIGTERM)

            def handler(signum, frame):
                # graceful path: flag only — the run checkpoints at its
                # next boundary and exits RC_PREEMPTED itself. NOT
                # chained to the flight recorder's kill handler: this
                # is a recovery event, and the recorder's own dump is
                # written (with the manifest pointer) at that boundary.
                # NOTHING else happens here: touching the recorder (or
                # any lock) from signal context can deadlock against
                # the interrupted frame — the flight module's own dump
                # contract; the job.preempted breadcrumb is recorded at
                # the boundary, on a normal thread.
                self._stop.set()

            signal.signal(signal.SIGTERM, handler)
        except (ValueError, OSError):  # not the main thread
            self._prev_sigterm = None

    # copied from tpudl/jobs/runtime.py:JobRuntime._disarm_sigterm
    def _disarm_sigterm(self):
        if self._prev_sigterm is not None:
            try:
                signal.signal(signal.SIGTERM, self._prev_sigterm)
            except (ValueError, OSError):
                pass
            self._prev_sigterm = None

    # -- finalization ------------------------------------------------------
    # copied from tpudl/jobs/runtime.py:JobRuntime._refresh_checkpoint_pointer
    def _refresh_checkpoint_pointer(self):
        m = self._manifest
        try:
            from tpudl_torch.train.checkpoint import CheckpointManager

            ckpt_dir = os.path.join(self.spec.workdir, "checkpoints")
            if os.path.isdir(ckpt_dir):
                step = CheckpointManager(
                    ckpt_dir, save_every=self.spec.save_every
                ).latest_step()
                m["checkpoint"] = {"dir": "checkpoints", "step": step}
        except Exception as e:
            # a stale pointer is recoverable (restore falls back to the
            # newest VALID step) but the WHY belongs in the black box —
            # an unreadable checkpoint dir here is early evidence
            try:
                from tpudl_torch.obs import flight as _flight

                _flight.record_error("job.checkpoint_pointer", e,
                                     workdir=self.spec.workdir)
            # tpudl: ignore[swallowed-except] — guards the breadcrumb
            # itself; pointer refresh stays best-effort either way
            except Exception:
                pass

    # copied from tpudl/jobs/runtime.py:JobRuntime._preempted
    def _preempted(self) -> JobPreempted:
        """Finalize preempted state → the JobPreempted to raise."""
        m = self._manifest
        m["status"] = "preempted"
        self._refresh_checkpoint_pointer()
        self._persist()
        try:
            from tpudl_torch.obs import flight as _flight

            _flight.get_recorder().record_event(
                "job.preempted", manifest=self.manifest_path(),
                fingerprint=m.get("fingerprint", "")[:12],
                cursor=json.dumps(m.get("cursor") or {}),
                attempt=m.get("attempt"))
            # the black box lands IN the workdir: `obs doctor <workdir>`
            # then classifies this death as preempted_resumable (the
            # dump carries the manifest pointer via the event above)
            _flight.dump(
                reason="preempted_resumable",
                path=os.path.join(self.spec.workdir,
                                  f"tpudl-dump-{os.getpid()}.json.gz"))
        # tpudl: ignore[swallowed-except] — forensics must never block
        # the preemption exit path; the manifest (already persisted
        # above) is the resume contract, the dump is evidence
        except Exception:
            pass
        return JobPreempted(self.manifest_path(), m.get("cursor") or {})

    # -- entry points ------------------------------------------------------
    # copied from tpudl/jobs/runtime.py:JobRuntime.run
    def run(self, fn, *, exit_on_preempt: bool = False):
        """Execute ``fn(ctx)`` under the resume contract. On preemption:
        manifest + checkpoint persisted, flight dump written, then
        ``JobPreempted`` raised — or, with ``exit_on_preempt`` (the
        process-entry mode the relaunch contract wants), ``SystemExit
        (RC_PREEMPTED)``."""
        ctx = self._begin()
        self._arm_sigterm()
        try:
            from tpudl_torch.train.runner import Preempted as _TrainPreempted

            try:
                result = fn(ctx)
            except JobPreempted:
                raise
            except _TrainPreempted as p:
                # Trainer.fit saw the stop flag and already force-saved
                # at p.step; fold that into the unified cursor
                ctx.update_cursor(step=p.step)
                raise self._preempted() from p
            m = self._manifest
            m["status"] = "done"
            self._refresh_checkpoint_pointer()
            self._persist()
            try:
                from tpudl_torch.obs import flight as _flight

                _flight.get_recorder().record_event(
                    "job.done", manifest=self.manifest_path())
            # tpudl: ignore[swallowed-except] — guards the job.done
            # breadcrumb; the result is already in hand
            except Exception:
                pass
            return result
        except JobPreempted as jp:
            if exit_on_preempt:
                raise SystemExit(jp.rc) from jp
            raise
        except (Exception, KeyboardInterrupt) as e:
            m = self._manifest
            m["status"] = "failed"
            m["error"] = f"{type(e).__name__}: {e}"[:500]
            self._persist()
            try:
                from tpudl_torch.obs import flight as _flight

                _flight.record_error("job.failed", e,
                                     manifest=self.manifest_path())
            # tpudl: ignore[swallowed-except] — guards the job.failed
            # breadcrumb; the re-raise below carries the real error
            except Exception:
                pass
            raise
        finally:
            self._disarm_sigterm()

    def run_fit(self, trainer, model, data_fn, steps: int, *,
                opt_state=None, exit_on_preempt: bool = False):
        """The Trainer adapter. ``trainer`` (a
        :class:`tpudl_torch.train.Trainer`) is pointed at the job's
        checkpoint dir and driven with the runtime's stop flag; the data
        cursor IS the step counter (``data_fn`` is index-addressable by
        the Trainer contract), so one resume state covers model and data.
        In the port's idiom ``Trainer.fit`` trains the module in place,
        so this takes the ``model`` (an ``nn.Module``) where tpudl takes
        ``params``, and returns ``fit``'s ``(model, optimizer,
        history)``. The Trainer's mesh (or its absence) is the attempt's
        topology: the manifest records it, and a relaunch on another
        mesh is refused instead of silently resharding the checkpoint; a
        spec that claims another topology than the Trainer's is refused
        up front."""
        from tpudl_torch.jobs.spec import mesh_axes as _mesh_axes

        tmesh = getattr(trainer, "mesh", None)
        trainer_axes = _mesh_axes(tmesh) if tmesh is not None else {}
        if self._mesh_axes is None:
            self._mesh_axes = trainer_axes
        elif self._mesh_axes != trainer_axes:
            raise ValueError(
                f"JobSpec states mesh topology {self._mesh_axes} but "
                f"the Trainer runs on {trainer_axes}; refusing to "
                "record a topology the run does not use — fix the "
                "spec's mesh= (or omit it: run_fit derives the real "
                "one)")

        def payload(ctx):
            trainer.checkpoint_dir = ctx.checkpoint_dir
            trainer.save_every = self.spec.save_every
            ctx.set_bounds(steps=int(steps))
            out = trainer.fit(model, data_fn, int(steps),
                              opt_state=opt_state,
                              stop=ctx.stop_requested)
            ctx.update_cursor(step=int(steps))
            return out

        return self.run(payload, exit_on_preempt=exit_on_preempt)
