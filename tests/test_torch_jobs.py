"""The job runtime (``tpudl_torch.jobs``) against tpudl's ``tpudl.jobs``.

- ``JobSpec``'s fingerprint and ``to_json`` equal tpudl's for the same
  material, and ``mesh_axes`` of the port's local and process-group
  meshes equals tpudl's for the same axes;
- the acceptance path: ``TinyCausalLM`` (vocab 64, dim 32, 2 heads, 2
  layers, ``init(0)``) trained by ``run_fit`` under adamw in a child
  process (``tests/torch_jobs_fns.py``) that ``kill_at_step(7)`` SIGTERMs
  exits 75 with a ``preempted`` manifest and a flight dump in its
  workdir; the relaunch of the same spec finishes, and its final
  ``state_dict`` is bit for bit the uninterrupted run's. tpudl's own
  ``obs doctor`` reads the port's dump as ``preempted_resumable``, and
  tpudl's ``tools/validate_job.py`` passes the manifest;
- the per-step losses of the port's ``run_fit`` are within 2e-5 of
  tpudl's on the same batches, and the manifest of a job stopped at the
  same step has tpudl's keys, schema, cursor and checkpoint pointer
  (times and pids aside);
- a foreign fingerprint and another mesh topology are refused in
  tpudl's words;
- ``iter_batches`` resumes at the cursor with no re-decode from a
  ``cache_dir``, ``run_trials`` skips done trials, a resume with the
  program store armed warm-starts it, and SIGTERM goes back to the
  flight recorder's handler after a run."""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

import tpudl.jobs as jjobs
from tpudl.jobs import spec as jspec
from tpudl.obs import doctor as jdoctor
from tpudl.train import Trainer as JaxTrainer
from tpudl.zoo.transformer import TinyCausalLM as JaxLM

import torch_jobs_fns as F
from tpudl_torch import jobs
from tpudl_torch import mesh as M
from tpudl_torch.jobs import spec as tspec
from tpudl_torch.obs import flight
from tpudl_torch.testing import faults

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
LOSS_TOL = 2e-5
VOLATILE = ("created_ts", "updated_ts", "pid", "ts")


@pytest.fixture(autouse=True)
def _clean():
    faults.disarm()
    flight.get_recorder().reset()
    yield
    faults.disarm()


def _validator():
    spec = importlib.util.spec_from_file_location(
        "validate_job", REPO / "tools" / "validate_job.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- the spec ----------------------------------------------------------------

MATERIALS = [
    dict(),
    dict(model="TinyCausalLM", knobs={"lr": 3e-4, "steps": 12}),
    dict(knobs={"b": [1, 2.5, None], "a": {"z": True, "y": "s"}},
         extra=(3, "x")),
]


@pytest.mark.parametrize("kind", ["fit", "featurize", "hpo"])
@pytest.mark.parametrize("material", MATERIALS)
def test_spec_fingerprint_and_json_equal_tpudls(tmp_path, kind, material):
    kw = dict(material=tspec.fingerprint_material(**material),
              save_every=7, name="job")
    ours = jobs.JobSpec(kind, str(tmp_path), **kw, mesh={"data": 2})
    theirs = jjobs.JobSpec(kind, str(tmp_path), **dict(
        kw, material=jspec.fingerprint_material(**material)),
        mesh={"data": 2})
    assert ours.material == theirs.material
    assert ours.fingerprint() == theirs.fingerprint()
    assert ours.to_json() == theirs.to_json()
    back = jobs.JobSpec.from_json(ours.to_json())
    assert back.fingerprint() == ours.fingerprint()
    with pytest.raises(ValueError, match="kind must be one of"):
        jobs.JobSpec("train", str(tmp_path))


def test_spec_of_a_frame_equals_tpudls(tmp_path):
    from tpudl.frame import Frame as JaxFrame
    from tpudl_torch.frame import Frame

    cols = {"x": np.arange(12, dtype=np.float32).reshape(6, 2),
            "s": np.array(list("abcdef"), dtype=object)}
    ours = jobs.fingerprint_material(frame=Frame(cols), input_cols=["x", "s"])
    theirs = jjobs.fingerprint_material(frame=JaxFrame(cols),
                                        input_cols=["x", "s"])
    assert ours == theirs


@pytest.mark.parametrize("n_data,n_model", [(1, 1), (2, 1), (2, 2), (1, 4)])
def test_mesh_axes_of_local_and_group_meshes_equal_tpudls(n_data, n_model):
    from jax.sharding import Mesh as JaxMesh

    want = jspec.mesh_axes(JaxMesh(
        np.array(jax.devices("cpu")[:n_data * n_model]).reshape(
            n_data, n_model), ("data", "model")))
    local = M.build_mesh(n_data, n_model, devices=["cpu"] * (n_data * n_model))
    # a group mesh as a rank holds it (its group object aside)
    group = M.Mesh(size=n_data, rank=0, device=torch.device("cpu"),
                   group=object(), n_model=n_model)
    assert tspec.mesh_axes(local) == want
    assert tspec.mesh_axes(group) == want
    assert tspec.mesh_axes(None) is None
    assert tspec.mesh_axes({"model": 2, "data": 1}) == jspec.mesh_axes(
        {"model": 2, "data": 1})


# -- the acceptance path: kill mid-fit, relaunch, bit for bit ---------------

def _child(workdir, out, plan=None, lr=None):
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop(faults.PLAN_ENV, None)
    if plan is not None:
        env[faults.PLAN_ENV] = plan.to_env()
    args = [sys.executable, str(REPO / "tests" / "torch_jobs_fns.py"),
            str(workdir), str(out)] + ([str(lr)] if lr is not None else [])
    return subprocess.run(args, capture_output=True, text=True, env=env,
                          timeout=120)


def _reference():
    """The uninterrupted run, in this process: final state and losses."""
    lm = F.model()
    from tpudl_torch.train import Trainer, adamw

    _, _, hist = Trainer(lm.loss_fn(), adamw(F.LR), log_every=1).fit(
        lm, F.batch, F.STEPS)
    return ({k: v.detach().numpy() for k, v in lm.state_dict().items()},
            [h["loss"] for h in hist])


def test_sigterm_at_step_7_exits_75_and_the_relaunch_is_bit_for_bit(
        tmp_path):
    workdir, out = tmp_path / "job", tmp_path / "out"
    killed = _child(workdir, out, faults.FaultPlan.kill_at_step(7))
    assert killed.returncode == jobs.RC_PREEMPTED, killed.stderr[-1500:]
    assert not os.path.exists(f"{out}.npz")
    m = jobs.load_manifest(str(workdir))
    assert m["status"] == "preempted" and m["attempt"] == 1
    # the stop is seen at the boundary after step 7: checkpoint-then-exit
    assert m["cursor"] == {"step": 8}
    assert m["checkpoint"] == {"dir": "checkpoints", "step": 8}
    assert m["mesh"] == {}
    dumps = sorted(p.name for p in workdir.glob("tpudl-dump-*.json.gz"))
    assert len(dumps) == 1
    merged, diag = jdoctor.diagnose(str(workdir))
    assert diag["classification"] == "preempted_resumable"
    assert str(diag["resume_manifest"]).endswith("job-manifest.json")
    assert any(e.get("kind") == "fault.injected"
               and e.get("action") == "sigterm"
               for d in merged["hosts"].values() for e in d["errors"])

    resumed = _child(workdir, out)
    assert resumed.returncode == 0, resumed.stderr[-1500:]
    final = jobs.load_manifest(str(workdir))
    assert (final["status"], final["attempt"]) == ("done", 2)
    assert final["cursor"] == {"step": 12}
    assert _validator().validate_manifest(str(workdir)) == []
    got = np.load(f"{out}.npz")
    # the relaunch reworked no step: it resumed at the forced save
    assert got["steps"].tolist() == list(range(9, 13))
    want, losses = _reference()
    for k, w in want.items():
        assert np.array_equal(got[f"p.{k}"], w), k
    assert got["losses"].tolist() == losses[8:]

    refused = _child(workdir, out, lr=1e-3)   # another spec, same workdir
    assert refused.returncode != 0
    assert "refusing to resume foreign state" in refused.stderr


def _jax_job(workdir, stop_at=None, **spec_kw):
    """tpudl's ``run_fit`` of the same job; ``stop_at`` requests the stop
    just before that step runs, where ``kill_at_step`` fires."""
    rt = jjobs.JobRuntime(jjobs.JobSpec(
        "fit", str(workdir), material={**F.MATERIAL, "lr": F.LR},
        save_every=F.SAVE_EVERY, **spec_kw), install_signals=False)

    def data_fn(step):
        if step == stop_at:
            rt._stop.set()
        return F.batch(step)

    trainer = JaxTrainer(JaxLM(**F.ARCH).loss_fn(), optax.adamw(F.LR),
                         log_every=1)
    params = jax.tree.map(jnp.asarray, JaxLM(**F.ARCH).init(0))
    return rt, lambda: rt.run_fit(trainer, params, data_fn, F.STEPS)


def _port_job(workdir, stop_at=None, **spec_kw):
    rt, trainer, lm = F.job(str(workdir), install_signals=False, **spec_kw)

    def data_fn(step):
        if step == stop_at:
            rt._stop.set()
        return F.batch(step)

    return rt, lambda: rt.run_fit(trainer, lm, data_fn, F.STEPS)


def _stable(m):
    return {k: v for k, v in m.items() if k not in VOLATILE}


def test_run_fit_losses_and_manifests_match_tpudls(tmp_path):
    _, run = _jax_job(tmp_path / "jax")
    _, _, want = run()
    _, run = _port_job(tmp_path / "port")
    _, _, got = run()
    assert [h["step"] for h in got] == [h["step"] for h in want]
    np.testing.assert_allclose([h["loss"] for h in got],
                               [h["loss"] for h in want], rtol=0,
                               atol=LOSS_TOL)
    assert _stable(jobs.load_manifest(str(tmp_path / "port"))) == _stable(
        jjobs.load_manifest(str(tmp_path / "jax")))

    manifests = {}
    for side, make in (("jax", _jax_job), ("port", _port_job)):
        _, run = make(tmp_path / f"{side}-stopped", stop_at=7)
        with pytest.raises((jobs.JobPreempted, jjobs.JobPreempted)) as ei:
            run()
        assert ei.value.cursor == {"step": 8}
        assert ei.value.rc == 75
        manifests[side] = _stable(jobs.load_manifest(
            str(tmp_path / f"{side}-stopped")))
    assert manifests["port"] == manifests["jax"]
    assert sorted(manifests["port"]) == sorted(
        ["schema", "version", "fingerprint", "kind", "name", "save_every",
         "attempt", "cursor", "bounds", "trials", "checkpoint", "mesh",
         "status"])


def test_foreign_fingerprint_and_other_topology_are_refused_like_tpudl(
        tmp_path):
    msgs = {}
    for side, make in (("jax", _jax_job), ("port", _port_job)):
        workdir = tmp_path / side
        rt, run = make(workdir, mesh={})
        rt._begin()    # a first attempt's manifest, on one card
        other = (jjobs if side == "jax" else jobs).JobSpec(
            "fit", str(workdir), material={"other": 1})
        rt_other = (jjobs if side == "jax" else jobs).JobRuntime(
            other, install_signals=False)
        with pytest.raises(ValueError) as foreign:
            rt_other.run(lambda ctx: None)
        rt2, _ = make(workdir, mesh={"data": 2, "model": 1})
        with pytest.raises(ValueError) as topo:
            rt2.run(lambda ctx: None)
        msgs[side] = [str(e.value).replace(str(workdir), "<workdir>")
                      for e in (foreign, topo)]
    assert msgs["port"] == msgs["jax"]
    assert "refusing to resume foreign state" in msgs["port"][0]
    assert "refusing to silently reshard" in msgs["port"][1]


def test_run_fit_refuses_a_spec_claiming_another_topology(tmp_path):
    rt, run = _port_job(tmp_path / "job", mesh={"data": 2, "model": 1})
    with pytest.raises(ValueError, match="the Trainer runs on {}"):
        run()


# -- data cursor, trial ledger, warm start, signals ------------------------

def test_iter_batches_resumes_at_the_cursor_with_no_redecode(tmp_path):
    from tpudl_torch.data import Dataset
    from tpudl_torch.frame import Frame

    frame = Frame({"x": np.arange(64, dtype=np.float32)})
    prepares = {"n": 0}

    def counting_pack(sl):
        prepares["n"] += 1
        return np.asarray(sl)

    counting_pack.cache_token = "counting-pack-v1"

    def make_ds():
        return Dataset(frame, ["x"], batch_size=8, device="cpu",
                       cache_dir=str(tmp_path / "cache"), pack=counting_pack)

    spec = jobs.JobSpec("featurize", str(tmp_path / "job"),
                        material={"frame": frame.fingerprint(["x"])})

    def first(ctx):
        got = []
        for epoch, b, _ in ctx.iter_batches(make_ds(), epochs=2):
            got.append((epoch, b))
            if (epoch, b) == (0, 4):
                ctx.request_stop()
        return got

    with pytest.raises(jobs.JobPreempted) as ei:
        jobs.JobRuntime(spec, install_signals=False).run(first)
    assert ei.value.cursor == {"epoch": 0, "batch": 5}
    assert prepares["n"] == 5
    assert jobs.load_manifest(spec.workdir)["bounds"] == {
        "epochs": 2, "batches_per_epoch": 8}
    seen = []

    def second(ctx):
        for epoch, b, batch in ctx.iter_batches(make_ds(), epochs=2):
            seen.append((epoch, b, np.asarray(batch[0]).copy()))
        return len(seen)

    assert jobs.JobRuntime(spec, install_signals=False).run(second) == 3 + 8
    assert seen[0][:2] == (0, 5) and seen[-1][:2] == (1, 7)
    # at most one batch of rework, and no re-decode: batches 5..7 prepare
    # once, epoch 1 replays from the shard cache
    assert prepares["n"] == 8
    for epoch, b, x in seen:
        assert np.array_equal(x, np.arange(8 * b, 8 * b + 8, dtype=np.float32))
    assert jobs.load_manifest(spec.workdir)["status"] == "done"
    assert _validator().validate_manifest(spec.workdir) == []


def test_run_trials_skips_done_trials_like_tpudl(tmp_path):
    from tpudl_torch.ml.hpo import TrialScheduler

    spec = jobs.JobSpec("hpo", str(tmp_path / "job"),
                        material={"grid": [1, 2, 3]})
    ran = []

    def trial(i, item, devs):
        ran.append(i)
        return item * 10

    def payload(ctx):
        return sorted(ctx.run_trials(
            [1, 2, 3], trial, scheduler=TrialScheduler(devices=["cpu"])))

    out = jobs.JobRuntime(spec, install_signals=False).run(payload)
    assert out == [(0, 10), (1, 20), (2, 30)] and sorted(ran) == [0, 1, 2]
    ran.clear()

    def again(ctx):
        assert ctx.trials_done() == {0, 1, 2}
        return list(ctx.run_trials([1, 2, 3], trial))

    assert jobs.JobRuntime(spec, install_signals=False).run(again) == []
    assert ran == []
    m = jobs.load_manifest(spec.workdir)
    assert sorted(m["trials"]["done"]) == ["0", "1", "2"]
    assert m["trials"]["in_flight"] == [] and m["trials"]["pending"] == []
    assert _validator().validate_manifest(spec.workdir) == []


def test_a_resume_with_the_store_armed_warm_starts_it(tmp_path, monkeypatch):
    from tpudl_torch import compile as C

    calls = []
    monkeypatch.setenv("TPUDL_COMPILE_AOT", str(tmp_path / "programs"))
    monkeypatch.setattr(C, "warm_start",
                        lambda block=True: calls.append(block) or 0)
    spec = jobs.JobSpec("custom", str(tmp_path / "job"))
    jobs.JobRuntime(spec, install_signals=False).run(lambda ctx: None)
    assert calls == []          # a first attempt has nothing to restore
    jobs.JobRuntime(spec, install_signals=False).run(lambda ctx: None)
    assert calls == [True]
    m = jobs.load_manifest(spec.workdir)
    assert m["program_store"] == C.store_dir()
    events = flight.get_recorder().snapshot()["events"]
    assert any(e["kind"] == "job.aot_warm_start" for e in events)


def test_sigterm_goes_back_to_the_flight_recorders_handler(tmp_path):
    """In a child: the runtime holds SIGTERM during a run and gives it
    back to the handler that was there before it (the recorder's)."""
    code = f"""
import signal, sys
sys.path.insert(0, {str(REPO)!r})
from tpudl_torch.obs import flight
from tpudl_torch.jobs import JobRuntime, JobSpec
flight.install(dump_dir={str(tmp_path)!r}, excepthook=False)
recorder = signal.getsignal(signal.SIGTERM)
rt = JobRuntime(JobSpec("custom", {str(tmp_path / "job")!r}))
inside = rt.run(lambda ctx: signal.getsignal(signal.SIGTERM))
assert inside is not recorder and callable(inside)
assert signal.getsignal(signal.SIGTERM) is recorder
print("OK")
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=60)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-1500:]


def test_failed_run_marks_the_manifest_failed(tmp_path):
    spec = jobs.JobSpec("custom", str(tmp_path / "job"))

    def boom(ctx):
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        jobs.JobRuntime(spec, install_signals=False).run(boom)
    m = jobs.load_manifest(spec.workdir)
    assert m["status"] == "failed" and "boom" in m["error"]
    errs = flight.get_recorder().snapshot()["errors"]
    assert any(e["kind"] == "job.failed" for e in errs)


def test_exports_tpudls_names():
    assert sorted(jobs.__all__) == sorted(jjobs.__all__)
    for name in jobs.__all__:
        assert getattr(jobs, name) is not None
    assert jobs.RC_PREEMPTED == jjobs.RC_PREEMPTED == 75
    from tpudl_torch.jobs import runtime as trt
    from tpudl.jobs import runtime as jrt

    assert (trt.MANIFEST_NAME, trt.MANIFEST_SCHEMA, trt.MANIFEST_VERSION) \
        == (jrt.MANIFEST_NAME, jrt.MANIFEST_SCHEMA, jrt.MANIFEST_VERSION)
