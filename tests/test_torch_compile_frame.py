"""``Frame.map_batches(aot=)`` and the stages' warm-up through the
program store, on the CPU, held against tpudl's executor: outputs bit for
bit ``aot=False`` and tpudl's ``aot=False`` on the same function, with
and without a ladder and under ``fuse_steps=2``; the report's ``aot``,
``aot_hits`` and ``aot_misses``; a fresh store's first dispatch a hit;
``ImageBatchWarmup.warmup`` capturing the executor's exact key."""

import numpy as np
import pytest

import jax

from tpudl import obs as jobs
from tpudl.frame import Frame as JFrame

from tpudl_torch import mesh as M
from tpudl_torch.compile import store as cstore
from tpudl_torch.frame import Frame
from tpudl_torch.obs import metrics as tmetrics
from tpudl_torch.obs.pipeline import last_pipeline_report

ROWS, BATCH = 70, 16


@pytest.fixture(autouse=True)
def armed(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUDL_COMPILE_AOT", str(tmp_path / "programs"))
    monkeypatch.delenv("TPUDL_COMPILE_BUCKETS", raising=False)
    cstore.reset_program_store()
    yield
    cstore.reset_program_store()


def _x():
    return np.random.default_rng(0).standard_normal((ROWS, 6)).astype(
        np.float32)


def tfn(b):
    return b * 2.0 + 1.0


_jfn = jax.jit(lambda b: b * 2.0 + 1.0)


def _run(fn, **kw):
    out = Frame({"x": _x()}).map_batches(fn, ["x"], ["y"], batch_size=BATCH,
                                         device="cpu", **kw)
    return np.stack(list(out["y"]))


def _count(name):
    return tmetrics.counter(name).value


@pytest.mark.parametrize("kw", [dict(), dict(buckets="pow2"),
                                dict(buckets="pow2ish"),
                                dict(fuse_steps=2),
                                dict(fuse_steps=2, buckets="pow2"),
                                dict(dispatch_depth=1, prefetch=False)])
def test_aot_is_bit_for_bit_unarmed_and_tpudl(kw):
    want = np.stack(list(JFrame({"x": _x()}).map_batches(
        _jfn, ["x"], ["y"], batch_size=BATCH, autotune=False, aot=False,
        **kw)["y"]))
    plain = _run(tfn, aot=False, **kw)
    assert last_pipeline_report()["aot"] is False
    h0, m0 = _count("compile.hits"), _count("compile.misses")
    got = _run(tfn, aot=True, **kw)
    rep = last_pipeline_report()
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, want)
    assert rep["aot"] is True
    calls = rep["stage_calls"]
    hits, misses = calls.get("aot_hits", 0), calls.get("aot_misses", 0)
    assert hits + misses == calls["dispatch"] and misses >= 1
    assert _count("compile.hits") - h0 == hits
    assert _count("compile.misses") - m0 == misses
    # the same function again: every dispatch hits
    np.testing.assert_array_equal(_run(tfn, aot=True, **kw), plain)
    calls = last_pipeline_report()["stage_calls"]
    assert "aot_misses" not in calls
    assert calls["aot_hits"] == calls["dispatch"]


def test_report_fields_as_tpudl(monkeypatch):
    """The report's ``aot`` and ``buckets`` as tpudl files them, with the
    knobs read from the environment (``buckets=None``, ``aot=None``)."""
    monkeypatch.setenv("TPUDL_COMPILE_BUCKETS", "pow2")
    _run(tfn)
    rep = last_pipeline_report()
    JFrame({"x": _x()}).map_batches(_jfn, ["x"], ["y"], batch_size=BATCH,
                                    autotune=False)
    jrep = jobs.last_pipeline_report()
    for k in ("aot", "buckets", "fuse_steps"):
        assert rep[k] == jrep[k], k
    assert rep["aot"] is True and rep["buckets"] == "pow2"
    monkeypatch.setenv("TPUDL_FRAME_PREFETCH", "0")   # the serial kill arm
    _run(tfn)
    assert last_pipeline_report()["aot"] is False


def test_fresh_store_first_dispatch_hits():
    """What a new process sees: the manifest the last run left is captured
    at run setup, so every dispatch (the first too) hits."""
    want = _run(tfn, aot=True, buckets="pow2")
    cstore.reset_program_store()
    r0, m0 = _count("compile.programs_restored"), _count("compile.misses")
    got = _run(tfn, aot=True, buckets="pow2")
    np.testing.assert_array_equal(got, want)
    calls = last_pipeline_report()["stage_calls"]
    assert calls["aot_hits"] == 5 and "aot_misses" not in calls
    assert _count("compile.misses") == m0
    assert _count("compile.programs_restored") - r0 == 2   # rung 16 and 8


def test_mesh_runs_one_program_a_card_bit_for_bit():
    mesh = M.build_mesh(devices=["cpu"] * 2)
    plain = _run(tfn, aot=False, mesh=mesh)
    got = _run(tfn, aot=True, mesh=mesh)
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, _run(tfn, aot=False))
    entries = cstore.get_program_store().entries().values()
    assert {e["mesh"] for e in entries} == {"mesh[('data', 2), ('model', 1)]"}


@pytest.mark.parametrize("batch,rows,fuse", [(3, 6, 1), (3, 6, 2),
                                             (4, 8, 2)])
def test_image_warmup_captures_the_executors_key(tmp_path, monkeypatch,
                                                  batch, rows, fuse):
    """With the store armed, ``warmup`` captures what ``transform`` will
    dispatch — the rung a batch pads to under ``TPUDL_COMPILE_BUCKETS``
    (3 → 4, which also drops fusion), else the fused graph of
    ``fuseSteps`` batches — so the transform misses nothing; its features
    are bit for bit the unarmed stage's."""
    from tpudl_torch.image import imageIO
    from tpudl_torch.ml import DeepImageFeaturizer

    rng = np.random.default_rng(3)
    structs = np.empty(rows, dtype=object)
    structs[:] = [imageIO.imageArrayToStruct(
        rng.integers(0, 255, (24, 24, 3)).astype(np.uint8))
        for _ in range(rows)]
    frame = Frame({"image": structs})
    monkeypatch.setenv("TPUDL_COMPILE_BUCKETS", "pow2")

    def stage():
        return DeepImageFeaturizer(inputCol="image", outputCol="f",
                                   modelName="MobileNetV2", batchSize=batch,
                                   fuseSteps=fuse, device="cpu")

    monkeypatch.delenv("TPUDL_COMPILE_AOT")
    want = np.stack(list(stage().transform(frame)["f"]))
    monkeypatch.setenv("TPUDL_COMPILE_AOT", str(tmp_path / "warm"))
    feat = stage().warmup(24, 24)
    m0, h0 = _count("compile.misses"), _count("compile.hits")
    got = np.stack(list(feat.transform(frame)["f"]))
    np.testing.assert_array_equal(got, want)
    assert _count("compile.misses") == m0
    assert _count("compile.hits") - h0 == (1 if batch == 4 else 2)
