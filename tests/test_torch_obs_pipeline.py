"""The port's ``PipelineReport`` (``tpudl_torch.obs.pipeline``) against
tpudl's: the same stage names, gauges and counts from a map_batches run,
the same report keys and arithmetic, the ``finish`` metrics under tpudl's
names, and the run ring."""

import numpy as np
import pytest

import jax

from tpudl import obs as jobs
from tpudl.frame import Frame as JaxFrame
from tpudl.obs.pipeline import PipelineReport as JaxReport
from tpudl_torch import obs
from tpudl_torch.frame import Frame
from tpudl_torch.obs import metrics
from tpudl_torch.obs.pipeline import PipelineReport

STAGES = {"prepare", "infeed_wait", "dispatch", "dispatch_wait", "h2d",
          "d2h"}


def _frame(cls):
    return cls({"x": np.arange(46, dtype=np.float32).reshape(23, 2)})


def test_a_run_reports_tpudl_stage_names_gauges_and_counts():
    _frame(Frame).map_batches(lambda x: x * 3.0, ["x"], ["y"], batch_size=4,
                              fuse_steps=2, buckets="pow2", device="cpu")
    rep = obs.last_pipeline_report()
    _frame(JaxFrame).map_batches(jax.jit(lambda x: x * 3.0), ["x"], ["y"],
                                 batch_size=4, fuse_steps=2, buckets="pow2",
                                 autotune=False)
    jrep = jobs.last_pipeline_report()
    assert set(rep["stage_seconds"]) <= STAGES
    assert {"prepare", "infeed_wait", "dispatch", "dispatch_wait",
            "d2h"} <= set(rep["stage_seconds"])
    for gauge in ("queue_depth", "dispatch_inflight"):
        assert f"{gauge}_mean" in rep and f"{gauge}_max" in rep
        assert f"{gauge}_max" in jrep
    for count in ("fused_dispatches", "bytes_prepared", "bucket_pad_rows",
                  "first_dispatch_s"):
        assert count in rep["stage_calls"], count
        assert count in jrep["stage_calls"], count
    for count in ("fused_dispatches", "bytes_prepared", "bucket_pad_rows"):
        assert rep["stage_calls"][count] == jrep["stage_calls"][count]
    # 5 full batches of 4 (two fused groups) and a tail of 3 padded to 4
    assert rep["stage_calls"]["fused_dispatches"] == 2
    assert rep["stage_calls"]["bucket_pad_rows"] == 1
    assert rep["rows_done"] == jrep["rows_done"] == 23
    assert rep["finished"] is True
    assert 0.0 <= rep["overlap_efficiency"] <= 1.0
    assert rep["dispatch_overlap_s"] >= 0.0
    assert set(jrep) - set(rep) <= {"dispatch_overlap_s"}


def test_report_arithmetic_matches_tpudl():
    got, want = PipelineReport(), JaxReport()
    for rep in (got, want):
        rep.add("prepare", 2.0)
        rep.add("prepare", 2.0)
        rep.add("infeed_wait", 1.0)
        rep.add("dispatch", 0.5)
        rep.add("dispatch_wait", 1.5)
        rep.count("fused_dispatches", 3)
        rep.gauge("queue_depth", 1)
        rep.gauge("queue_depth", 2)
        rep.progress(7)
        rep.config = {"rows": 7}
    assert got.overlap_efficiency() == want.overlap_efficiency() == 0.75
    assert got.dispatch_overlap_s() == want.dispatch_overlap_s() == 0.0
    g, w = got.report(), want.report()
    for k in ("stage_seconds", "stage_calls", "rows_done",
              "queue_depth_mean", "queue_depth_max", "overlap_efficiency",
              "dispatch_overlap_s", "rows"):
        assert g[k] == w[k], k
    assert set(w) - set(g) == set()
    assert PipelineReport().overlap_efficiency() is None
    assert PipelineReport().dispatch_overlap_s() is None


def test_finish_publishes_tpudl_metric_names():
    before = metrics.snapshot("frame.")

    def value(snap, name, key="value"):
        return snap.get(name, {}).get(key) or 0

    rep = PipelineReport()
    rep.config = {"rows": 11}
    rep.add("prepare", 0.25)
    rep.add("infeed_wait", 0.05)
    rep.add("dispatch", 0.5)
    rep.add("dispatch", 0.5)
    rep.add("dispatch_wait", 0.25)
    rep.gauge("dispatch_inflight", 2)
    rep.finish(1.5)
    after = metrics.snapshot("frame.")
    assert value(after, "frame.map_batches.runs") - \
        value(before, "frame.map_batches.runs") == 1
    assert value(after, "frame.map_batches.rows") - \
        value(before, "frame.map_batches.rows") == 11
    assert value(after, "frame.map_batches.batches") - \
        value(before, "frame.map_batches.batches") == 2
    assert value(after, "frame.stage.dispatch.seconds") - \
        value(before, "frame.stage.dispatch.seconds") == pytest.approx(1.0)
    assert after["frame.overlap_efficiency"]["value"] == pytest.approx(0.8)
    assert after["frame.dispatch.overlap_s"]["value"] == pytest.approx(0.75)
    assert after["frame.dispatch.inflight"]["value"] == 2
    assert after["frame.map_batches.wall_seconds"]["count"] >= 1
    assert rep.report()["wall_seconds"] == 1.5


def test_ring_keeps_runs_by_id():
    a, b = PipelineReport(), PipelineReport()
    obs.set_last_pipeline(a)
    obs.set_last_pipeline(b)
    obs.set_last_pipeline(None)
    assert a.run_id != b.run_id
    assert obs.last_pipeline_report()["run_id"] == b.run_id
    assert obs.get_pipeline_report(a.run_id)["run_id"] == a.run_id
    assert list(obs.pipeline_reports())[-2:] == [a.run_id, b.run_id]
    assert obs.get_pipeline_report("no-such-run") is None
