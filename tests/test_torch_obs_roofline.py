"""The roofline advisor (``tpudl_torch.obs.roofline``) against tpudl's.

``analyze``, ``advise`` and ``autotune_seed`` are tpudl's functions of a
pipeline-report dict plus their inputs: on the same report dicts (tpudl's
own fixtures and their bottleneck variants, an async window, a mesh, a
serve session) and the same inputs they give the same report, verdict,
advice and seeds, and publish the same ``obs.roofline.*`` gauges.
``model_report`` maps the port executor's stage timers into the model's
terms, and ``map_batches(autotune=True)`` seeds what the advisor says
over the previous run's report under tpudl's match guard."""

import time

import numpy as np
import pytest

from test_obs_roofline import DEVICE_MS, WIRE_MBPS, round45_report
from tpudl.obs import metrics as jmetrics
from tpudl.obs import roofline as jroof

from tpudl_torch.frame import Frame
from tpudl_torch.obs import last_pipeline_report
from tpudl_torch.obs import metrics as tmetrics
from tpudl_torch.obs import roofline as troof

REPORTS = {
    "dispatch-bound": round45_report(),
    "wire-bound": round45_report(
        wire_codec="off",
        stage_seconds={"prepare": 0.2, "infeed_wait": 0.05,
                       "dispatch": 2.1, "d2h": 0.05},
        stage_calls={"dispatch": 4, "prepare": 4,
                     "bytes_prepared": int(1024 * 0.27 * 2**20)}),
    "prepare-bound": round45_report(
        stage_seconds={"prepare": 6.0, "infeed_wait": 1.6,
                       "dispatch": 0.4, "d2h": 0.05},
        prepare_workers=1),
    "device-bound": round45_report(
        wall_seconds=0.16,
        stage_seconds={"prepare": 0.1, "infeed_wait": 0.0,
                       "dispatch": 0.14, "d2h": 0.01}),
    "async window": round45_report(
        dispatch_depth=4,
        stage_seconds={"prepare": 1.5, "infeed_wait": 0.1,
                       "dispatch": 4.0, "dispatch_wait": 1.2,
                       "d2h": 0.1}),
    "mesh": round45_report(
        mesh={"data": 4, "model": 2},
        stage_seconds={"prepare": 1.0, "infeed_wait": 0.1, "h2d": 0.3,
                       "dispatch": 1.5, "d2h": 0.1},
        stage_calls={"dispatch": 4, "prepare": 4, "pad_rows": 8,
                     "bytes_prepared": int(1024 * 0.0685 * 2**20)}),
    "hbm resident": round45_report(
        device_cache=False,
        stage_calls={"dispatch": 4, "prepare": 4,
                     "bytes_prepared": int(1024 * 0.0685 * 2**20),
                     "bytes_hbm_hit": int(1024 * 0.06 * 2**20)}),
    "serve": round45_report(
        serve=True, queue_cap=4,
        stage_calls={"dispatch": 40, "tokens": 400}),
    "unfinished": round45_report(finished=False, wall_seconds=None,
                                 age_s=1.7, rows_done=512),
}
INPUTS = {
    "probe and device ms": dict(h2d_mbps=WIRE_MBPS,
                                device_ms_per_dispatch=DEVICE_MS),
    "no device time": dict(h2d_mbps=WIRE_MBPS),
    "collectives": dict(h2d_mbps=WIRE_MBPS,
                        device_ms_per_dispatch=DEVICE_MS,
                        collective_ms_per_dispatch=60.0),
    "bytes override": dict(h2d_mbps=30.0, device_ms_per_dispatch=5.0,
                           bytes_prepared=2**28),
}


@pytest.mark.parametrize("inputs", sorted(INPUTS))
@pytest.mark.parametrize("name", sorted(REPORTS))
def test_analyze_and_advise_equal_tpudls(monkeypatch, name, inputs):
    monkeypatch.setenv("TPUDL_DATA_HBM_BUDGET_MB", "512")
    kw = INPUTS[inputs]
    ours = troof.analyze(REPORTS[name], publish=False, **kw)
    theirs = jroof.analyze(REPORTS[name], publish=False, **kw)
    if theirs is None:
        assert ours is None
        return
    assert ours.to_dict() == theirs.to_dict()
    assert ours.dispatch_plus_wire_frac() == theirs.dispatch_plus_wire_frac()
    assert troof.advise(ours) == jroof.advise(theirs)


@pytest.mark.parametrize("match", [None, {"batch_size": 256},
                                   {"batch_size": 64},
                                   {"batch_size": 256, "mesh": None}])
@pytest.mark.parametrize("name", sorted(REPORTS))
def test_autotune_seeds_equal_tpudls(monkeypatch, name, match):
    monkeypatch.setenv("TPUDL_WIRE_MBPS", str(WIRE_MBPS))
    monkeypatch.setenv("TPUDL_DEVICE_MS_PER_STEP", str(DEVICE_MS))
    ours = troof.autotune_seed(REPORTS[name], match=match)
    assert ours == jroof.autotune_seed(REPORTS[name], match=match)
    assert set(ours) <= set(troof.AUTOTUNE_KNOBS)
    for knob, v in ours.items():
        assert 1 <= v <= troof.KNOB_CAPS[knob]


def test_published_gauges_equal_tpudls():
    vals = {}
    for side, (roof, metrics) in {"tpudl": (jroof, jmetrics),
                                  "port": (troof, tmetrics)}.items():
        roof.analyze(REPORTS["dispatch-bound"], h2d_mbps=WIRE_MBPS,
                     device_ms_per_dispatch=DEVICE_MS)
        vals[side] = {n: v["value"] for n, v in metrics.snapshot(
            prefix="obs.roofline.").items()}
    assert vals["port"] == vals["tpudl"] and vals["port"]


def test_model_report_maps_the_port_stages():
    port = {"stage_seconds": {"prepare": 1.0, "infeed_wait": 0.2,
                              "h2d": 0.1, "dispatch": 0.3,
                              "dispatch_wait": 0.9, "d2h": 0.05},
            "stage_calls": {"dispatch": 4}, "batch_size": 8}
    got = troof.model_report(port)
    assert got["stage_seconds"] == {"prepare": 1.0, "infeed_wait": 0.2,
                                    "dispatch": pytest.approx(1.3),
                                    "d2h": 0.05}
    assert got["stage_calls"] == port["stage_calls"]
    assert port["stage_seconds"]["h2d"] == 0.1       # the input stays
    assert troof.model_report(None) is None


def test_map_batches_autotune_seeds_from_the_previous_report(monkeypatch):
    """Unset knobs take the advisor's seeds over the previous run's
    mapped report at the same batch size; explicit ones win; the rows are
    the untuned run's; another batch size seeds nothing."""
    monkeypatch.setenv("TPUDL_WIRE_MBPS", "1e6")
    monkeypatch.setenv("TPUDL_DEVICE_MS_PER_STEP", "0.001")
    for k in ("TPUDL_FRAME_FUSE_STEPS", "TPUDL_FRAME_DISPATCH_DEPTH",
              "TPUDL_FRAME_PREFETCH_DEPTH", "TPUDL_FRAME_AUTOTUNE"):
        monkeypatch.delenv(k, raising=False)
    x = {"x": np.arange(64 * 3, dtype=np.float32).reshape(64, 3)}

    def slow(t):     # a dispatch-bound run: fn time dominates the gap
        time.sleep(0.03)
        return t * 3

    def run(**kw):
        out = Frame(x).map_batches(slow, ["x"], ["y"], device="cpu", **kw)
        return np.stack(list(out["y"])), last_pipeline_report()

    want, prev = run(batch_size=8, autotune=False, dispatch_depth=1,
                     prefetch_depth=1)
    seeds = troof.autotune_seed(troof.model_report(prev),
                                match={"batch_size": 8, "mesh": None})
    assert {"fuse_steps", "dispatch_depth"} <= set(seeds)
    got, rep = run(batch_size=8)
    assert rep["autotune"] is True and rep["autotuned"] == sorted(seeds)
    assert (rep["fuse_steps"], rep["dispatch_depth"]) == (
        seeds["fuse_steps"], seeds["dispatch_depth"])
    assert rep["prefetch_depth"] >= seeds.get("prefetch_depth", 1)
    assert np.array_equal(got, want)
    got, rep = run(batch_size=8, dispatch_depth=1)     # explicit wins
    assert "dispatch_depth" not in rep["autotuned"]
    assert rep["dispatch_depth"] == 1 and np.array_equal(got, want)
    got, rep = run(batch_size=16)                     # the match guard
    assert rep["autotuned"] == [] and np.array_equal(got, want)
