"""The serve SLO engine (``tpudl_torch.obs.slo``) against tpudl's.

One stamp sequence, on an injected monotonic clock, through each
package's ``SloEngine`` gives the same windowed p50/p99, availability,
short and long burn rates and status section, the same ``serve.slo.*``
gauges and the same tail exemplars."""

import pytest

from tpudl.obs import flight as jflight
from tpudl.obs import metrics as jmetrics
from tpudl.obs import slo as jslo

from tpudl_torch.obs import flight as tflight
from tpudl_torch.obs import metrics as tmetrics
from tpudl_torch.obs import slo as tslo

SIDES = {"tpudl": (jslo, jmetrics, jflight), "port": (tslo, tmetrics,
                                                      tflight)}


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t

    def time(self):
        return self.t


class _Req:
    def __init__(self, latency_s, model="m"):
        self.latency_s = latency_s
        self.model = model
        self.trace = None


# (seconds since the start, latency in ms): a quiet stretch, a slow
# burst, and stamps that age out of the short window but stay in the long
STAMPS = ([(i * 0.5, 40.0 + (i % 7)) for i in range(40)]
          + [(25.0 + i * 0.1, 900.0 + 10 * i) for i in range(6)]
          + [(80.0 + i, 35.0) for i in range(10)])


@pytest.mark.parametrize("target_ms,window_s,tail_k", [
    ("500", "30", "4"), ("100", "10", "2"), ("50", "1", "1")])
def test_windows_and_burn_rates_equal_tpudls(monkeypatch, target_ms,
                                             window_s, tail_k):
    monkeypatch.setenv("TPUDL_SERVE_SLO_P99_MS", target_ms)
    monkeypatch.setenv("TPUDL_SERVE_SLO_WINDOW_S", window_s)
    monkeypatch.setenv("TPUDL_SERVE_SLO_TAIL_K", tail_k)
    views = {}
    for side, (mod, metrics, flight) in SIDES.items():
        clock = _Clock()
        monkeypatch.setattr(mod, "time", clock)
        eng = mod.reset_slo_engine()
        flight.get_recorder().reset()
        ex0 = metrics.counter("serve.slo.exemplars").value
        trail = []
        for i, (dt, ms) in enumerate(STAMPS):
            clock.t = 1000.0 + dt
            eng.record(_Req(ms / 1000.0))
            if i in (20, 45, 55):
                trail.append(eng.compute())
        clock.t += 5.0
        view = eng.publish(force=True)
        gauges = {n: metrics.gauge(n).value for n in (
            "serve.slo.target_ms", "serve.slo.window_p50_ms",
            "serve.slo.window_p99_ms", "serve.slo.burn_long")}
        exemplars = [
            {k: e[k] for k in ("latency_ms", "window_median_ms", "tail_k",
                               "dominant_segment")}
            for e in flight.get_recorder().snapshot()["errors"]
            if e["kind"] == "serve.slo.exemplar"]
        views[side] = (trail, view, eng.status_section(), gauges,
                       exemplars,
                       metrics.counter("serve.slo.exemplars").value - ex0)
    assert views["port"] == views["tpudl"]
    trail, view = views["port"][0], views["port"][1]
    assert trail[1]["burn_short"] is not None
    assert view["burn_long"] is not None
    tslo.reset_slo_engine()


def test_empty_engine_has_no_status_section(monkeypatch):
    views = []
    for mod, _, _ in SIDES.values():
        eng = mod.reset_slo_engine()
        assert eng.status_section() is None
        views.append(eng.compute(now=5.0))
    assert views[0] == views[1] and views[0]["window_n"] == 0
