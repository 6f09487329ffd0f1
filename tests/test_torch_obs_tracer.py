"""The host-span tracer (``tpudl_torch.obs.tracer``) against tpudl's.

The same span sequence (nested, raising, on two threads) through each
package's ``Tracer`` gives the same span names, attributes and thread
names, the same Chrome trace-event export schema, the same ring bounds
and drop counts, and the same windowed export on the same span times."""

import json
import threading

import pytest

from tpudl.obs import tracer as jtracer

from tpudl_torch.obs import tracer as ttracer

SIDES = {"tpudl": jtracer, "port": ttracer}


def _drive(mod, ring=64):
    tr = mod.Tracer(ring=ring)
    with tr.span("outer", rows=4):
        with tr.span("inner", stage="prepare", batch=1):
            pass
    with pytest.raises(ValueError):
        with tr.span("fails", k="v"):
            raise ValueError("boom")

    def work():
        with tr.span("worker", idx=7):
            pass

    t = threading.Thread(target=work, name="obs-test-worker")
    t.start()
    t.join(5)
    return tr


def _shape(events):
    """Each event without its times and ids: what must agree."""
    out = []
    for e in events:
        e = dict(e)
        for k in ("ts", "dur", "pid", "tid"):
            if k in e:
                e[k] = type(e[k]).__name__
        out.append(e)
    return out


def test_span_names_attributes_and_threads_equal_tpudls():
    got = {side: _drive(mod) for side, mod in SIDES.items()}
    spans = {side: [(s.name, s.attrs, s.thread_name)
                    for s in tr.spans()]
             for side, tr in got.items()}
    assert spans["port"] == spans["tpudl"]
    assert [n for n, _, _ in spans["port"]] == [
        "inner", "outer", "fails", "worker"]
    assert spans["port"][2][1] == {"k": "v", "error": "ValueError"}
    assert all(s.dur_us >= 0 for s in got["port"].spans())


def test_chrome_export_schema_equals_tpudls(tmp_path):
    payloads = {}
    for side, mod in SIDES.items():
        path = _drive(mod).export_chrome_trace(
            str(tmp_path / f"{side}.host.trace.json"))
        with open(path) as f:
            payloads[side] = json.load(f)
    port, tpudl = payloads["port"], payloads["tpudl"]
    assert sorted(port) == sorted(tpudl)
    assert port["displayTimeUnit"] == tpudl["displayTimeUnit"]
    assert port["metadata"] == tpudl["metadata"]
    # thread ids differ between the two runs; the metadata rows name the
    # same threads, and the span rows agree once times and ids are types
    meta = {side: sorted(e["args"]["name"] for e in p["traceEvents"]
                         if e["ph"] == "M")
            for side, p in payloads.items()}
    assert meta["port"] == meta["tpudl"]
    spans = {side: _shape(e for e in p["traceEvents"] if e["ph"] == "X")
             for side, p in payloads.items()}
    assert spans["port"] == spans["tpudl"]


@pytest.mark.parametrize("ring,n", [(1, 3), (4, 4), (4, 9), (16, 5)])
def test_ring_bounds_and_drops_equal_tpudls(ring, n):
    kept = {}
    for side, mod in SIDES.items():
        tr = mod.Tracer(ring=ring)
        for i in range(n):
            with tr.span(f"s{i}"):
                pass
        kept[side] = ([s.name for s in tr.spans()], tr.dropped)
    assert kept["port"] == kept["tpudl"]
    assert kept["port"][1] == max(0, n - ring)


def test_windowed_export_equals_tpudls():
    window = (1000.0, 2000.0)
    events = {}
    for side, mod in SIDES.items():
        tr = mod.Tracer(ring=16)
        # the same span times on both sides: before, across the start,
        # inside, across the end and after the window
        for name, ts, dur in (("before", 0.0, 500.0),
                              ("start", 900.0, 200.0),
                              ("inside", 1200.0, 10.0),
                              ("end", 1990.0, 100.0),
                              ("after", 2500.0, 1.0)):
            tr._spans.append(mod.Span(name, ts, dur, 1, "t", {"n": name}))
        tr.last_profile_window = window
        events[side] = [e for e in tr.to_events(window=window)
                        if e["ph"] == "X"]
    assert [e["name"] for e in events["port"]] == ["start", "inside", "end"]
    assert _shape(events["port"]) == _shape(events["tpudl"])


def test_module_span_lands_on_the_process_tracer(tmp_path):
    tr = ttracer.get_tracer()
    with ttracer.span("obs.test.module_span", x=1):
        pass
    assert tr.spans()[-1].name == "obs.test.module_span"
    assert tr.spans()[-1].attrs == {"x": 1}
    path = ttracer.export_chrome_trace(str(tmp_path / "a.host.trace.json"))
    with open(path) as f:
        names = [e["name"] for e in json.load(f)["traceEvents"]]
    assert "obs.test.module_span" in names
