"""The stall watchdog (``tpudl_torch.obs.watchdog``) against tpudl's.

Under ``stall_s=0.2``, a heartbeat that stops beating gives ONE stall
event per episode (a beat re-arms it), naming the stage that stayed in
flight and carrying every Python thread's stack, in the same event
schema as tpudl's; nested heartbeats re-arm their parents; the lazily
started daemon files the event in the port's flight recorder and counts
``obs.watchdog.stalls`` once."""

import threading
import time

import pytest

from tpudl.obs import watchdog as jwatchdog

from tpudl_torch.obs import flight, metrics
from tpudl_torch.obs import watchdog as twatchdog

SIDES = {"tpudl": jwatchdog, "port": twatchdog}


def _episodes(mod):
    """Two stall episodes of one heartbeat, driven by hand."""
    reg = mod.HeartbeatRegistry()
    dog = mod.Watchdog(reg, stall_s=0.2, interval=0.05)
    parked = threading.Event()
    helper = threading.Thread(target=parked.wait, args=(5,),
                              name="obs-test-parked")
    helper.start()
    try:
        with reg.start("frame.map_batches", run="r1") as hb:
            hb.stage_enter("dispatch")
            time.sleep(0.3)
            first = dog.scan()
            again = dog.scan()            # same episode: no new event
            hb.beat(stage="prepare")      # re-armed
            quiet = dog.scan()
            time.sleep(0.3)
            second = dog.scan()
    finally:
        parked.set()
        helper.join(5)
    return first, again, quiet, second


def test_one_stall_event_per_episode_like_tpudl():
    got = {side: _episodes(mod) for side, mod in SIDES.items()}
    for side, (first, again, quiet, second) in got.items():
        assert (len(first), len(again), len(quiet), len(second)) == \
            (1, 0, 0, 1), side
    port, tpudl = got["port"][0][0], got["tpudl"][0][0]
    assert sorted(port) == sorted(tpudl)
    for key in ("name", "info", "beats", "stall_s", "active"):
        assert port[key] == tpudl[key], key
    assert set(port["in_flight"]) == set(tpudl["in_flight"]) == \
        {"dispatch"}
    assert port["age_s"] > 0.2 and tpudl["age_s"] > 0.2
    # every thread's stack, the parked helper's among them
    names = {k.split(":", 1)[1] for k in port["stacks"]}
    assert {"MainThread", "obs-test-parked"} <= names
    assert all(isinstance(v, list) and v for v in port["stacks"].values())


def test_nested_heartbeats_rearm_their_parents_like_tpudl():
    ages = {}
    for side, mod in SIDES.items():
        reg = mod.HeartbeatRegistry()
        dog = mod.Watchdog(reg, stall_s=0.2, interval=0.05)
        with reg.start("udf.outer") as outer:
            time.sleep(0.25)
            with reg.start("frame.map_batches") as inner:
                inner.beat(stage="prepare")       # child progress
                flagged = dog.scan()
        ages[side] = (outer.age() < 0.2, [e["name"] for e in flagged],
                      inner.parent is outer)
    assert ages["port"] == ages["tpudl"] == (True, [], True)


def test_describe_equals_tpudls_keys():
    keys = {}
    for side, mod in SIDES.items():
        reg = mod.HeartbeatRegistry()
        with reg.start("train.fit", steps=3) as hb:
            hb.beat(step=1)
            desc = reg.describe()
        keys[side] = {n: (sorted(d), d["info"], d["beats"])
                      for n, d in desc.items()}
    assert keys["port"] == keys["tpudl"]


def test_lazy_daemon_files_one_stall_in_the_flight_recorder(monkeypatch):
    monkeypatch.setenv("TPUDL_WATCHDOG_STALL_S", "0.2")
    monkeypatch.delenv("TPUDL_STATUS_DIR", raising=False)
    twatchdog.stop_watchdog()
    flight.get_recorder().reset()
    before = metrics.counter("obs.watchdog.stalls").value
    try:
        with twatchdog.heartbeat("obs.test.lazy", rows=1) as hb:
            assert twatchdog._WATCHDOG is not None
            assert twatchdog._WATCHDOG.stall_s == pytest.approx(0.2)
            hb.beat(stage="prepare")
            time.sleep(0.8)
    finally:
        twatchdog.stop_watchdog()
    stalls = [s for s in flight.get_recorder().snapshot()["stalls"]
              if s["name"] == "obs.test.lazy"]
    assert len(stalls) == 1
    assert stalls[0]["info"] == {"rows": 1, "stage": "prepare"}
    assert metrics.counter("obs.watchdog.stalls").value >= before + 1


def test_thread_stacks_name_every_thread():
    parked = threading.Event()
    t = threading.Thread(target=parked.wait, args=(5,),
                         name="obs-test-stacks")
    t.start()
    try:
        ours = twatchdog.thread_stacks()
        theirs = jwatchdog.thread_stacks()
    finally:
        parked.set()
        t.join(5)
    assert f"{t.ident}:obs-test-stacks" in ours
    assert any(k.endswith(":MainThread") for k in ours)
    assert all(k.split(":", 1)[0].isdigit() and v for k, v in ours.items())
    assert {k.split(":", 1)[1] for k in ours} >= {"MainThread",
                                                  "obs-test-stacks"}
    assert f"{t.ident}:obs-test-stacks" in theirs
