"""The attribution plane (``tpudl_torch.obs.attribution``) against tpudl's.

- Two tenants running ``map_batches`` at once, on two threads, through a
  bf16 wire codec: each tenant's ledger row (rows in and out, wire bytes)
  equals tpudl's for the same run, and the port's ledger reconciles
  exactly with its global counters.
- Scopes nest by merge into tpudl's keys, ``job=`` keys on the port's
  ``JobSpec`` fingerprint as tpudl's does on its own, ``carry`` takes the
  scope across a thread and is the identity when unscoped.
- A bounded ledger (``TPUDL_OBS_SCOPES``) evicts and folds as tpudl's,
  conserving totals; device-cache bytes are charged to the scope that put
  them and credited back on eviction, so ``hbm_bytes`` mirrors the
  resident gauge."""

import threading
import uuid
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import jax

from tpudl.frame import Frame as JaxFrame
from tpudl.obs import attribution as jattr

from tpudl_torch.data import device_cache as dc
from tpudl_torch.frame import Frame
from tpudl_torch.obs import attribution as tattr

FIELDS = ("rows_in", "rows_out", "wire_bytes")


def _cols(seed):
    return {"x": np.random.default_rng(seed).normal(
        size=(37, 5)).astype(np.float32)}


def _run_two_tenants(attr, run, tenants):
    before = attr.ledger_snapshot()["scopes"]
    barrier = threading.Barrier(2)

    def one(i):
        with attr.scope(tenant=tenants[i]):
            barrier.wait(10)
            return run(i)

    with ThreadPoolExecutor(2) as pool:
        outs = list(pool.map(one, range(2)))
    after = attr.ledger_snapshot()["scopes"]
    rows = {}
    for t in tenants:
        key = f"tenant={t}"
        rows[t[:1]] = {f: after[key][f] - before.get(key, {}).get(f, 0.0)
                       for f in FIELDS}
    return outs, rows


def test_interleaved_tenants_charge_as_tpudls_and_reconcile():
    tag = uuid.uuid4().hex[:6]
    kw = dict(batch_size=8, wire_codec="bf16")

    def port(i):
        return Frame(_cols(i)).map_batches(
            lambda t: t * 2, ["x"], ["y"], device="cpu", autotune=False,
            **kw)

    jfn = jax.jit(lambda t: t * 2)

    def jrun(i):
        return JaxFrame(_cols(i)).map_batches(jfn, ["x"], ["y"],
                                              autotune=False, **kw)

    _, ours = _run_two_tenants(tattr, port, (f"a{tag}", f"b{tag}"))
    _, theirs = _run_two_tenants(jattr, jrun, (f"a{tag}", f"b{tag}"))
    assert ours == theirs
    assert ours["a"]["rows_in"] == ours["a"]["rows_out"] == 37
    assert ours["a"]["wire_bytes"] == 37 * 5 * 2
    # every pair but hbm_bytes: it mirrors one gauge, which each new
    # DeviceBatchCache resets (other files on this worker build private
    # caches); its pairing is the last test's
    rec = tattr.reconcile()
    assert [c for c in rec["checks"]
            if not c["ok"] and c["field"] != "hbm_bytes"] == []


def test_scope_keys_merge_and_carry_like_tpudl():
    keys = {}
    for side, attr in {"tpudl": jattr, "port": tattr}.items():
        with attr.scope(tenant="t"):
            with attr.scope(run="r1"):
                inner = attr.current_scope().key
            seen = []
            fn = attr.carry(lambda: seen.append(attr.current_scope().key))
        t = threading.Thread(target=fn)
        t.start()
        t.join(5)
        plain = object()
        keys[side] = (inner, seen, attr.carry(plain) is plain,
                      attr.Scope(tenant=1, job="j", run=None).key)
    assert keys["port"] == keys["tpudl"]
    assert keys["port"][:2] == ("tenant=t|run=r1", ["tenant=t"])


def test_job_scope_keys_on_the_fingerprint_like_tpudl(tmp_path):
    from tpudl.jobs import JobSpec as JaxSpec

    from tpudl_torch.jobs import JobSpec

    ours = tattr.Scope(tenant="a", job=JobSpec("fit", str(tmp_path),
                                               material={"k": 1}))
    theirs = jattr.Scope(tenant="a", job=JaxSpec("fit", str(tmp_path),
                                                  material={"k": 1}))
    assert ours.key == theirs.key
    assert ours.job == JobSpec("fit", str(tmp_path),
                               material={"k": 1}).fingerprint()[:12]


@pytest.mark.parametrize("cap", [1, 2, 3])
def test_bounded_ledger_evicts_and_conserves_like_tpudl(monkeypatch, cap):
    monkeypatch.setenv("TPUDL_OBS_SCOPES", str(cap))
    snaps = {}
    for side, attr in {"tpudl": jattr, "port": tattr}.items():
        led = attr.ScopeLedger()
        for i, t in enumerate(("a", "b", "c", "a")):
            led.charge("rows_in", 10 + i, key=f"tenant={t}")
            led.charge("hbm_bytes", 100, key=f"tenant={t}")
        led.charge("hbm_bytes", -100, key="tenant=b", create=False)
        led.charge("tokens_out", 3, key=None)
        snaps[side] = (led.snapshot(), led.totals())
    assert snaps["port"] == snaps["tpudl"]
    snap, totals = snaps["port"]
    assert snap["evicted"] == {1: 3, 2: 2, 3: 0}[cap]
    assert totals["rows_in"] == 10 + 11 + 12 + 13


def test_device_cache_bytes_follow_their_owner(monkeypatch):
    import torch

    dc.reset_device_cache()
    cache = dc.DeviceBatchCache(budget=3 * 4096)
    key = f"tenant=hbm{uuid.uuid4().hex[:6]}"

    def hbm():
        return tattr.ledger_snapshot()["scopes"].get(key, {}).get(
            "hbm_bytes", 0.0)

    t = (torch.zeros(1024),)                          # 4096 bytes
    with tattr.scope(tenant=key.split("=")[1]):
        pins = [cache.put(("run-a", i), t) for i in range(3)]
    assert hbm() == 3 * 4096
    for p in pins:
        p.release()
    # another run's put evicts one of the owner's entries: credited back
    cache.put(("run-b", 0), t).release()
    assert hbm() == 2 * 4096
    assert cache.evict_unpinned(run="run-a") == (2, 2 * 4096)
    assert hbm() == 0
    cache.clear()
    # the gauge this cache publishes moved exactly as the owner's row
    from tpudl_torch.obs import metrics

    assert metrics.gauge("data.hbm.bytes_resident").value == 0 == hbm()
    dc.reset_device_cache()
