"""The port's device-memory batch cache (``tpudl_torch.data.device_cache``)
on CPU tensors, held to tpudl's: the cache mechanics run the same script
in both packages (LRU and pins, run-scoped eviction, dedup, the budget and
``TPUDL_DATA_HBM_BUDGET_MB=0``, ``bulk_resident``, ``array_token``), and
``Frame.map_batches(device_cache=True)`` replays resident batches with no
pack, no wire bytes and outputs bit for bit equal to the uncached run —
with tpudl's tiny-budget, cross-run and restart cases. ``budget_bytes``
falls back to ``DEFAULT_BUDGET_BYTES`` without a card and never
initializes CUDA under ``allow_device=False``."""

import numpy as np
import pytest
import torch

from tpudl.data import device_cache as jdc
from tpudl_torch.data import device_cache as dc
from tpudl_torch.frame import Frame
from tpudl_torch.obs import last_pipeline_report, metrics

PKGS = {"port": dc, "tpudl": jdc}


def _snap(name):
    return metrics.snapshot().get(name, {}).get("value", 0.0)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for k in ("TPUDL_DATA_HBM_BUDGET_MB", "TPUDL_DATA_DEVICE_CACHE",
              "TPUDL_WIRE_CODEC", "TPUDL_DATA_CACHE_DIR"):
        monkeypatch.delenv(k, raising=False)
    dc.reset_device_cache()
    jdc.reset_device_cache()
    yield
    dc.reset_device_cache()
    jdc.reset_device_cache()


def _arrs(pkg, nbytes):
    if pkg is dc:
        return [torch.zeros(nbytes, dtype=torch.uint8)]
    return [np.zeros(nbytes, np.uint8)]


@pytest.mark.parametrize("name", PKGS)
def test_put_get_lru_and_bytes(name):
    m = PKGS[name]
    c = m.DeviceBatchCache(budget=1000)
    for i in range(3):
        c.put(("k", i), _arrs(m, 200)).release()
    assert c.bytes_resident == 600 and len(c) == 3
    hit = c.get(("k", 1))
    assert hit is not None and hit.nbytes == 200
    hit.release()
    assert c.get(("k", 99)) is None


@pytest.mark.parametrize("name", PKGS)
def test_cross_run_eviction_is_lru(name):
    m = PKGS[name]
    c = m.DeviceBatchCache(budget=500)
    for i in range(2):
        c.put(("a", i), _arrs(m, 200)).release()
    c.get(("a", 0)).release()           # ("a", 1) becomes LRU
    c.put(("b", 0), _arrs(m, 200)).release()
    assert c.get(("a", 1)) is None
    c.get(("a", 0)).release()
    assert c.bytes_resident == 400


@pytest.mark.parametrize("name", PKGS)
def test_same_run_never_evicts_itself(name):
    m = PKGS[name]
    c = m.DeviceBatchCache(budget=500)
    for i in range(2):
        c.put(("a", i), _arrs(m, 200)).release()
    assert not c.would_fit(200, run="a")
    assert c.put(("a", 2), _arrs(m, 200)) is None
    for i in range(2):
        c.get(("a", i)).release()
    assert c.would_fit(200, run="b")


@pytest.mark.parametrize("name", PKGS)
def test_dedup_pins_and_idempotent_release(name):
    m = PKGS[name]
    c = m.DeviceBatchCache(budget=1000)
    p1 = c.put(("k", 0), _arrs(m, 200))
    p2 = c.put(("k", 0), _arrs(m, 200))
    assert p2._entry is p1._entry and c.bytes_resident == 200
    assert c._entries[("k", 0)].pins == 2
    p1.release()
    p1.release()                        # one token: one decrement
    assert c._entries[("k", 0)].pins == 1
    p2.release()
    assert c._entries[("k", 0)].pins == 0


@pytest.mark.parametrize("name", PKGS)
def test_pinned_entries_never_evict(name):
    m = PKGS[name]
    c = m.DeviceBatchCache(budget=500)
    pin = c.put(("a", 0), _arrs(m, 300))
    assert not c.would_fit(300, run="b")
    assert c.put(("b", 0), _arrs(m, 300)) is None
    assert c.put(("c", 0), _arrs(m, 600)) is None     # oversized: refused
    pin.release()
    assert c.would_fit(300, run="b")
    assert c.evict_unpinned() == (1, 300) and c.bytes_resident == 0


@pytest.mark.parametrize("name", PKGS)
def test_budget_zero_means_zero(name, monkeypatch):
    m = PKGS[name]
    monkeypatch.setenv("TPUDL_DATA_HBM_BUDGET_MB", "0")
    c = m.DeviceBatchCache()
    assert c.budget == 0 and c.put(("k", 0), _arrs(m, 1)) is None
    monkeypatch.setenv("TPUDL_DATA_HBM_BUDGET_MB", "3")
    assert m.budget_bytes() == 3 << 20


def test_budget_without_a_card(monkeypatch):
    monkeypatch.setattr(dc, "_BUDGET_CACHE", {})
    called = []
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda *a: called.append(a))
    assert dc.budget_bytes(allow_device=False) is None
    assert not called
    assert dc.budget_bytes() == dc.DEFAULT_BUDGET_BYTES
    assert dc.budget_bytes(allow_device=False) == dc.DEFAULT_BUDGET_BYTES
    assert not called                   # no card: never asked
    assert dc.DEFAULT_BUDGET_BYTES == jdc.DEFAULT_BUDGET_BYTES
    assert dc.DEFAULT_BUDGET_FRACTION == jdc.DEFAULT_BUDGET_FRACTION
    assert dc.run_key("abc") == jdc.run_key("abc", None)
    # the port's key also names the device the entries live on
    assert (dc.run_key("abc", device="cpu")
            == jdc.run_key("abc", None) + "|dev=cpu")
    assert (dc.run_key("abc", device="cuda:1")
            != dc.run_key("abc", device="cuda:0"))
    # under a mesh (once refused, 'Training, rest'): tpudl's topology,
    # then the mesh's devices in order
    import jax

    from tpudl import mesh as jax_mesh
    from tpudl_torch import mesh as M

    mesh = M.build_mesh(devices=["cpu"] * 2)
    jmesh = jax_mesh.build_mesh(devices=jax.devices()[:2])
    assert dc.run_key("abc", mesh) == "abc|mesh=data=2,model=1|dev=cpu,cpu"
    assert (dc.run_key("abc", mesh).split("|dev=")[0]
            == jdc.run_key("abc", jmesh).split("|dev=")[0])


@pytest.mark.parametrize("name", PKGS)
def test_bulk_resident_rehit_budget_and_release(name, monkeypatch):
    m = PKGS[name]
    monkeypatch.setenv("TPUDL_DATA_HBM_BUDGET_MB", "1")
    m.reset_device_cache()
    X = np.arange(1000, dtype=np.float32).reshape(100, 10)
    key = (f"bulk|{m.array_token(X)}", 0)
    pin = m.bulk_resident(key, (X,), **({"device": "cpu"} if m is dc
                                        else {}))
    assert pin is not None
    assert np.array_equal(np.asarray(pin.arrays[0]), X)
    again = m.bulk_resident(key, (X,))
    assert again.arrays[0] is pin.arrays[0]           # resident rehit
    again.release()
    pin.release()
    big = np.zeros((1 << 19,), np.float32)            # 2 MB > 1 MB
    assert m.bulk_resident((f"bulk|{m.array_token(big)}", 0),
                           (big,)) is None
    m.get_device_cache().clear()
    a = np.zeros((180_000,), np.float32)              # ~0.7 MB each
    pa = m.bulk_resident((f"bulk|{m.array_token(a)}", 0), (a,))
    pa.release()                                      # the fit finished
    b = np.ones((180_000,), np.float32)
    pb = m.bulk_resident((f"bulk|{m.array_token(b)}", 0), (b,))
    assert pb is not None                             # evicted a's bulk
    assert m.get_device_cache().get((f"bulk|{m.array_token(a)}", 0)) \
        is None
    pb.release()
    if m is dc:
        assert m.get_device_cache().bytes_pinned == 0


def test_array_token_equals_tpudls_and_rekeys_on_mutation():
    X = np.random.default_rng(0).standard_normal((64, 8)).astype(np.float32)
    t = dc.array_token(X)
    assert t == jdc.array_token(X)
    assert dc.array_token(X) == t and id(X) in dc._TOKEN_MEMO
    X[0, 0] += 1.0                      # in place, inside the probe
    assert dc.array_token(X) != t
    assert dc.array_token(X) == jdc.array_token(X.copy())
    assert dc.array_token(X[:, ::2]) == jdc.array_token(X[:, ::2])


def test_place_counts_out_of_memory(monkeypatch):
    before = _snap("data.hbm.put_failed")
    t = torch.zeros(3)

    def oom(*a, **k):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(torch.Tensor, "to", oom)
    assert dc.place([t], "cpu") is None
    assert _snap("data.hbm.put_failed") == before + 1


# -- through the executor -----------------------------------------------------

def _frame(n=48, cols=6, seed=7):
    rng = np.random.default_rng(seed)
    return Frame({"x": rng.integers(0, 256, size=(n, cols)).astype(
        np.float32)})


def _fn(b):
    return (b * 3.0 + 0.5).sum(dim=1)


def _run(f, **kw):
    kw.setdefault("batch_size", 8)
    out = f.map_batches(_fn, ["x"], ["y"], device="cpu", **kw)
    return np.asarray(list(out["y"]), np.float32)


@pytest.mark.parametrize("codec", [None, "u8", "bf16"])
@pytest.mark.parametrize("depth,fuse", [(1, 1), (2, 1), (3, 4)])
def test_resident_replay_is_bitwise_and_ships_nothing(codec, depth, fuse):
    f = _frame()
    ref = _run(f, wire_codec=codec, dispatch_depth=depth, fuse_steps=fuse)
    calls = {"n": 0}

    def pack(sl):
        calls["n"] += 1
        return np.asarray(sl)

    pack.cache_token = "identity-pack"
    kw = dict(wire_codec=codec, device_cache=True, dispatch_depth=depth,
              fuse_steps=fuse, pack=pack)
    assert np.array_equal(_run(f, **kw), ref)          # epoch 1 populates
    rep = last_pipeline_report()
    assert rep["device_cache"] is True and rep["fuse_steps"] == 1
    shipped, hits = _snap("data.wire.bytes_shipped"), _snap("data.hbm.hits")
    n0 = calls["n"]
    assert np.array_equal(_run(f, **kw), ref)          # epoch 2: resident
    assert calls["n"] == n0
    assert _snap("data.wire.bytes_shipped") == shipped
    assert _snap("data.hbm.hits") - hits == 6
    rep = last_pipeline_report()
    assert rep["stage_calls"].get("hbm_hits") == 6
    assert "bytes_prepared" not in rep["stage_calls"]
    assert "h2d" not in rep["stage_seconds"]
    assert dc.get_device_cache().bytes_pinned == 0


def test_tiny_budget_keeps_its_prefix(monkeypatch):
    f = _frame(n=48)      # 6 batches × 8 rows × 6 cols × 4 B = 192 B each
    monkeypatch.setenv("TPUDL_DATA_HBM_BUDGET_MB", str(2.5 * 192 / (1 << 20)))
    dc.reset_device_cache()
    ref = _run(f)
    ev0 = _snap("data.hbm.evictions")
    assert np.array_equal(_run(f, device_cache=True), ref)
    assert _snap("data.hbm.evictions") == ev0          # no self-thrash
    assert dc.get_device_cache().bytes_resident == 2 * 192
    hits0 = _snap("data.hbm.hits")
    assert np.array_equal(_run(f, device_cache=True), ref)
    assert _snap("data.hbm.hits") - hits0 == 2          # the resident head


def test_cross_run_eviction_reships_transparently(monkeypatch):
    f1, f2 = _frame(n=16, seed=7), _frame(n=16, seed=11)
    monkeypatch.setenv("TPUDL_DATA_HBM_BUDGET_MB", str(2.5 * 192 / (1 << 20)))
    dc.reset_device_cache()
    ref1 = _run(f1)
    _run(f1, device_cache=True)
    ev0 = _snap("data.hbm.evictions")
    _run(f2, device_cache=True)
    assert _snap("data.hbm.evictions") > ev0
    assert np.array_equal(_run(f1, device_cache=True), ref1)


def test_budget_zero_runs_uncached(monkeypatch):
    monkeypatch.setenv("TPUDL_DATA_HBM_BUDGET_MB", "0")
    dc.reset_device_cache()
    f = _frame()
    ref = _run(f)
    assert np.array_equal(_run(f, device_cache=True), ref)
    assert dc.get_device_cache().bytes_resident == 0
    hits = _snap("data.hbm.hits")
    assert np.array_equal(_run(f, device_cache=True), ref)
    assert _snap("data.hbm.hits") == hits


def test_restart_falls_back_to_the_shard_cache(tmp_path):
    f = _frame()
    ref = _run(f)
    kw = dict(device_cache=True, cache_dir=str(tmp_path), wire_codec="u8")
    assert np.array_equal(_run(f, **kw), ref)
    dc.reset_device_cache()                             # a new process
    hits = _snap("data.cache.hits")
    assert np.array_equal(_run(f, **kw), ref)           # disk, re-resident
    assert _snap("data.cache.hits") - hits == 6
    hbm = _snap("data.hbm.hits")
    assert np.array_equal(_run(f, **kw), ref)
    assert _snap("data.hbm.hits") - hbm == 6


def test_env_arms_and_degrades_on_unfingerprintable_frame(monkeypatch):
    from tpudl_torch.frame.frame import LazyColumn

    class NoFp(LazyColumn):
        def __init__(self, arrs):
            self._a = arrs

        def __len__(self):
            return len(self._a)

        def _get(self, idx):
            out = np.empty(len(idx), dtype=object)
            out[:] = [self._a[i] for i in idx]
            return out

    rng = np.random.default_rng(0)
    f = Frame({"x": NoFp([rng.random(4).astype(np.float32)
                          for _ in range(16)])})
    monkeypatch.setenv("TPUDL_DATA_DEVICE_CACHE", "1")
    out = f.map_batches(lambda b: b.sum(dim=1), ["x"], ["y"], batch_size=8,
                        device="cpu")
    assert len(out["y"]) == 16
    assert last_pipeline_report()["device_cache"] is False
    with pytest.raises(ValueError, match="cache_key"):
        f.map_batches(lambda b: b.sum(dim=1), ["x"], ["y"], batch_size=8,
                      device="cpu", device_cache=True)
    _run(_frame())                      # the env arms a plain frame
    assert last_pipeline_report()["device_cache"] is True
    monkeypatch.setenv("TPUDL_FRAME_PREFETCH", "0")
    _run(_frame())                      # the serial arm stays uncached
    assert last_pipeline_report()["device_cache"] is False
