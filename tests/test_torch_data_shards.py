"""The port's shard cache (``tpudl_torch.data.shards``) against tpudl's: the
key strings, one directory written by either package and read by the
other bit for bit (uint8, float32, uint16 tokens, int32; the shard files
and the manifest byte-equal), bfloat16 one way (the port reads tpudl's
shards, which tpudl's own ``get`` drops — the reference caveat), a
truncated, bit-flipped or deleted shard turned into a counted miss and
re-prepared, two writers' entries merging, ``TPUDL_DATA_VERIFY``, and a
failing write retried under the IO policy and otherwise left cold."""

import json
import os

import ml_dtypes
import numpy as np
import pytest

from tpudl.data import codec as jcodec
from tpudl.data import shards as jshards
from tpudl_torch.data import codec, shards
from tpudl_torch.obs import metrics


def _value(name):
    return metrics.snapshot().get(name, {}).get("value", 0.0)


def _batches():
    rng = np.random.default_rng(0)
    return {
        "uint8": [rng.integers(0, 256, (4, 6, 5, 3), dtype=np.uint8)],
        "float32": [rng.standard_normal((4, 7)).astype(np.float32),
                    rng.standard_normal((4,)).astype(np.float32)],
        "uint16": [rng.integers(0, 65536, (3, 16), dtype=np.uint16)],
        "int32": [rng.integers(-2 ** 31, 2 ** 31 - 1, (3, 9),
                               dtype=np.int32)],
    }


@pytest.mark.parametrize("material,parts", [
    ("abc", {}),
    ("f" * 40, {"cols": "x,y", "batch": 64, "codec": "('u8', 1.0, 0.0)",
                "pack": "default", "finite": False,
                "layout": "map_batches_v1"}),
    ("", {"loader": "native:8x8:s1.0:uint8", "chunk": 256,
          "layout": "uri_load_v1"}),
])
def test_cache_key_equals_tpudls(material, parts):
    assert shards.cache_key(material, **parts) == \
        jshards.cache_key(material, **parts)


def _files(d):
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d)) if n.endswith(".npy")}


@pytest.mark.parametrize("dtype", ["uint8", "float32", "uint16", "int32"])
def test_one_directory_serves_both_packages(tmp_path, dtype):
    arrays = _batches()[dtype]
    # tpudl writes, the port reads
    jc = jshards.ShardCache(str(tmp_path / "a"), "k")
    jc.put(0, arrays)
    jc.put(3, [a[:2] for a in arrays])
    jc.set_meta({"codecs": [["identity"]] * len(arrays)})
    jc.flush()
    ours = shards.ShardCache(str(tmp_path / "a"), "k")
    assert ours.meta == jc.meta and ours.indices() == [0, 3]
    for idx, want in ((0, arrays), (3, [a[:2] for a in arrays])):
        got = ours.get(idx)
        assert [g.dtype for g in got] == [w.dtype for w in want]
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert ours.validate() == []
    # the port writes, tpudl reads
    pc = shards.ShardCache(str(tmp_path / "b"), "k")
    pc.put(0, arrays)
    pc.put(3, [a[:2] for a in arrays])
    pc.set_meta({"codecs": [["identity"]] * len(arrays)})
    pc.flush()
    theirs = jshards.ShardCache(str(tmp_path / "b"), "k")
    got = theirs.get(0)
    assert all(np.array_equal(g, w) for g, w in zip(got, arrays))
    assert theirs.validate() == []
    # and the bytes on disk are the same
    da, db = str(tmp_path / "a" / "k"), str(tmp_path / "b" / "k")
    assert _files(da) == _files(db)
    ma = json.load(open(os.path.join(da, "manifest.json")))
    mb = json.load(open(os.path.join(db, "manifest.json")))
    assert ma == mb


def test_bf16_shards_one_way(tmp_path):
    x = np.random.default_rng(1).standard_normal((5, 8)).astype(np.float32)
    x[0, :3] = [np.nan, np.inf, -0.0]
    want = jcodec.BF16Codec().encode(x)
    assert want.dtype == ml_dtypes.bfloat16
    jc = jshards.ShardCache(str(tmp_path / "a"), "k")
    jc.put(0, [want])
    jc.flush()
    entry = json.load(open(tmp_path / "a" / "k" / "manifest.json"))
    assert entry["shards"]["0"]["files"][0]["dtype"] == "bfloat16"
    # the reference caveat: tpudl's own get drops its bf16 shard ...
    corrupt = _value("data.cache.corrupt")
    assert jshards.ShardCache(str(tmp_path / "a"), "k").get(0) is None
    # ... (tpudl's counters are its own registry; ours stays put)
    assert _value("data.cache.corrupt") == corrupt
    # rewrite it: tpudl's get dropped the entry and its file
    jc = jshards.ShardCache(str(tmp_path / "a"), "k")
    jc.put(0, [want])
    jc.flush()
    got = shards.ShardCache(str(tmp_path / "a"), "k").get(0)
    assert got is not None and got[0].dtype == codec.BF16_BITS
    assert np.array_equal(got[0].view(np.uint16), want.view(np.uint16))
    # the port writes bf16 exactly as tpudl does (header '<V2')
    pc = shards.ShardCache(str(tmp_path / "b"), "k")
    pc.put(0, [codec.BF16Codec().encode(x)])
    pc.flush()
    assert _files(str(tmp_path / "a" / "k")) == \
        _files(str(tmp_path / "b" / "k"))
    ma = json.load(open(tmp_path / "a" / "k" / "manifest.json"))
    mb = json.load(open(tmp_path / "b" / "k" / "manifest.json"))
    assert ma == mb
    back = shards.ShardCache(str(tmp_path / "b"), "k").get(0)[0]
    assert np.array_equal(codec.BF16Codec().decode_array(back).view(
        np.uint32), jcodec.BF16Codec().decode_array(want).view(np.uint32))


def _damage(path, how):
    if how == "truncate":
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) - 3)
    elif how == "bitflip":
        data = bytearray(open(path, "rb").read())
        data[-1] ^= 0x10
        open(path, "wb").write(bytes(data))
    elif how == "header":
        data = bytearray(open(path, "rb").read())
        i = data.index(b"<f4")
        data[i:i + 3] = b"<i4"
        open(path, "wb").write(bytes(data))
    else:
        os.unlink(path)


@pytest.mark.parametrize("how,counter", [
    ("truncate", "data.cache.corrupt"), ("bitflip", "data.cache.corrupt"),
    ("header", "data.cache.corrupt"), ("delete", "data.cache.evicted")])
def test_damaged_shard_is_a_counted_miss_then_re_prepared(tmp_path, how,
                                                          counter):
    arr = np.arange(24, dtype=np.float32).reshape(4, 6)
    c = shards.ShardCache(str(tmp_path), "k")
    c.put(0, [arr])
    path = os.path.join(c.dir, "shard-000000-c0.npy")
    _damage(path, how)
    fresh = shards.ShardCache(str(tmp_path), "k")   # verifies on first read
    before = {k: _value(k) for k in (counter, "data.cache.misses",
                                     "data.cache.hits")}
    assert fresh.get(0) is None
    assert _value(counter) == before[counter] + 1
    assert _value("data.cache.misses") == before["data.cache.misses"] + 1
    assert fresh.indices() == []
    fresh.put(0, [arr])          # the caller re-prepares
    assert np.array_equal(shards.ShardCache(str(tmp_path), "k").get(0)[0],
                          arr)
    assert _value("data.cache.hits") == before["data.cache.hits"] + 1


def test_two_writers_merge(tmp_path):
    a = shards.ShardCache(str(tmp_path), "k")
    b = jshards.ShardCache(str(tmp_path), "k")     # the other package, too
    a.put(0, [np.zeros(3, np.int32)])
    b.put(1, [np.ones(3, np.int32)])
    a.put(2, [np.full(3, 2, np.int32)])
    a.flush()
    both = shards.ShardCache(str(tmp_path), "k")
    assert both.indices() == [0, 1, 2]
    assert [int(both.get(i)[0][0]) for i in range(3)] == [0, 1, 2]
    # a reader that loaded before the other's write still finds it
    late = shards.ShardCache(str(tmp_path), "k")
    b.put(5, [np.full(3, 5, np.int32)])
    assert int(late.get(5)[0][0]) == 5


@pytest.mark.parametrize("policy,second_read", [("first", True),
                                                ("always", False),
                                                ("never", True)])
def test_verify_policy(tmp_path, monkeypatch, policy, second_read):
    monkeypatch.setenv("TPUDL_DATA_VERIFY", policy)
    arr = np.arange(40, dtype=np.float32)
    c = shards.ShardCache(str(tmp_path), "k")
    c.put(0, [arr])
    reader = shards.ShardCache(str(tmp_path), "k")
    assert reader.get(0) is not None              # intact: every policy
    _damage(os.path.join(c.dir, "shard-000000-c0.npy"), "bitflip")
    # same size: only a crc pass can see the flip
    assert (reader.get(0) is not None) == second_read
    assert jshards._verify_policy() == shards._verify_policy() == policy


def test_validate_and_clear(tmp_path):
    c = shards.ShardCache(str(tmp_path), "k")
    for i in range(3):
        c.put(i, [np.full(4, i, np.int64)])
    _damage(os.path.join(c.dir, "shard-000001-c0.npy"), "bitflip")
    os.unlink(os.path.join(c.dir, "shard-000002-c0.npy"))
    errs = c.validate()
    assert errs == jshards.ShardCache(str(tmp_path), "k").validate()
    assert len(errs) == 2 and "crc mismatch" in errs[0] \
        and "missing file" in errs[1]
    c.clear()
    assert len(c) == 0
    assert not [n for n in os.listdir(c.dir) if n.endswith(".npy")]


def test_failing_write_retries_then_stays_cold(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUDL_RETRY_IO_BACKOFF_S", "0")
    real = shards._save_npy
    fails = {"n": 2}

    def flaky(f, arr):
        if fails["n"] > 0:
            fails["n"] -= 1
            raise OSError("disk hiccup")
        real(f, arr)

    monkeypatch.setattr(shards, "_save_npy", flaky)
    retries = _value("retry.data.cache.write")
    c = shards.ShardCache(str(tmp_path), "k")
    c.put(0, [np.arange(3)])
    assert _value("retry.data.cache.write") == retries + 2
    assert np.array_equal(c.get(0)[0], np.arange(3))
    fails["n"] = 10
    c.put(1, [np.arange(4)])      # every attempt fails: no raise, cold
    assert c.get(1) is None and c.indices() == [0]
    assert not [n for n in os.listdir(c.dir) if ".tmp." in n]


def test_foreign_manifest_starts_empty(tmp_path):
    c = shards.ShardCache(str(tmp_path), "k")
    c.put(0, [np.arange(3)])
    path = os.path.join(c.dir, "manifest.json")
    m = json.load(open(path))
    m["key"] = "other"
    json.dump(m, open(path, "w"))
    assert len(shards.ShardCache(str(tmp_path), "k")) == 0
    open(path, "w").write("{not json")
    assert len(shards.ShardCache(str(tmp_path), "k")) == 0
