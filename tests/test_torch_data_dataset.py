"""The port's ``Dataset`` facade, ``cached_uri_load`` and ``lm_dataset``
against tpudl's on the same frames: batches bit for bit over epochs,
``retain``, the shard cache and the device cache; ``device_restore`` and
``wrap``; a URI-load cache either package filled replayed by the other
with zero decodes (float32 and uint8 loaders); ``lm_dataset`` batches bit
for bit, the first loss of a small ``TinyCausalLM`` fed through
``ds.wrap`` within 2e-5 of tpudl's, and a resident two-epoch
``Trainer.fit`` whose second epoch tokenizes and ships nothing, with
losses bit for bit equal to the same steps fed int32 tokens directly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudl.data import Dataset as JaxDataset
from tpudl.data import cached_uri_load as jax_cached_uri_load
from tpudl.frame import Frame as JaxFrame
from tpudl.image import imageIO as jio
from tpudl.text import ByteTokenizer as JaxByte
from tpudl.text import lm_dataset as jax_lm_dataset
from tpudl.zoo.transformer import TinyCausalLM as JaxLM
from tpudl_torch.data import Dataset, cached_uri_load
from tpudl_torch.data import device_cache as dc
from tpudl_torch.frame import Frame
from tpudl_torch.image import imageIO
from tpudl_torch.obs import metrics
from tpudl_torch.text import ByteTokenizer, lm_dataset
from tpudl_torch.train import Trainer, sgd
from tpudl_torch.zoo.transformer import TinyCausalLM
from torch_native_fixture import private_tpudl_decoder  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("private_tpudl_decoder")

torch.set_num_threads(1)
LOSS_TOL = 2e-5
ARCH = dict(vocab=260, dim=64, heads=4, layers=2, max_len=64)


def _snap(name):
    return metrics.snapshot().get(name, {}).get("value", 0.0)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.setenv("TPUDL_WIRE_MBPS", "100000")   # same auto picks
    dc.reset_device_cache()
    yield
    dc.reset_device_cache()


def _cols(n=20, seed=3):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 256, (n, 4, 5, 3), dtype=np.uint8)
    return {"img": q.astype(np.float32) * np.float32(1 / 255),
            "u8": q, "f": rng.standard_normal((n, 7)).astype(np.float32)}


def _host(batch):
    return [np.asarray(b) for b in batch]


@pytest.mark.parametrize("codec", [None, "u8", "auto", "bf16"])
@pytest.mark.parametrize("mode", ["plain", "retain", "cache"])
def test_batches_equal_tpudls(tmp_path, codec, mode):
    cols = ["img", "u8"] if codec == "u8" else ["img", "f", "u8"]
    kw = dict(batch_size=6, wire_codec=codec)
    if mode == "retain":
        kw["retain"] = True
    if mode == "cache":
        kw["cache_dir"] = str(tmp_path / "ours")
    ours = Dataset(Frame(_cols()), cols, **kw)
    if mode == "cache":
        kw["cache_dir"] = str(tmp_path / "theirs")
    theirs = JaxDataset(JaxFrame(_cols()), cols, **kw)
    assert ours.num_batches == theirs.num_batches == 4
    for epoch in range(2):
        got = [_host(b) for b in ours.iter_epoch(epoch)]
        want = [_host(b) for b in theirs.iter_epoch(epoch)]
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                assert a.shape == b.shape
                assert np.array_equal(a.view(np.uint8), b.view(np.uint8))
    if codec is not None:
        assert ours.plan.keys() == theirs.plan.keys()
        for g, w in zip(ours.device_restore(ours.get_batch(1)),
                        theirs.device_restore(theirs.get_batch(1))):
            assert np.array_equal(g.view(np.uint8), np.asarray(w).view(
                np.uint8))
    if mode == "cache":
        # a fresh Dataset over the other package's directory replays it
        again = Dataset(Frame(_cols()), cols, batch_size=6,
                        wire_codec=codec,
                        cache_dir=str(tmp_path / "theirs"))
        hits = _snap("data.cache.hits")
        for g, w in zip(again.iter_epoch(), theirs.iter_epoch()):
            assert all(np.array_equal(np.asarray(a).view(np.uint8),
                                      np.asarray(b).view(np.uint8))
                       for a, b in zip(g, w))
        assert _snap("data.cache.hits") - hits == 4


def test_retain_and_shipping_accounting():
    f = Frame(_cols())
    packs = {"n": 0}

    def pack(sl):
        packs["n"] += 1
        return np.stack(list(sl)) if sl.dtype == object else np.asarray(sl)

    ds = Dataset(f, ["u8"], batch_size=5, wire_codec="u8", pack=pack,
                 retain=True)
    shipped = _snap("data.wire.bytes_shipped")
    list(ds.iter_epoch(0))
    list(ds.iter_epoch(1))
    assert packs["n"] == 4                 # epoch 1 replays from memory
    assert _snap("data.wire.bytes_shipped") - shipped == 2 * 20 * 60
    plain = Dataset(f, ["u8"], batch_size=5, pack=pack)
    list(plain.iter_epoch(0))
    list(plain.iter_epoch(1))
    assert packs["n"] == 12                # no retain: re-prepare


def test_wrap_restores_before_the_function():
    ds = Dataset(Frame(_cols()), ["u8", "f"], batch_size=8,
                 wire_codec="auto")
    jds = JaxDataset(JaxFrame(_cols()), ["u8", "f"], batch_size=8,
                     wire_codec="auto")
    step = ds.wrap(lambda x, y: x.sum() + y.sum())   # resolves by probing
    jstep = jds.wrap(jax.jit(lambda x, y: x.sum() + y.sum()))
    shipped = _snap("data.wire.bytes_shipped")
    b = ds.get_batch(0)
    assert _snap("data.wire.bytes_shipped") > shipped   # the probe did not
    got = step(*(torch.from_numpy(np.asarray(a)) for a in b))
    want = jstep(*jds.get_batch(0))
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
    assert ds.wrap(len) is not len and Dataset(
        Frame(_cols()), ["f"]).wrap(len) is len


@pytest.mark.parametrize("codec", [None, "u8"])
def test_device_cache_epoch2_ships_zero(codec):
    ds = Dataset(Frame(_cols(n=24)), ["u8"], batch_size=8, wire_codec=codec,
                 device_cache=True, device="cpu")
    first = [b[0] for b in ds.iter_epoch(0)]
    assert all(isinstance(t, torch.Tensor) for t in first)
    shipped, hits = _snap("data.wire.bytes_shipped"), _snap("data.hbm.hits")
    again = [b[0] for b in ds.iter_epoch(1)]
    assert _snap("data.wire.bytes_shipped") == shipped
    assert _snap("data.hbm.hits") - hits == 3
    assert all(a is b for a, b in zip(first, again))
    jds = JaxDataset(JaxFrame(_cols(n=24)), ["u8"], batch_size=8,
                     wire_codec=codec)
    want = [np.asarray(b[0]) for b in jds.iter_epoch(0)]
    assert all(np.array_equal(t.numpy(), w) for t, w in zip(again, want))
    restored = np.asarray(ds.device_restore((again[0],))[0])
    assert restored.dtype == (np.float32 if codec else np.uint8)
    assert np.array_equal(restored, jds.device_restore((want[0],))[0])
    # under a mesh (once refused, 'Training, rest') the resident batch is
    # its per-entry shards, whose rows are the same batch
    from tpudl_torch import mesh as M

    sharded = Dataset(Frame(_cols(n=24)), ["u8"], batch_size=8,
                      wire_codec=codec, device_cache=True,
                      mesh=M.build_mesh(devices=["cpu"] * 2))
    got = [b[0] for b in sharded.iter_epoch(1)]
    assert all(isinstance(b, M.Sharded) and len(b) == 2 for b in got)
    assert all(np.array_equal(torch.cat(list(b)).numpy(), w)
               for b, w in zip(got, want))
    with pytest.raises(RuntimeError, match="cuda"):   # the default: a card
        Dataset(Frame(_cols()), ["u8"], device_cache=True)


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("jpegs")
    rng = np.random.default_rng(0)
    paths = []
    for i in range(7):
        p = str(d / f"img{i}.jpg")
        Image.fromarray(rng.integers(0, 256, (30 + i, 41, 3),
                                     dtype=np.uint8)).save(p)
        paths.append(p)
    return paths


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize("writer", ["tpudl", "port"])
def test_cached_uri_load_serves_both_packages(tmp_path, jpegs, dtype,
                                              writer):
    ours = imageIO.createNativeImageLoader(12, 10, scale=1 / 255,
                                           output_dtype=dtype)
    theirs = jio.createNativeImageLoader(12, 10, scale=1 / 255,
                                         output_dtype=dtype)
    d = str(tmp_path)
    if writer == "tpudl":
        want = jax_cached_uri_load(theirs, jpegs, d, chunk=3)
    else:
        want = cached_uri_load(ours, jpegs, d, chunk=3)
    assert want.dtype == np.dtype(dtype) and want.shape == (7, 12, 10, 3)
    decodes = _snap("imageio.uris_loaded")
    if writer == "tpudl":
        got = cached_uri_load(ours, jpegs, d, chunk=3)
        assert _snap("imageio.uris_loaded") == decodes   # zero decodes
    else:
        got = jax_cached_uri_load(theirs, jpegs, d, chunk=3)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    fresh = imageIO.createNativeImageLoader(12, 10, scale=1 / 255,
                                            output_dtype=dtype)
    assert np.array_equal(fresh.batch_decode(jpegs), want)


# -- lm_dataset ---------------------------------------------------------------

def _texts(n=24, seed=5):
    rng = np.random.default_rng(seed)
    out = np.empty(n, dtype=object)
    out[:] = [" ".join(f"w{int(t)}" for t in rng.integers(0, 50, 4 + i % 9))
              for i in range(n)]
    return out


def test_lm_dataset_batches_equal_tpudls(tmp_path):
    kw = dict(seq_len=16, batch_size=6)
    ours = lm_dataset(Frame({"text": _texts()}), "text", ByteTokenizer(),
                      cache_dir=str(tmp_path / "a"), **kw)
    theirs = jax_lm_dataset(JaxFrame({"text": _texts()}), "text",
                            JaxByte(), cache_dir=str(tmp_path / "a"), **kw)
    assert ours.plan.codecs[0].key() == ("tokens", 0, 260, "u16")
    calls = _snap("text.tokenize.calls")
    got = [b[0] for b in ours.iter_epoch(0)]
    assert _snap("text.tokenize.calls") - calls == 4
    # tpudl replays the port's shards (same key): equal bits
    want = [np.asarray(b[0]) for b in theirs.iter_epoch(0)]
    assert theirs.cache is not None and len(theirs.cache) == 4
    cold = [np.asarray(b[0]) for b in jax_lm_dataset(
        JaxFrame({"text": _texts()}), "text", JaxByte(), **kw).iter_epoch(0)]
    for g, w, c in zip(got, want, cold):
        assert g.dtype == np.uint16 == w.dtype
        assert np.array_equal(g, w) and np.array_equal(g, c)
    again = lm_dataset(Frame({"text": _texts()}), "text", ByteTokenizer(),
                       cache_dir=str(tmp_path / "a"), **kw)
    list(again.iter_epoch(0))
    assert _snap("text.tokenize.calls") - calls == 4   # warm: none


def test_lm_first_loss_through_wrap_matches_tpudl():
    params = JaxLM(**ARCH).init(0)
    kw = dict(seq_len=33, batch_size=8)
    ds = lm_dataset(Frame({"text": _texts()}), "text", ByteTokenizer(), **kw)
    jds = jax_lm_dataset(JaxFrame({"text": _texts()}), "text", JaxByte(),
                         **kw)
    model = TinyCausalLM.from_jax_params(params, device="cpu", **ARCH)
    loss = ds.wrap(model.loss_fn())
    jparams = jax.tree.map(jnp.asarray, params)
    jloss = jds.wrap(jax.jit(lambda tokens: JaxLM(**ARCH).loss_fn()(
        jparams, tokens)))
    for i in range(ds.num_batches):
        b = ds.get_batch(i)[0]
        assert b.dtype == np.uint16
        with torch.no_grad():
            got = float(loss(model, torch.from_numpy(b)))
        want = float(jloss(jds.get_batch(i)[0]))
        assert abs(got - want) <= LOSS_TOL, (i, got, want)


def test_resident_two_epoch_fit_matches_direct_tokens():
    arch = dict(ARCH, dim=32)
    params = JaxLM(**arch).init(1)
    ds = lm_dataset(Frame({"text": _texts(32)}), "text", ByteTokenizer(),
                    seq_len=17, batch_size=8, device_cache=True,
                    device="cpu")
    nb = ds.num_batches
    model = TinyCausalLM.from_jax_params(params, device="cpu", **arch)
    trainer = Trainer(ds.wrap(model.loss_fn()), sgd(0.5), log_every=1)
    _, opt, hist1 = trainer.fit(model, lambda s: ds.get_batch(s % nb), nb)
    calls = _snap("text.tokenize.calls")
    shipped = _snap("data.wire.bytes_shipped")
    _, _, hist2 = trainer.fit(model, lambda s: ds.get_batch(s % nb), 2 * nb,
                              opt_state=opt)
    assert _snap("text.tokenize.calls") == calls
    assert _snap("data.wire.bytes_shipped") == shipped
    # the same steps on int32 tokens fed directly, with no dataset
    direct = [np.asarray(lm_dataset(
        Frame({"text": _texts(32)}), "text", ByteTokenizer(), seq_len=17,
        batch_size=8).get_batch(i)[0]).astype(np.int32) for i in range(nb)]
    ref = TinyCausalLM.from_jax_params(params, device="cpu", **arch)
    rt = Trainer(ref.loss_fn(), sgd(0.5), log_every=1)
    _, ropt, r1 = rt.fit(ref, lambda s: direct[s % nb], nb)
    _, _, r2 = rt.fit(ref, lambda s: direct[s % nb], 2 * nb,
                      opt_state=ropt)
    assert [h["loss"] for h in hist1 + hist2] == \
        [h["loss"] for h in r1 + r2]
