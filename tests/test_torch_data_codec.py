"""The port's wire codecs (``tpudl_torch.data.codec``) against tpudl's on
the same batches: ``encode`` bit for bit (bfloat16 bits against
``ml_dtypes`` over ±0, subnormals, ±inf, NaN, halfway cases and random
values), each ``prologue`` against tpudl's under ``jnp`` and against
``decode_array`` bit for bit (a nonzero offset too), the key strings,
``resolve_codec``'s names and errors, ``CodecPlan``'s per-column picks
and ``adopt``, ``U8Codec.infer``, and ``TokenCodec``'s wire type
(``wire_dtype=``, ``TPUDL_TEXT_WIRE_DTYPE``). Exact equality throughout,
except where tpudl's jitted prologue may fuse a multiply-add (1 ulp, as
tpudl documents)."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tpudl.data import codec as jcodec
from tpudl.text import codec as jtext
from tpudl_torch.data import codec
from tpudl_torch.frame import Frame
from tpudl_torch.text import codec as text

SCALES = [(1.0, 0.0), (1 / 255, 0.0), (1 / 255, 0.5), (2.0 ** -7, -1.0)]


def _u8_batch(seed, shape=(3, 5, 7, 3)):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


def _special_f32():
    bits = np.array([0x00000000, 0x80000000,          # ±0
                     0x00000001, 0x807FFFFF,          # subnormals
                     0x00400000, 0x00008000,          # subnormal halfway
                     0x7F800000, 0xFF800000,          # ±inf
                     0x7FC00000, 0xFFC00001,          # NaNs
                     0x7F800001, 0x7FBFFFFF,          # signalling NaNs
                     0x3F808000, 0x3F818000,          # halfway: even, odd
                     0x3F808001, 0x3F817FFF,          # just past/short
                     0x7F7FFFFF, 0xFF7FFFFF,          # ±max: round to inf
                     0x7F7F7FFF, 0x00800000],         # below max, min normal
                    dtype=np.uint32)
    rnd = np.random.default_rng(0).standard_normal(4096).astype(np.float32)
    wide = (np.random.default_rng(1).integers(0, 2 ** 32, 4096,
                                              dtype=np.uint64)
            .astype(np.uint32).view(np.float32))
    return np.concatenate([bits.view(np.float32), rnd * 1e3, wide])


def test_bf16_bits_equal_ml_dtypes():
    x = _special_f32()
    got = codec.BF16Codec().encode(x)
    assert got.dtype == codec.BF16_BITS
    want = jcodec.BF16Codec().encode(x)
    assert want.dtype == ml_dtypes.bfloat16
    assert np.array_equal(got.view(np.uint16), want.view(np.uint16))
    # and the restore: the exact float32 of each bfloat16, NaN stays NaN
    back = codec.BF16Codec().decode_array(got)
    jback = jcodec.BF16Codec().decode_array(want)
    assert np.array_equal(back.view(np.uint32), jback.view(np.uint32))


def test_bf16_prologue_equals_decode_and_tpudl():
    x = _special_f32().reshape(-1, 4)
    c = codec.BF16Codec()
    enc = c.encode(x)
    got = c.prologue(codec.host_tensor(enc)).numpy()
    assert np.array_equal(got.view(np.uint32),
                          c.decode_array(enc).view(np.uint32))
    jgot = np.asarray(jcodec.BF16Codec().prologue(
        jnp.asarray(jcodec.BF16Codec().encode(x))))
    assert np.array_equal(got.view(np.uint32), jgot.view(np.uint32))
    # uint8 passes through bf16 untouched, as in tpudl
    u8 = _u8_batch(2)
    assert np.array_equal(codec.BF16Codec().encode(u8),
                          jcodec.BF16Codec().encode(u8))


@pytest.mark.parametrize("scale,offset", SCALES)
def test_u8_encode_and_prologue_bitwise(scale, offset):
    q = _u8_batch(3)
    c, jc = codec.U8Codec(scale, offset), jcodec.U8Codec(scale, offset)
    assert c.key() == jc.key()
    dense = jc.decode_array(q)                 # what a float32 loader gives
    assert np.array_equal(c.decode_array(q), dense)
    assert np.array_equal(c.encode(dense), jc.encode(dense))
    assert np.array_equal(c.encode(dense), q)
    restored = c.prologue(torch.from_numpy(q)).numpy()
    assert restored.dtype == np.float32
    assert np.array_equal(restored.view(np.uint32), dense.view(np.uint32))
    # tpudl's prologue under eager jnp is the same two operations
    eager = np.asarray(jc.prologue(jnp.asarray(q)))
    assert np.array_equal(eager.view(np.uint32), dense.view(np.uint32))
    # jitted, XLA may fuse the multiply-add: tpudl allows 1 ulp there
    jitted = np.asarray(jax.jit(jc.prologue)(jnp.asarray(q)))
    ulps = np.abs(jitted.view(np.int32).astype(np.int64)
                  - dense.view(np.int32).astype(np.int64)).max()
    assert ulps <= (0 if offset == 0.0 else 1)


def test_u8_refuses_what_tpudl_refuses():
    bad = [np.float32([[0.5, 1.25]]), np.float32([[-1.0]]),
           np.float32([[300.0]]), np.arange(4, dtype=np.int32)]
    for arr in bad:
        with pytest.raises(codec.CodecError):
            codec.U8Codec(1.0).encode(arr)
        with pytest.raises(jcodec.CodecError):
            jcodec.U8Codec(1.0).encode(arr)
    with pytest.raises(codec.CodecError, match="nonzero"):
        codec.U8Codec(0.0)
    with pytest.raises(codec.CodecError, match="uint8/float32"):
        codec.BF16Codec().encode(np.arange(3, dtype=np.float64))


@pytest.mark.parametrize("case", ["uint8", "scale1", "scale255", "black",
                                  "not_exact", "int32", "empty"])
def test_u8_infer_matches_tpudl(case):
    q = _u8_batch(4).astype(np.float32)
    arr = {"uint8": _u8_batch(4), "scale1": q,
           "scale255": q * np.float32(1 / 255),
           "black": np.zeros((2, 3), np.float32),
           "not_exact": q * np.float32(0.3),
           "int32": np.arange(6, dtype=np.int32),
           "empty": np.zeros((0, 3), np.float32)}[case]
    got, want = codec.U8Codec.infer(arr), jcodec.U8Codec.infer(arr)
    assert (got is None) == (want is None)
    if got is not None:
        assert got.key() == want.key()


@pytest.mark.parametrize("spec", ["u8", "auto", "identity", "bf16",
                                  "tokens", None,
                                  codec.U8Codec(1 / 255, 0.25)])
def test_spec_token_and_resolve_match_tpudl(spec):
    jspec = (jcodec.U8Codec(1 / 255, 0.25)
             if isinstance(spec, codec.WireCodec) else spec)
    assert codec.spec_token(spec) == jcodec.spec_token(jspec)
    got, want = codec.resolve_codec(spec), jcodec.resolve_codec(jspec)
    if isinstance(want, jcodec.WireCodec):
        assert type(got).__name__ == type(want).__name__
        assert got.key() == want.key()
        assert codec.spec_token(got) == jcodec.spec_token(want)
    else:
        assert got == want


def test_resolve_codec_errors_match_tpudl():
    for bad in ("gzip", 3):
        with pytest.raises(codec.CodecError) as ours:
            codec.resolve_codec(bad)
        with pytest.raises(jcodec.CodecError) as theirs:
            jcodec.resolve_codec(bad)
        assert str(ours.value) == str(theirs.value)
    with pytest.raises(codec.CodecError, match="unknown codec key"):
        codec.codec_from_key(["zstd"])


@pytest.mark.parametrize("key", [["identity"], ["u8", 1.0, 0.0],
                                 ["u8", 1 / 255, 0.5], ["bf16"],
                                 ["tokens", 0, 32000, "u16"],
                                 ["tokens", 0, 70000, "i32"],
                                 ["tokens", 0, None, "i32"]])
def test_codec_from_key_round_trips_like_tpudl(key):
    ours, theirs = codec.codec_from_key(key), jcodec.codec_from_key(key)
    assert ours.key() == theirs.key()
    assert repr(ours.key()) == repr(theirs.key())
    assert type(ours).__name__ == type(theirs).__name__


def test_codec_plan_resolves_per_column_and_adopts(monkeypatch):
    # a fast measured wire, so both packages pick identity for float32
    monkeypatch.setenv("TPUDL_WIRE_MBPS", "100000")
    q = _u8_batch(5, (4, 6))
    cols = [q, q.astype(np.float32) * np.float32(1 / 255),
            np.random.default_rng(0).standard_normal((4, 6)).astype(
                np.float32)]
    plan, jplan = codec.CodecPlan("auto", 3), jcodec.CodecPlan("auto", 3)
    assert plan.names() == jplan.names() == ["auto"] * 3
    for i, a in enumerate(cols):
        assert np.array_equal(plan.encode(i, a), jplan.encode(i, a))
    assert plan.resolved() and plan.keys() == jplan.keys()
    assert plan.names() == ["u8", "identity", "identity"]
    strict, jstrict = codec.CodecPlan("u8", 2), jcodec.CodecPlan("u8", 2)
    for i in range(2):
        assert np.array_equal(strict.encode(i, cols[i]),
                              jstrict.encode(i, cols[i]))
    assert strict.keys() == jstrict.keys()
    assert strict.names() == ["u8", "u8"]
    with pytest.raises(codec.CodecError, match="losslessly"):
        codec.CodecPlan("u8", 1).encode(0, cols[2])
    # adopt pins a persisted resolution (a warm cache's meta)
    warm = codec.CodecPlan("auto", 3)
    assert not warm.resolved()
    warm.adopt(plan.keys())
    assert warm.keys() == plan.keys()
    with pytest.raises(codec.CodecError, match="count"):
        codec.CodecPlan("auto", 2).adopt(plan.keys())


def test_codec_plan_wrap_restores_trailing_columns():
    plan = codec.CodecPlan(codec.U8Codec(1 / 255), 1)
    q = _u8_batch(6, (2, 3))
    seen = []

    def loss(model, x):
        seen.append((model, x.dtype))
        return x

    out = plan.wrap(loss)("m", torch.from_numpy(q))
    assert seen == [("m", torch.float32)]
    assert np.array_equal(out.numpy(), codec.U8Codec(1 / 255).decode_array(q))
    ident = codec.CodecPlan("identity", 1)
    assert ident.wrap(loss) is loss
    with pytest.raises(codec.CodecError, match="not resolved"):
        codec.CodecPlan("auto", 1).wrap(loss)


def test_record_shipped_counts_wire_bytes():
    from tpudl_torch.obs import metrics

    def value(name):
        return metrics.snapshot().get(name, {}).get("value", 0.0)

    before = {k: value(k) for k in ("data.wire.bytes_shipped",
                                    "data.wire.bytes_dense",
                                    "data.wire.bytes_saved")}
    plan = codec.CodecPlan("u8", 1)
    q = _u8_batch(7, (8, 10))
    plan.record_shipped([plan.encode(0, q)])
    assert value("data.wire.bytes_shipped") - before[
        "data.wire.bytes_shipped"] == q.nbytes
    assert value("data.wire.bytes_dense") - before[
        "data.wire.bytes_dense"] == 4 * q.nbytes
    assert value("data.wire.bytes_saved") - before[
        "data.wire.bytes_saved"] == 3 * q.nbytes


def test_probe_wire_mbps_without_card(monkeypatch):
    monkeypatch.setattr(codec, "_WIRE_MBPS_CACHE", {})
    monkeypatch.delenv("TPUDL_WIRE_MBPS", raising=False)
    assert codec.probe_wire_mbps() is None
    monkeypatch.setenv("TPUDL_WIRE_MBPS", "12.5")
    assert codec.probe_wire_mbps() == 12.5
    # a slow wire picks bf16 for float32, as tpudl's auto does
    monkeypatch.setenv("TPUDL_DATA_BF16_WIRE_MBPS", "100")
    f32 = np.ones((2, 2), np.float32)
    assert codec._auto_pick(f32).name == jcodec._auto_pick(f32).name == "bf16"


def test_host_tensor_views_bf16_bits_and_copies_read_only(tmp_path):
    x = _special_f32()[:64]
    enc = codec.BF16Codec().encode(x)
    t = codec.host_tensor(enc)
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.view(torch.uint16).numpy(), enc.view(np.uint16))
    path = tmp_path / "a.npy"
    np.save(path, np.arange(6, dtype=np.uint16))
    ro = np.load(path, mmap_mode="r")
    t = codec.host_tensor(ro)
    assert t.dtype == torch.uint16 and t.tolist() == list(range(6))


# -- TokenCodec's wire type (fails on a port that ignored wire_dtype) -------

@pytest.mark.parametrize("env,arg,vocab,want", [
    ("i32", "auto", 32000, ("tokens", 0, 32000, "i32")),
    ("", "auto", 32000, ("tokens", 0, 32000, "u16")),
    ("", "auto", 70000, ("tokens", 0, 70000, "i32")),
    ("", "auto", None, ("tokens", 0, None, "i32")),
    ("i32", "u16", 32000, ("tokens", 0, 32000, "u16")),
    ("u16", "auto", None, ("tokens", 0, None, "u16")),
])
def test_token_wire_dtype_resolves_as_tpudl(monkeypatch, env, arg, vocab,
                                            want):
    monkeypatch.setenv("TPUDL_TEXT_WIRE_DTYPE", env)
    ours = text.TokenCodec(vocab_size=vocab, wire_dtype=arg)
    theirs = jtext.TokenCodec(vocab_size=vocab, wire_dtype=arg)
    assert ours.key() == theirs.key() == want
    assert text._wire_dtype(arg, vocab) == jtext._wire_dtype(arg, vocab)
    ids = np.array([[0, 5, 65535 if want[3] == "u16" and vocab is None
                     else 7]], dtype=np.int32)
    assert np.array_equal(ours.encode(ids), theirs.encode(ids))
    assert ours.encode(ids).dtype == theirs.encode(ids).dtype


def test_token_wire_dtype_errors_match_tpudl(monkeypatch):
    monkeypatch.delenv("TPUDL_TEXT_WIRE_DTYPE", raising=False)
    for arg, vocab in (("u8", 10), ("u16", 70000)):
        with pytest.raises(codec.CodecError) as ours:
            text.TokenCodec(vocab_size=vocab, wire_dtype=arg)
        with pytest.raises(jcodec.CodecError) as theirs:
            jtext.TokenCodec(vocab_size=vocab, wire_dtype=arg)
        assert str(ours.value) == str(theirs.value)
    with pytest.raises(codec.CodecError, match="out of range"):
        text.TokenCodec(wire_dtype="u16").encode(np.array([[70000]]))


def test_token_codec_from_manifest_key_under_env(monkeypatch):
    """A manifest tpudl wrote under TPUDL_TEXT_WIRE_DTYPE=i32 rebuilds the
    same codec in the port, with or without the variable set."""
    monkeypatch.setenv("TPUDL_TEXT_WIRE_DTYPE", "i32")
    key = list(jtext.TokenCodec(vocab_size=32000).key())
    monkeypatch.delenv("TPUDL_TEXT_WIRE_DTYPE")
    c = codec.codec_from_key(key)
    assert c.key() == ("tokens", 0, 32000, "i32")
    ids = np.arange(12, dtype=np.int32).reshape(3, 4)
    assert c.encode(ids).dtype == np.int32
    assert np.array_equal(c.prologue(torch.from_numpy(c.encode(ids))).numpy(),
                          c.decode_array(c.encode(ids)))


def test_tokenize_pack_cache_token_and_lengths_match_tpudl():
    from tpudl.text import ByteTokenizer as JaxByte

    from tpudl_torch.text import ByteTokenizer

    for kw in ({}, {"seq_len": 16, "dense": True, "eos": True},
               {"seq_len": 8, "buckets": None, "bos": True}):
        assert text.tokenize_pack(ByteTokenizer(), **kw).cache_token == \
            jtext.tokenize_pack(JaxByte(), **kw).cache_token
    batch = text.pack_ragged([[5, 6, 7], [8], []], buckets=None)
    assert np.array_equal(text.lengths(batch), jtext.lengths(batch))
    assert text.lengths(batch).dtype == np.int32


def test_frame_map_batches_takes_codecs_by_name():
    q = _u8_batch(8, (10, 4))
    x = q.astype(np.float32) * np.float32(1 / 255)
    fn = lambda t: t * 2  # noqa: E731
    base = np.stack(list(Frame({"x": x}).map_batches(
        fn, ["x"], ["y"], batch_size=4, device="cpu")["y"]))
    for spec in ("u8", "identity", "auto", codec.U8Codec(1 / 255)):
        got = np.stack(list(Frame({"x": x}).map_batches(
            fn, ["x"], ["y"], batch_size=4, device="cpu",
            wire_codec=spec)["y"]))
        assert np.array_equal(got, base), spec
    got = np.stack(list(Frame({"x": x}).map_batches(
        fn, ["x"], ["y"], batch_size=4, device="cpu",
        wire_codec="bf16")["y"]))
    assert np.allclose(got, base, rtol=codec.BF16Codec.RTOL, atol=0)
    with pytest.raises(codec.CodecError, match="unknown wire codec"):
        Frame({"x": x}).map_batches(fn, ["x"], ["y"], device="cpu",
                                    wire_codec="gzip")
