"""The port's copies of tpudl's host-side text and bucket code
(``tpudl_torch.text``, ``tpudl_torch.compile.buckets``) against the
originals: fingerprints, cache tokens, ids, packed batches and ladder
rungs are equal, byte for byte."""

import numpy as np
import pytest

import torch

from tpudl.compile import buckets as jax_buckets
from tpudl.text import codec as jax_codec
from tpudl.text import tokenizer as jax_tok
from tpudl_torch.compile import buckets
from tpudl_torch.text import codec, tokenizer

CORPUS = ["The quick brown fox", "jumps over the lazy dog.",
          "Über café — naïve", "", "the the fox!"]


def _tokenizers(mod):
    return [mod.ByteTokenizer(), mod.ByteTokenizer(lowercase=True),
            mod.WordTokenizer.build(CORPUS, size=8)]


@pytest.mark.parametrize("i", range(3))
def test_tokenizer_identity_and_ids_match(i):
    want, got = _tokenizers(jax_tok)[i], _tokenizers(tokenizer)[i]
    assert got.spec() == want.spec()
    assert got.fingerprint == want.fingerprint
    assert got.cache_token == want.cache_token
    for bos, eos in ((False, False), (True, True)):
        for a, b in zip(got.encode_batch(CORPUS, bos=bos, eos=eos),
                        want.encode_batch(CORPUS, bos=bos, eos=eos)):
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)
    ids = want.encode(CORPUS[2], bos=True)
    assert got.decode(ids) == want.decode(ids)


def test_vocab_manifest_crosses_packages(tmp_path):
    path = str(tmp_path / "vocab.json")
    jax_tok.WordTokenizer.build(CORPUS).save(path)
    assert (tokenizer.load_vocab(path).fingerprint
            == jax_tok.load_vocab(path).fingerprint)


@pytest.mark.parametrize("spec", ["pow2", "pow2ish", "8,16,40", "off"])
def test_ladders_match(spec):
    want, got = (jax_buckets.resolve_ladder(spec),
                 buckets.resolve_ladder(spec))
    if want is None:
        assert got is None
        return
    assert got.spec == want.spec
    assert [got.pick(n) for n in range(-1, 130)] == \
        [want.pick(n) for n in range(-1, 130)]


@pytest.mark.parametrize("var,value", [("TPUDL_COMPILE_BUCKETS", "pow2"),
                                       ("TPUDL_TEXT_WIRE_DTYPE", "i32")])
def test_port_reads_no_tpudl_env(monkeypatch, var, value):
    """Each of tpudl's variables acts on the port as on tpudl:
    ``TPUDL_COMPILE_BUCKETS`` is the ladder ``resolve_ladder(None)``
    reads (COMPILE.md's knob; the port once ignored it), and
    ``TPUDL_TEXT_WIRE_DTYPE`` picks ``TokenCodec``'s wire type, since a
    shard manifest persists the codec key it gives."""
    monkeypatch.setenv(var, value)
    want = jax_buckets.resolve_ladder(None)
    got = buckets.resolve_ladder(None)
    assert (got is None) == (want is None)
    if want is not None:
        assert got.spec == want.spec == value
    for vocab in (260, 70000):
        assert codec.TokenCodec(vocab_size=vocab).key() == \
            jax_codec.TokenCodec(vocab_size=vocab).key()
    assert codec.TokenCodec(vocab_size=260).wire == (
        "i32" if var == "TPUDL_TEXT_WIRE_DTYPE" else "u16")
    assert codec.TokenCodec(vocab_size=70000).wire == "i32"


@pytest.mark.parametrize("spec,max_len", [("pow2", None), ("pow2ish", None),
                                          (None, 7), ("off", 5)])
def test_pack_ragged_matches(spec, max_len):
    seqs = jax_tok.ByteTokenizer().encode_batch(CORPUS, bos=True)
    want = jax_codec.pack_ragged(seqs, buckets=spec, max_len=max_len)
    got = codec.pack_ragged(seqs, buckets=spec, max_len=max_len)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [dict(bos=True), dict(seq_len=6),
                                dict(seq_len=8, bos=True, buckets="pow2ish")])
def test_tokenize_pack_matches(kw):
    want = jax_codec.tokenize_pack(jax_tok.ByteTokenizer(), **kw)
    got = codec.tokenize_pack(tokenizer.ByteTokenizer(), **kw)
    col = np.array(CORPUS, dtype=object)
    np.testing.assert_array_equal(got(col), want(col))


@pytest.mark.parametrize("lengths,seq_len", [((5, 4, 3), 4), ((), 4),
                                             ((7, 0, 2), 3), ((1,), 1)])
def test_pack_dense_matches(lengths, seq_len):
    """The cases of tests/test_text.py's dense-packing test, and a
    partial last row."""
    seqs = [np.arange(4, 4 + n, dtype=np.int32) for n in lengths]
    want = jax_codec.pack_dense(seqs, seq_len)
    got = codec.pack_dense(seqs, seq_len)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [dict(seq_len=8, dense=True, eos=True),
                                dict(seq_len=5, dense=True, eos=True,
                                     bos=True),
                                dict(seq_len=1025, dense=True, eos=True),
                                dict(seq_len=6, eos=True)])
def test_tokenize_pack_dense_matches(kw):
    want = jax_codec.tokenize_pack(jax_tok.ByteTokenizer(), **kw)
    got = codec.tokenize_pack(tokenizer.ByteTokenizer(), **kw)
    for texts in (["abc", "defgh"], CORPUS):
        col = np.array(texts, dtype=object)
        np.testing.assert_array_equal(got(col), want(col))
        assert got(col).dtype == want(col).dtype


def test_dense_packing_needs_seq_len():
    with pytest.raises(ValueError, match="seq_len"):
        codec.tokenize_pack(tokenizer.ByteTokenizer(), dense=True)
    with pytest.raises(ValueError, match="seq_len"):
        codec.pack_dense([np.arange(3)], 0)


@pytest.mark.parametrize("vocab", [260, 70000])
def test_token_codec_matches_and_restores_on_device(vocab):
    want = jax_codec.TokenCodec(vocab_size=vocab)
    got = codec.TokenCodec(vocab_size=vocab)
    assert got.key() == want.key()
    batch = np.array([[1, 77, 259, 0], [1, 5, 0, 0]], dtype=np.int32)
    wire = got.encode(batch)
    assert wire.dtype == want.encode(batch).dtype
    np.testing.assert_array_equal(wire, want.encode(batch))
    restored = got.prologue(torch.from_numpy(wire))
    assert restored.dtype == torch.int32
    np.testing.assert_array_equal(restored.numpy(), batch)
    np.testing.assert_array_equal(
        codec.pad_mask(restored).numpy(),
        np.asarray(jax_codec.pad_mask(batch)))
    with pytest.raises(ValueError, match="out of range"):
        got.encode(np.array([[vocab]]))
