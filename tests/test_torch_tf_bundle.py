"""TF's tensor bundles without TensorFlow: the port's reader
(``tpudl_torch.ingest.tensor_bundle``) against
``tf.train.load_checkpoint(...).get_tensor`` on every committed fixture,
the native CRC-32C against its plain Python version, a flipped data byte
and a compressed index refused, the ``checkpoint`` state file; and the
writer beside ``chip_smoke.py`` (``tf_bundle_writer``) against TF's
reader and, for configs[2]'s InceptionV3 + head, against
``tf.saved_model.load`` of the committed ``saved_model.pb``: keras's
``predict`` on the same weights within 1e-5 of max |y|, which pins the
order of variables to bundle keys."""

import gzip
import json
import os
import shutil
import struct
from pathlib import Path

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

import tf_bundle_writer  # noqa: E402
from tpudl_torch.ingest import tensor_bundle as tb  # noqa: E402
from tpudl_torch.native import crc  # noqa: E402

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "tf"
PREFIXES = {
    "factory_saved_model": FIXTURES / "factory_saved_model" / "variables"
    / "variables",
    "factory_ckpt": FIXTURES / "factory_ckpt" / "model",
    "tf2_mlp": FIXTURES / "tf2_mlp" / "variables" / "variables",
    "keras_cnn": FIXTURES / "keras_cnn" / "variables" / "variables",
    "keras_depthwise": FIXTURES / "keras_depthwise" / "variables"
    / "variables",
}


@pytest.mark.parametrize("name", sorted(PREFIXES))
def test_reader_matches_tf(name):
    prefix = str(PREFIXES[name])
    theirs = tf.train.load_checkpoint(prefix)
    shapes = theirs.get_variable_to_shape_map()
    mine = tb.BundleReader(prefix)
    assert set(mine.keys()) == set(shapes)
    for key in shapes:
        if key == "_CHECKPOINTABLE_OBJECT_GRAPH":
            continue
        want = theirs.get_tensor(key)
        got = mine.read(key)
        assert got.dtype == want.dtype and got.shape == want.shape, key
        assert np.array_equal(got, want), key


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 1000, 100003])
def test_native_crc_matches_plain(n):
    data = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
    assert crc.crc32c(data) == crc.crc32c_plain(data)
    assert crc.crc32c(data[n // 2:], crc.crc32c(data[:n // 2])) == \
        crc.crc32c_plain(data)
    assert crc.crc32c(b"123456789") == 0xE3069283        # the check value


def test_flipped_data_byte_raises(tmp_path):
    src = PREFIXES["keras_cnn"]
    for p in src.parent.iterdir():
        shutil.copy(p, tmp_path / p.name)
    prefix = str(tmp_path / "variables")
    reader = tb.BundleReader(prefix)
    key = next(k for k in reader.keys() if k.startswith("variables/"))
    e = reader.entries[key]
    data = tmp_path / "variables.data-00000-of-00001"
    raw = bytearray(data.read_bytes())
    raw[e.offset + e.size // 2] ^= 0x01
    data.write_bytes(bytes(raw))
    with pytest.raises(tb.BundleError, match="checksum mismatch"):
        tb.BundleReader(prefix).read(key)
    with pytest.raises(Exception):
        tf.train.load_checkpoint(prefix).get_tensor(key)


def test_compressed_index_block_is_refused(tmp_path):
    src = (PREFIXES["tf2_mlp"].parent / "variables.index").read_bytes()
    footer = src[-48:]
    off, pos = tb._varint(footer, 0)
    size, pos = tb._varint(footer, pos)
    off, pos = tb._varint(footer, pos)
    size, pos = tb._varint(footer, pos)
    bad = bytearray(src)
    bad[off + size] = 1                                   # snappy
    with pytest.raises(tb.BundleError, match="compressed"):
        tb.read_table(bytes(bad))
    bad = bytearray(src)
    bad[-1] ^= 0xFF
    with pytest.raises(tb.BundleError, match="magic"):
        tb.read_table(bytes(bad))


def test_latest_checkpoint_reads_the_state_file(tmp_path):
    d = FIXTURES / "factory_ckpt"
    assert tb.latest_checkpoint(str(d)) == str(d / "model")
    assert tb.latest_checkpoint(str(d)) == tf.train.latest_checkpoint(str(d))
    assert tb.latest_checkpoint(str(tmp_path)) is None
    for p in d.iterdir():
        shutil.copy(p, tmp_path / p.name)
    (tmp_path / "checkpoint").write_text(
        f'model_checkpoint_path: "{tmp_path / "model"}"\n')
    assert tb.latest_checkpoint(str(tmp_path)) == str(tmp_path / "model")


def test_writer_round_trips_through_tf_and_the_port(tmp_path):
    rng = np.random.default_rng(0)
    tensors = {"b/x": rng.normal(size=(3, 4)).astype(np.float32),
               "a": np.arange(5, dtype=np.int64), "s": np.float64(2.5),
               "c": np.array([True, False]), "e": np.zeros((0, 3),
                                                          np.float32),
               "_str": b"\x00bytes"}
    prefix = str(tmp_path / "x")
    tf_bundle_writer.write_bundle(prefix, tensors)
    theirs = tf.train.load_checkpoint(prefix)
    mine = tb.BundleReader(prefix)
    for k, v in tensors.items():
        if isinstance(v, bytes):
            assert theirs.get_tensor(k) == v
            continue
        assert np.array_equal(theirs.get_tensor(k), v), k
        got = mine.read(k)
        assert got.dtype == np.asarray(v).dtype and np.array_equal(got, v), k


def test_written_inception_variables_load_in_tf_as_keras_predicts(tmp_path):
    """The committed InceptionV3 + head saved_model.pb with variables the
    writer writes (seeded, BN-perturbed, as chip_smoke phase 11 writes
    them): tf.saved_model.load's serving signature equals keras's predict
    on the same weights."""
    import chip_smoke
    import torch_keras_models as M

    d = FIXTURES / "inception_v3_tl"
    sm = tmp_path / "sm"
    sm.mkdir()
    (sm / "saved_model.pb").write_bytes(
        gzip.decompress((d / "saved_model.pb.gz").read_bytes()))
    keys = json.loads(gzip.decompress((d / "variables.json.gz").read_bytes()))
    config = chip_smoke.keras_inception_config()
    weights = chip_smoke.keras_perturbed(chip_smoke.keras_weights(config, 0))
    tf_bundle_writer.write_saved_model_variables(
        str(sm), keys, weights, gzip.decompress(
            (d / "object_graph.bin.gz").read_bytes()))
    x = np.random.default_rng(1).uniform(0, 255, (1, 299, 299, 3)).astype(
        np.float32)
    loaded = tf.saved_model.load(str(sm))
    got = loaded.signatures["serving_default"](
        keras_tensor=tf.constant(x))["output_0"].numpy()
    model = M.build("inception")
    model.set_weights([weights[w.path] for w in model.weights])
    want = model.predict(x, verbose=0)
    assert got.shape == want.shape == (1, 2)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
