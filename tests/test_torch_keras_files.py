"""``.keras`` files read and written without keras
(``tpudl_torch.ingest.hdf5`` and ``kerasfile``), held to h5py and keras.

Keras writes the files here (``torch_keras_models``: configs[4]'s MLP,
``bench.py``'s estimator CNN, a small Functional model and configs[2]'s
InceptionV3 + head). Every dataset the port reads is bitwise equal to
h5py's, and every attribute equal; a file the port writes loads in
``keras.saving.load_model`` with the keras file's predictions exactly
(the same weights, the same program); load → save → load is bitwise; and
each HDF5 feature outside Keras's subset raises its named error."""

import json
import zipfile

import numpy as np
import pytest

keras = pytest.importorskip("keras")
h5py = pytest.importorskip("h5py")

import torch_keras_models as M  # noqa: E402

from tpudl_torch.ingest import hdf5  # noqa: E402
from tpudl_torch.ingest.kerasfile import (load_keras_file,  # noqa: E402
                                          save_keras_file)

MODELS = ("mlp", "cnn", "functional", "inception")
INPUTS = {"mlp": (3, 100), "cnn": (3, 32, 32, 3), "functional": (3, 17, 15, 3),
          "inception": (2, 75, 75, 3)}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("keras_files")
    return {name: M.saved(name, d) for name in MODELS}


def _h5_bytes(path):
    with zipfile.ZipFile(path) as z:
        return z.read("model.weights.h5")


def _attrs(obj):
    return {k: (v.decode() if isinstance(v, bytes) else v)
            for k, v in obj.attrs.items()}


@pytest.mark.parametrize("name", MODELS)
def test_every_dataset_reads_bitwise_equal_to_h5py(files, name, tmp_path):
    raw = _h5_bytes(files[name])
    mine = hdf5.read(raw)
    (tmp_path / "w.h5").write_bytes(raw)
    seen = []
    with h5py.File(tmp_path / "w.h5", "r") as f:
        def visit(path, obj):
            node = mine[path]
            assert _attrs(obj) == node.attrs, path
            if isinstance(obj, h5py.Dataset):
                want = obj[()]
                assert node.value.dtype == want.dtype, path
                assert node.value.shape == want.shape, path
                assert node.value.tobytes() == want.tobytes(), path
                seen.append(path)
            else:
                assert sorted(obj) == sorted(node.members), path

        f.visititems(visit)
        assert sorted(f) == sorted(mine.members)
    assert len(seen) == {"mlp": 6, "cnn": 4, "functional": 16,
                         "inception": 378}[name]


@pytest.mark.parametrize("name", MODELS)
def test_weights_are_keyed_and_ordered_as_keras_variables(files, name):
    model = keras.saving.load_model(files[name], compile=False)
    config, weights = load_keras_file(files[name])
    assert list(weights) == [w.path for w in model.weights]
    for w in model.weights:
        assert np.array_equal(weights[w.path], np.asarray(w.numpy()))
    with zipfile.ZipFile(files[name]) as z:
        assert config == json.loads(z.read("config.json"))


@pytest.mark.parametrize("name", MODELS)
def test_port_written_file_loads_in_keras_with_equal_predictions(
        files, name, tmp_path):
    config, weights = load_keras_file(files[name])
    weights = M.perturbed(weights)
    path = save_keras_file(tmp_path / "port.keras", config, weights)
    theirs = keras.saving.load_model(path, compile=False)
    for w in theirs.weights:
        assert np.array_equal(np.asarray(w.numpy()), weights[w.path]), w.path
    x = np.random.default_rng(0).normal(size=INPUTS[name]).astype(np.float32)
    ref = keras.saving.load_model(files[name], compile=False)
    ref.set_weights([weights[w.path] for w in ref.weights])
    assert np.array_equal(theirs.predict(x, verbose=0),
                          ref.predict(x, verbose=0))


@pytest.mark.parametrize("name", MODELS)
def test_round_trip_is_bitwise(files, name, tmp_path):
    config, weights = load_keras_file(files[name])
    path = save_keras_file(tmp_path / "a.keras", config, weights)
    config2, weights2 = load_keras_file(path)
    assert config2 == config and list(weights2) == list(weights)
    for k in weights:
        assert weights2[k].dtype == weights[k].dtype
        assert weights2[k].tobytes() == weights[k].tobytes()
    # the h5 tree as a whole, names and attributes included
    tree = hdf5.read(_h5_bytes(files[name]))
    again = hdf5.read(hdf5.write(tree))

    def same(a, b, path=""):
        assert type(a) is type(b) and a.attrs == b.attrs, path
        if isinstance(a, hdf5.Dataset):
            assert a.value.tobytes() == b.value.tobytes(), path
        else:
            assert list(a.members) == list(b.members), path
            for k in a.members:
                same(a.members[k], b.members[k], f"{path}/{k}")

    same(tree, again)


def test_port_written_h5_reads_in_h5py(tmp_path):
    tree = hdf5.Group({
        "g": hdf5.Group({f"d{i:03d}": hdf5.Dataset(np.full((i % 3, 2), i,
                                                           np.float64))
                         for i in range(70)}, attrs={"name": "group g"}),
        "ints": hdf5.Dataset(np.arange(12, dtype=np.int64).reshape(3, 4),
                             attrs={"unit": "counts", "scale": np.float32(2)}),
        "empty": hdf5.Group(attrs={"name": "ε"})})
    (tmp_path / "t.h5").write_bytes(hdf5.write(tree))
    with h5py.File(tmp_path / "t.h5", "r") as f:
        assert sorted(f["g"]) == sorted(tree["g"].members)
        assert f["g"].attrs["name"] == "group g"
        assert f["empty"].attrs["name"] == "ε" and len(f["empty"]) == 0
        for k, ds in tree["g"].members.items():
            assert np.array_equal(f["g"][k][()], ds.value)
        assert np.array_equal(f["ints"][()], tree["ints"].value)
        assert f["ints"].attrs["unit"] == "counts"
        assert f["ints"].attrs["scale"] == np.float32(2)


@pytest.mark.parametrize("feature,make", [
    ("chunked layout",
     lambda f: f.create_dataset("x", data=np.ones((8, 8), np.float32),
                                chunks=(4, 4))),
    ("filter pipeline",
     lambda f: f.create_dataset("x", data=np.ones((8, 8), np.float32),
                                compression="gzip")),
    ("compact layout",
     lambda f: h5py.h5d.create(
         f.id, b"x", h5py.h5t.NATIVE_FLOAT, h5py.h5s.create_simple((2,)),
         _compact_dcpl())),
    ("variable-length data",
     lambda f: f.create_dataset("x", data=np.array(["a", "bc"], dtype=object),
                                dtype=h5py.string_dtype())),
    ("big-endian or VAX floats",
     lambda f: f.create_dataset("x", data=np.ones(3, ">f4"))),
    ("string datasets",
     lambda f: f.create_dataset("x", data=np.array([b"ab", b"cd"]))),
    ("compound datatype",
     lambda f: f.create_dataset("x", data=np.zeros(2, "i4,f4"))),
])
def test_unsupported_features_raise_by_name(tmp_path, feature, make):
    with h5py.File(tmp_path / "u.h5", "w", libver="earliest") as f:
        make(f)
    with pytest.raises(hdf5.UnsupportedHDF5Feature) as e:
        hdf5.read((tmp_path / "u.h5").read_bytes())
    assert e.value.feature.startswith(feature)


def _compact_dcpl():
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_layout(h5py.h5d.COMPACT)
    return dcpl


def test_later_superblocks_and_new_style_groups_raise_by_name(tmp_path):
    with h5py.File(tmp_path / "v.h5", "w", libver="latest") as f:
        f.create_dataset("x", data=np.ones(2, np.float32))
    with pytest.raises(hdf5.UnsupportedHDF5Feature, match="superblock"):
        hdf5.read((tmp_path / "v.h5").read_bytes())
    with pytest.raises(hdf5.HDF5FormatError, match="signature"):
        hdf5.read(b"not an hdf5 file at all")


def test_legacy_h5_model_and_non_keras_files_are_refused(tmp_path):
    """Keras 3's legacy ``.h5`` reads (``test_torch_keras_h5.py``); one
    written by Keras 1 or 2 is refused by name."""
    legacy = tmp_path / "model.h5"
    M.build("mlp").save(legacy)
    with h5py.File(legacy, "r+") as f:
        f.attrs["keras_version"] = "2.15.0"
    with pytest.raises(NotImplementedError,
                       match="a Keras 2.15.0-era .h5 model file"):
        load_keras_file(legacy)
    (tmp_path / "junk.keras").write_bytes(b"junk")
    with pytest.raises(ValueError, match="not a .keras file"):
        load_keras_file(tmp_path / "junk.keras")


def test_save_refuses_missing_or_extra_weights(files, tmp_path):
    config, weights = load_keras_file(files["mlp"])
    with pytest.raises(KeyError, match="dense_2/bias"):
        save_keras_file(tmp_path / "a.keras", config,
                        {k: v for k, v in weights.items()
                         if k != "dense_2/bias"})
    with pytest.raises(KeyError, match="stray/kernel"):
        save_keras_file(tmp_path / "b.keras", config,
                        {**weights, "stray/kernel": np.zeros(1)})


def test_fixture_config_loads_in_keras_with_seeded_weights(tmp_path):
    """The committed InceptionV3 config, written by the port with seeded
    weights (chip_smoke's recipe), is a model keras reads."""
    import chip_smoke

    config = M.fixture_config()
    weights = chip_smoke.keras_weights(config, 0)
    path = save_keras_file(tmp_path / "inc.keras", config, weights)
    model = keras.saving.load_model(path, compile=False)
    assert [w.path for w in model.weights] == list(weights)
    for w in model.weights:
        assert np.array_equal(np.asarray(w.numpy()), weights[w.path])
    # and chip_smoke's inline MLP config is the one keras writes for it
    mlp = chip_smoke.keras_mlp_config()
    with zipfile.ZipFile(M.saved("mlp", tmp_path)) as z:
        want = M.normalized_config(json.loads(z.read("config.json")))
    assert M.normalized_config(mlp) == want


NEW_FIXTURES = ("xception_tl", "mobilenet_v2", "efficientnet_b0")


@pytest.mark.parametrize("fixture", NEW_FIXTURES)
def test_config_fixture_is_what_keras_writes_today(fixture):
    """chip_smoke.py's phase 9 writes these models from the committed
    configs (the card's machine has no keras)."""
    assert M.written_config(fixture) == M.fixture_config(fixture)


@pytest.mark.parametrize("fixture", NEW_FIXTURES)
def test_config_fixture_loads_in_keras_with_seeded_weights(fixture,
                                                           tmp_path):
    import chip_smoke

    config = M.fixture_config(fixture)
    weights = chip_smoke.keras_weights(config, 0)
    path = save_keras_file(tmp_path / f"{fixture}.keras", config, weights)
    model = keras.saving.load_model(path, compile=False)
    assert [w.path for w in model.weights] == list(weights)
    for w in model.weights:
        assert np.array_equal(np.asarray(w.numpy()), weights[w.path])
