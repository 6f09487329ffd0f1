"""The port's named image models and stages against tpudl's: the
registry and InceptionV3 (``tpudl_torch.zoo``), preprocessing, param
artifacts, and ``DeepImageFeaturizer``/``DeepImagePredictor``
(``tpudl_torch.ml.named_image``) over ``readImages``, with the same
``init(0)`` weights and the same seeded inputs and files.

Tolerances, relative to max |y| (``init(0)`` features are tiny, ~5e-3,
so an absolute bound would prove nothing):

- f32 model outputs at 75×75, with ``init(0)`` and with seeded perturbed
  BN stats: 2e-5 of max |y| (read 1.8e-6 and 3.6e-7: ~94 conv layers
  summed in another order);
- f32 stage outputs at 299×299 over decoded JPEGs: 2e-5 of max |y| (the
  resize differs by f32 rounding of its weights, see test_torch_image);
- bf16 ``computeDtype`` against f32: 3e-2 of max |y| (read 1.2e-2; tpudl's
  own bf16 reads 1.4e-2 against its f32); f16: 1e-2 (read 3.9e-3)."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import ml_dtypes
import torch
from PIL import Image

from tpudl.image import imageIO as jio
from tpudl.ml import DeepImageFeaturizer as JaxFeaturizer
from tpudl.ml import DeepImagePredictor as JaxPredictor
from tpudl.zoo import convert as jconvert
from tpudl.zoo import preprocessing as jpre
from tpudl.zoo import registry as jreg
from tpudl_torch.data.codec import WireCodec
from tpudl_torch.frame import Frame
from tpudl_torch.image import imageIO
from tpudl_torch.ml import DeepImageFeaturizer, DeepImagePredictor
from tpudl_torch.ml.named_image import load_named_params
from tpudl_torch.obs import last_pipeline_report
from tpudl_torch.zoo import convert, preprocessing, registry
from tpudl_torch.zoo.registry import ImageModel
from torch_native_fixture import private_tpudl_decoder  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("private_tpudl_decoder")

torch.set_num_threads(1)

TOL = 2e-5
REDUCED_TOL = {"bfloat16": 3e-2, "float16": 1e-2}
SMALL = (75, 75)


def _rel_err(got, want):
    want = np.asarray(want, dtype=np.float64)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def _perturbed(params, seed=1):
    """BN stats, shifts and scales away from 0 and 1, so folding BN into a
    scale and shift works at a scale that shows errors. BN layers are found
    by their leaves (a ``moving_mean``), not by name: ResNet's ``conv1_bn``
    or MobileNetV2's ``bn_Conv1`` hold no ``batch_normalization`` prefix.
    InceptionV3's BN layers hold no ``gamma``, so its draws are the ones a
    selection by name made."""
    rng = np.random.default_rng(seed)
    out = {}
    for layer, leaves in params.items():
        leaves = dict(leaves)
        if "moving_mean" in leaves:
            c = leaves["beta"].shape[0]
            leaves["moving_mean"] = rng.normal(0, 0.1, c).astype(np.float32)
            leaves["moving_var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            leaves["beta"] = rng.normal(0, 0.1, c).astype(np.float32)
            if "gamma" in leaves:
                leaves["gamma"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        if "variance" in leaves:   # EfficientNet's normalization layer
            c = leaves["mean"].shape[0]
            leaves["mean"] = rng.uniform(0.4, 0.5, c).astype(np.float32)
            leaves["variance"] = rng.uniform(0.04, 0.08, c).astype(np.float32)
        out[layer] = leaves
    return out


# -- shared by the model files (test_torch_zoo_*.py) -----------------------

def _assert_init_bit_equal(name, size, include_top):
    """The port's ``init(0)`` of ``name`` at ``size`` is tpudl's: the same
    layers in the same order, the same leaves, bit for bit."""
    want = jreg.getKerasApplicationModel(name).init(
        0, image_size=size, include_top=include_top)
    got = registry.getKerasApplicationModel(name).init(
        0, image_size=size, include_top=include_top)
    assert list(got) == list(want)
    assert ("predictions" in got) == include_top
    for layer, leaves in want.items():
        assert sorted(got[layer]) == sorted(leaves)
        for k, v in leaves.items():
            assert got[layer][k].dtype == v.dtype
            np.testing.assert_array_equal(got[layer][k], v)
    return got


def _tpudl_side(name, size, x_range=(-1, 1)):
    """tpudl's ``name`` at ``size``: ``init(0)``, the perturbed weights, 2
    seeded input rows in ``x_range``, and for each weights the features,
    class scores and NHWC maps of one jitted program."""
    jm = jreg.getKerasApplicationModel(name)
    params = jm.init(0, image_size=size)
    x = np.random.default_rng(2).uniform(*x_range, (2, *size, 3)).astype(
        np.float32)
    fn = jax.jit(lambda p, x: {
        "featurize": jm.featurize(p, x), "predict": jm.predict(p, x),
        "maps": jm.apply(p, x, include_top=False)})
    weights = {"init": params, "perturbed": _perturbed(params)}
    want = {w: {k: np.asarray(v) for k, v in fn(p, jnp.asarray(x)).items()}
            for w, p in weights.items()}
    return {"x": x, "weights": weights, "want": want}


def _assert_forward_matches(side, name, weights, head):
    """``ImageModel(...).featurize`` or ``.predict`` on the CPU against
    tpudl's on the same weights and rows, within TOL of max |y|."""
    model = registry.getKerasApplicationModel(name)
    net = ImageModel(model, side["weights"][weights], device="cpu")
    with torch.inference_mode():
        got = getattr(net, head)(torch.from_numpy(side["x"])).numpy()
    want = side["want"][weights][head]
    assert got.shape == want.shape == (
        2, model.feature_dim if head == "featurize" else 1000)
    assert _rel_err(got, want) <= TOL


def _assert_maps_match(side, name, shape):
    """``NamedModel.apply(..., include_top=False)`` returns tpudl's NHWC
    maps (perturbed weights)."""
    m = registry.getKerasApplicationModel(name)
    with torch.inference_mode():
        got = m.apply(convert.torch_params(side["weights"]["perturbed"]),
                      torch.from_numpy(side["x"]), include_top=False).numpy()
    want = side["want"]["perturbed"]["maps"]
    assert got.shape == want.shape == shape
    assert _rel_err(got, want) <= TOL


@pytest.fixture(scope="module")
def small():
    """tpudl's InceptionV3 at 75×75: init(0), the perturbed weights, and
    its jitted featurize/predict (one build shared by the module)."""
    jm = jreg.getKerasApplicationModel("InceptionV3")
    params = jm.init(0, image_size=SMALL)
    x = np.random.default_rng(2).uniform(-1, 1, (2, *SMALL, 3)).astype(
        np.float32)
    return {"jm": jm, "params": {"init": params, "perturbed":
                                 _perturbed(params)},
            "x": x, "featurize": jax.jit(jm.featurize),
            "predict": jax.jit(jm.predict)}


@pytest.mark.parametrize("include_top", [True, False])
def test_init_is_bit_equal_to_tpudl(include_top):
    got = _assert_init_bit_equal("InceptionV3", SMALL, include_top)
    n = sum(a.size for g in got.values() for a in g.values())
    assert n == (23_851_784 if include_top else 21_802_784)


@pytest.mark.parametrize("weights", ["init", "perturbed"])
@pytest.mark.parametrize("head", ["featurize", "predict"])
def test_forward_matches_tpudl(small, weights, head):
    params = small["params"][weights]
    want = np.asarray(small[head](params, jnp.asarray(small["x"])))
    net = ImageModel(registry.getKerasApplicationModel("InceptionV3"),
                     params, device="cpu")
    with torch.inference_mode():
        got = getattr(net, head)(torch.from_numpy(small["x"])).numpy()
    assert got.shape == want.shape == (2, 2048 if head == "featurize"
                                       else 1000)
    assert _rel_err(got, want) <= TOL


@pytest.mark.parametrize("dtype,tf32_inside", [(torch.float32, False),
                                               (torch.bfloat16, True)])
def test_float32_model_switches_tf32_off_while_it_runs(
        small, monkeypatch, dtype, tf32_inside):
    """PyTorch lets cuDNN run f32 convolutions in TF32 by default. A float32
    ImageModel switches TF32 off for cuDNN and cuBLAS during its own call
    and restores the process's setting after; other dtypes leave it."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    seen = []
    conv2d = torch.nn.functional.conv2d

    def spy(*args, **kwargs):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))
        return conv2d(*args, **kwargs)

    monkeypatch.setattr(torch.nn.functional, "conv2d", spy)
    net = ImageModel(registry.getKerasApplicationModel("InceptionV3"),
                     small["params"]["init"], device="cpu", dtype=dtype)
    x = torch.from_numpy(small["x"]).to(dtype)
    with torch.inference_mode():
        net.featurize(x)
        net.predict(x)
    assert len(seen) == 2 * 94
    assert set(seen) == {(tf32_inside, tf32_inside)}
    assert torch.backends.cudnn.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32


def test_apply_returns_nhwc_maps_like_tpudl(small):
    params = small["params"]["perturbed"]
    x = small["x"]
    want = np.asarray(jax.jit(lambda p, x: small["jm"].apply(
        p, x, include_top=False))(params, jnp.asarray(x)))
    m = registry.getKerasApplicationModel("InceptionV3")
    with torch.inference_mode():
        got = m.apply(convert.torch_params(params), torch.from_numpy(x),
                      include_top=False).numpy()
    assert got.shape == want.shape == (2, 1, 1, 2048)
    assert _rel_err(got, want) <= TOL


def test_cast_params_matches_tpudl(small):
    params = {k: small["params"]["perturbed"][k]
              for k in ("conv2d", "batch_normalization_3", "predictions")}
    want = jreg.cast_params(params, ml_dtypes.bfloat16)
    got = registry.cast_params(convert.torch_params(params), torch.bfloat16)
    for layer, leaves in want.items():
        for k, v in leaves.items():
            np.testing.assert_array_equal(
                got[layer][k].float().numpy(),
                convert.torch_layout(k, v.astype(np.float32)).numpy())


def test_image_model_holds_weights_on_its_device(small):
    m = registry.getKerasApplicationModel("InceptionV3")
    net = ImageModel(m, small["params"]["init"], device="cpu",
                     dtype=torch.bfloat16)
    state = net.state_dict()
    assert state["layers.conv2d.kernel"].shape == (32, 3, 3, 3)
    assert state["layers.conv2d.kernel"].is_contiguous(
        memory_format=torch.channels_last)
    assert state["layers.predictions.kernel"].shape == (2048, 1000)
    assert all(t.dtype == torch.bfloat16 for t in state.values())
    assert net.device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ImageModel(m, small["params"]["init"])


@pytest.mark.parametrize("mode", ["tf", "caffe", "torch", "raw"])
def test_preprocess_input_matches_tpudl(mode):
    x = np.random.default_rng(3).uniform(0, 255, (2, 4, 5, 3)).astype(
        np.float32)
    want = np.asarray(jpre.preprocess_input(jnp.asarray(x), mode))
    got = preprocessing.preprocess_input(torch.from_numpy(x), mode).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="mode"):
        preprocessing.preprocess_input(torch.from_numpy(x), "keras")


def test_decode_predictions_matches_tpudl():
    scores = np.random.default_rng(4).uniform(size=(3, 1000))
    assert preprocessing.decode_predictions(scores, top=4) == \
        jpre.decode_predictions(scores, top=4)
    with pytest.raises(ValueError, match="1000"):
        preprocessing.decode_predictions(scores[:, :10])


# keras.applications' published parameter counts, with the top
KERAS_PARAMS = {"InceptionV3": 23_851_784, "Xception": 22_910_480,
                "ResNet50": 25_636_712, "VGG16": 138_357_544,
                "VGG19": 143_667_240, "MobileNetV2": 3_538_984,
                "DenseNet121": 8_062_504, "ResNet101": 44_707_176,
                "ResNet152": 60_419_944,
                # Keras also counts its Normalization layer's int ``count``
                "EfficientNetB0": 5_330_571 - 1}


def test_registry_lists_tpudl_names_and_builds_only_inception():
    """Every name of tpudl's registry builds in the port (no name is left
    unported since the nine other models landed): ``init(0)`` at the
    model's own input size has Keras's parameter count, and the
    featurizer's vector, run on meta tensors, is ``feature_dim`` wide."""
    assert list(registry.SUPPORTED_MODELS) == list(jreg.SUPPORTED_MODELS)
    for name, want in jreg.SUPPORTED_MODELS.items():
        got = registry.getKerasApplicationModel(name)
        assert (got.input_size, got.feature_dim, got.preprocess_mode,
                got.classes) == (want.input_size, want.feature_dim,
                                 want.preprocess_mode, want.classes)
        params = got.init(0)
        assert sum(a.size for g in params.values()
                   for a in g.values()) == KERAS_PARAMS[name], name
        meta = {layer: {k: convert.torch_layout(k, v).to("meta")
                        for k, v in leaves.items()}
                for layer, leaves in params.items()}
        del params
        x = torch.empty((1, *got.input_size, 3), device="meta")
        assert got.featurize(meta, x).shape == (1, got.feature_dim), name
    with pytest.raises(ValueError, match="unsupported model"):
        registry.getKerasApplicationModel("AlexNet")


def test_params_npz_round_trip_with_tpudl(tmp_path, small):
    params = {k: small["params"]["perturbed"][k]
              for k in ("conv2d", "batch_normalization")}
    path = str(tmp_path / "p.npz")
    jconvert.save_params_npz(params, path)
    got = convert.load_params_npz(path)
    convert.save_params_npz(got, str(tmp_path / "q.npz"))
    again = jconvert.load_params_npz(str(tmp_path / "q.npz"))
    for layer, leaves in params.items():
        for k, v in leaves.items():
            np.testing.assert_array_equal(got[layer][k], v)
            np.testing.assert_array_equal(again[layer][k], v)
    legacy = str(tmp_path / "legacy.npz")
    np.savez(legacy, params=np.array(params, dtype=object))
    with pytest.raises(ValueError, match="legacy pickled"):
        convert.load_params_npz(legacy)
    assert sorted(convert.load_params_npz(legacy, allow_legacy_pickle=True)
                  ) == sorted(params)
    # they read a .keras path now (held to tpudl in
    # test_torch_keras_stages.py); a path that is not there is an error
    for fn in (convert.params_from_keras, convert.load_keras_model):
        with pytest.raises(FileNotFoundError):
            fn(str(tmp_path / "model.keras"))


def test_load_named_params_sources(tmp_path, monkeypatch, small):
    params = {"conv2d": small["params"]["init"]["conv2d"]}
    convert.save_params_npz(params, str(tmp_path / "InceptionV3.npz"))
    monkeypatch.setenv("TPUDL_WEIGHTS_DIR", str(tmp_path))
    got = load_named_params("InceptionV3", "imagenet")
    np.testing.assert_array_equal(got["conv2d"]["kernel"],
                                  params["conv2d"]["kernel"])
    got = load_named_params("InceptionV3", str(tmp_path / "InceptionV3.npz"))
    assert list(got) == ["conv2d"]
    monkeypatch.setenv("TPUDL_WEIGHTS_DIR", str(tmp_path / "empty"))
    with pytest.raises(RuntimeError, match="never downloads"):
        load_named_params("InceptionV3", "imagenet")
    # any other path is a Keras model file (held to tpudl in
    # test_torch_named_keras_weights.py); a path that is not there is an
    # error
    with pytest.raises(FileNotFoundError):
        load_named_params("InceptionV3", str(tmp_path / "model.keras"))


# -- the stages over readImages, at the model's 299×299 ------------------

@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    """3 JPEGs and a garbage file; at batchSize 2 the first batch shrinks
    to 299×299 and the second grows."""
    d = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(5)
    for i, shape in enumerate([(320, 400, 3), (320, 400, 3), (120, 90, 3)]):
        Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8)).save(
            d / f"img{i}.jpg", quality=90)
    (d / "zz_bad.jpg").write_bytes(b"not a jpeg")
    return str(d)


@pytest.fixture(scope="module")
def tpudl_stage_outputs(image_dir):
    frame = jio.readImages(image_dir).dropna()
    common = dict(inputCol="image", modelName="InceptionV3", batchSize=2)
    feat = JaxFeaturizer(outputCol="f", **common).transform(frame)
    pred = JaxPredictor(outputCol="p", decodePredictions=True, topK=3,
                        **common).transform(frame)
    return np.stack(list(feat["f"])), list(pred["p"])


@pytest.fixture(scope="module")
def port_features(image_dir):
    frame = imageIO.readImages(image_dir).dropna()
    feat = DeepImageFeaturizer(inputCol="image", outputCol="f",
                               modelName="InceptionV3", batchSize=2,
                               device="cpu")
    out = feat.transform(frame)
    assert out.columns == ["image", "f"]
    return feat, frame, np.stack(list(out["f"]))


def test_featurizer_over_read_images_matches_tpudl(tpudl_stage_outputs,
                                                   port_features):
    want, _ = tpudl_stage_outputs
    _, frame, got = port_features
    assert len(frame) == 3
    assert got.shape == want.shape == (3, 2048) and got.dtype == np.float32
    assert _rel_err(got, want) <= TOL


def test_predictor_decoded_matches_tpudl(image_dir, tpudl_stage_outputs):
    _, want = tpudl_stage_outputs
    frame = imageIO.readImages(image_dir).dropna()
    out = DeepImagePredictor(inputCol="image", outputCol="p",
                             modelName="InceptionV3", decodePredictions=True,
                             topK=3, batchSize=2, device="cpu").transform(frame)
    got = list(out["p"])
    assert len(got) == len(want) == 3
    scale = max(s for row in want for _, _, s in row)
    for g, w in zip(got, want):
        assert [e[:2] for e in g] == [e[:2] for e in w]
        assert all(isinstance(e, tuple) and len(e) == 3 for e in g)
        assert max(abs(a[2] - b[2]) for a, b in zip(g, w)) <= TOL * scale


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_reduced_compute_dtype_within_tolerance_of_f32(port_features, dtype):
    feat, frame, f32 = port_features
    reduced = feat.copy()
    reduced.computeDtype = dtype
    got = np.stack(list(reduced.transform(frame)["f"]))
    assert got.dtype == np.float32
    assert _rel_err(got, f32) <= REDUCED_TOL[dtype]
    assert feat._loaded[1].dtype == torch.float32      # the copy reloaded
    assert reduced._loaded[1].dtype == getattr(torch, dtype)


def test_featurizer_reuses_loaded_weights_and_warms(port_features):
    feat, frame, f32 = port_features
    net = feat._loaded[1]
    assert feat.warmup(40, 30) is feat
    out = feat.transform(frame.head(1), {feat.outputCol: "g"})
    assert out.columns == ["image", "g"] and feat._loaded[1] is net
    assert _rel_err(out["g"][0][None], f32[:1]) <= TOL


@pytest.mark.parametrize("head", ["featurizer", "predictor"])
def test_stage_over_a_mesh_matches_tpudl(image_dir, tpudl_stage_outputs,
                                         port_features, head):
    """``mesh=`` (once refused, 'Training, rest'): the stage over a mesh of
    2 host entries (a batch of 2 splits one row an entry; the tail of 1
    pads to 2) holds tpudl's outputs and the run without a mesh within
    TOL of max |y|."""
    from tpudl_torch import mesh as port_mesh

    mesh = port_mesh.build_mesh(devices=["cpu"] * 2)
    want_f, want_p = tpudl_stage_outputs
    feat, frame, f32 = port_features
    if head == "featurizer":
        meshed = feat.copy()
        meshed.mesh = mesh
        got = np.stack(list(meshed.transform(frame)["f"]))
        assert _rel_err(got, want_f) <= TOL and _rel_err(got, f32) <= TOL
        assert last_pipeline_report()["mesh"] == {"data": 2, "model": 1}
        return
    out = DeepImagePredictor(inputCol="image", outputCol="p",
                             modelName="InceptionV3", decodePredictions=True,
                             topK=3, batchSize=2, mesh=mesh).transform(frame)
    scale = max(s for row in want_p for _, _, s in row)
    for g, w in zip(list(out["p"]), want_p):
        assert [e[:2] for e in g] == [e[:2] for e in w]
        assert max(abs(a[2] - b[2]) for a, b in zip(g, w)) <= TOL * scale


@pytest.mark.parametrize("kwargs,opt", [
    ({"cacheDir": "/tmp/c"}, "cache_dir"),
    ({"deviceCache": True}, "device_cache"),
    ({"wireCodec": "u8"}, "wire_codec"),
])
@pytest.mark.parametrize("stage", [DeepImageFeaturizer, DeepImagePredictor])
def test_data_layer_options_reach_the_executor(stage, kwargs, opt):
    """The data layer's knobs, once refused ('Data layer'), pass to
    ``map_batches`` as tpudl's stage passes them."""
    from tpudl.ml import DeepImageFeaturizer as JaxFeat
    from tpudl.ml import DeepImagePredictor as JaxPred

    jstage = {DeepImageFeaturizer: JaxFeat,
              DeepImagePredictor: JaxPred}[stage]
    ours = stage(inputCol="image", outputCol="y", modelName="InceptionV3",
                 device="cpu", **kwargs)._pipeline_opts()
    theirs = jstage(inputCol="image", outputCol="y",
                    modelName="InceptionV3", **kwargs)._pipeline_opts()
    assert ours == theirs and ours[opt] == next(iter(kwargs.values()))


def test_stage_refusals_and_validation(image_dir):
    frame = imageIO.readImages(image_dir).dropna().head(1)
    common = dict(inputCol="image", outputCol="y", device="cpu")
    with pytest.raises(FileNotFoundError):       # a Keras file not there
        DeepImageFeaturizer(modelName="InceptionV3", weights="m.h5",
                            **common).transform(frame)
    with pytest.raises(TypeError, match="unsupported"):
        DeepImageFeaturizer(modelName="AlexNet", **common)
    with pytest.raises(ValueError, match="computeDtype"):
        DeepImageFeaturizer(modelName="InceptionV3", computeDtype="int8",
                            **common)
    with pytest.raises(TypeError, match="int"):
        DeepImagePredictor(modelName="InceptionV3", topK=2.5, **common)
    assert isinstance(DeepImageFeaturizer(
        modelName="InceptionV3", wireCodec=WireCodec(), **common).wireCodec,
        WireCodec)


def test_default_device_is_the_card(image_dir):
    """Without a card the default device raises; nothing drops to the
    CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    frame = imageIO.readImages(image_dir).dropna().head(1)
    feat = DeepImageFeaturizer(inputCol="image", outputCol="y",
                               modelName="InceptionV3")
    assert feat.device == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        feat.transform(frame)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Frame({"x": np.zeros(2)}).map_batches(lambda t: t, ["x"], ["y"])
    assert os.environ.get("CUDA_VISIBLE_DEVICES") == "-1"
