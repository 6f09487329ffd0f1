"""``TFImageTransformer`` held to tpudl's on the CPU, on the same image
structs: a ``TFInputGraph`` graph (a keras-written ``.keras`` file both
packages read) and a callable graph (a torch function beside a jax
function of the same numpy weights), each in the three channel orders and
both output modes; ``inputTensor``/``outputTensor`` picking the second
output of a two-output functional model (tpudl names the tensors by its
GraphDef, the port by Keras layer: each side passes its own names for the
same positions); the function cached across transforms; the mixed-shape
refusal and the refused knobs.

Tolerance: 1e-5 of max |y| (f32 products in another order, as the Keras
stages' tests); image structs' shapes, modes and channel counts exact."""

import json
import zipfile

import numpy as np
import pytest
import torch

keras = pytest.importorskip("keras")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch_keras_models as M  # noqa: E402

from tpudl.frame import Frame as JaxFrame  # noqa: E402
from tpudl.image import imageIO as jax_imageIO  # noqa: E402
from tpudl.ingest import TFInputGraph as JaxTFInputGraph  # noqa: E402
from tpudl.ml import TFImageTransformer as JaxTFImage  # noqa: E402
from tpudl_torch.frame import Frame  # noqa: E402
from tpudl_torch.image import imageIO  # noqa: E402
from tpudl_torch.ingest import TFInputGraph  # noqa: E402
from tpudl_torch.ml import TFImageTransformer  # noqa: E402
from torch_native_fixture import private_tpudl_decoder  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("private_tpudl_decoder")

torch.set_num_threads(1)
RTOL = 1e-5
SHAPE = (17, 15, 3)      # conv_image's input


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def _structs(module, shapes, seed=0):
    rng = np.random.default_rng(seed)
    col = np.empty(len(shapes), dtype=object)
    col[:] = [module.imageArrayToStruct(rng.integers(0, 256, s,
                                                     dtype=np.uint8))
              for s in shapes]
    return col


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("tf_image")
    keras.backend.clear_session()
    keras.utils.set_random_seed(0)
    L = keras.layers
    inp = L.Input((8, 8, 3))
    a = L.Conv2D(4, 3, padding="same", activation="relu")(inp)
    p = L.GlobalAveragePooling2D()(a)
    two = keras.Model(inp, [L.Dense(3, activation="softmax")(p),
                            L.Dense(2)(p)])
    two_path = str(d / "two.keras")
    two.save(two_path)
    return {"conv_image": M.saved("conv_image", d), "two": two_path}


@pytest.fixture(scope="module")
def pixel_weights():
    rng = np.random.default_rng(3)
    return (rng.normal(size=(3, 4)).astype(np.float32) / 100,
            rng.normal(size=(4,)).astype(np.float32))


def _graphs(kind, files, pixel_weights):
    """(port graph, tpudl graph) of one kind."""
    if kind == "keras":
        return (TFInputGraph.fromKeras(files["conv_image"]),
                JaxTFInputGraph.fromKeras(files["conv_image"]))
    w, b = pixel_weights
    tw, tb = torch.from_numpy(w), torch.from_numpy(b)
    return (lambda x: torch.sigmoid(x @ tw + tb),
            lambda x: jax.nn.sigmoid(x @ jnp.asarray(w) + jnp.asarray(b)))


def _outputs(col, mode, module):
    if mode == "vector":
        return np.stack([np.asarray(v) for v in col])
    assert all(s["mode"] == col[0]["mode"] for s in col)
    return np.stack([module.imageStructToArray(s) for s in col])


@pytest.mark.parametrize("mode", ["vector", "image"])
@pytest.mark.parametrize("order", ["RGB", "BGR", "L"])
@pytest.mark.parametrize("kind", ["keras", "callable"])
def test_tf_image_transformer_matches_tpudl(files, pixel_weights, kind,
                                            order, mode):
    ours_g, theirs_g = _graphs(kind, files, pixel_weights)
    kw = dict(inputCol="image", outputCol="out", channelOrder=order,
              outputMode=mode, batchSize=4)
    shapes = [SHAPE] * 7           # a ragged last batch
    got_f = TFImageTransformer(graph=ours_g, device="cpu", **kw).transform(
        Frame({"image": _structs(imageIO, shapes)}))
    want_f = JaxTFImage(graph=theirs_g, **kw).transform(
        JaxFrame({"image": _structs(jax_imageIO, shapes)}))
    assert got_f.columns == want_f.columns == ["image", "out"]
    if mode == "image":
        g0, w0 = got_f["out"][0], want_f["out"][0]
        assert (g0["height"], g0["width"], g0["nChannels"], g0["mode"]) == \
            (w0["height"], w0["width"], w0["nChannels"], w0["mode"])
    got = _outputs(got_f["out"], mode, imageIO)
    want = _outputs(want_f["out"], mode, jax_imageIO)
    assert got.shape == want.shape and len(got) == 7
    assert _rel(got, want) <= RTOL


def test_bgr_equals_rgb_on_flipped_input(files):
    g = TFInputGraph.fromKeras(files["conv_image"])
    col = _structs(imageIO, [SHAPE] * 5)
    flipped = np.empty(5, dtype=object)
    flipped[:] = [imageIO.imageArrayToStruct(
        np.ascontiguousarray(imageIO.imageStructToArray(s)[..., ::-1]))
        for s in col]
    rgb = TFImageTransformer(inputCol="image", outputCol="o", graph=g,
                             channelOrder="RGB", device="cpu")
    bgr = TFImageTransformer(inputCol="image", outputCol="o", graph=g,
                             channelOrder="BGR", device="cpu")
    a = np.stack(list(bgr.transform(Frame({"image": col}))["o"]))
    b = np.stack(list(rgb.transform(Frame({"image": flipped}))["o"]))
    assert np.array_equal(a, b)


def test_input_output_tensor_picks_an_output(files):
    ours_g = TFInputGraph.fromKeras(files["two"])
    theirs_g = JaxTFInputGraph.fromKeras(files["two"])
    assert len(ours_g.output_names) == len(theirs_g.output_names) == 2
    shapes = [(8, 8, 3)] * 5
    for pick in (0, 1):
        got = TFImageTransformer(
            inputCol="image", outputCol="out", graph=ours_g,
            inputTensor=ours_g.input_names[0],
            outputTensor=ours_g.output_names[pick], batchSize=2,
            device="cpu").transform(Frame({"image": _structs(imageIO,
                                                             shapes)}))
        want = JaxTFImage(
            inputCol="image", outputCol="out", graph=theirs_g,
            inputTensor=theirs_g.input_names[0],
            outputTensor=theirs_g.output_names[pick],
            batchSize=2).transform(JaxFrame({"image": _structs(
                jax_imageIO, shapes)}))
        a = np.stack(list(got["out"]))
        b = np.stack(list(want["out"]))
        assert a.shape == b.shape == (5, (3, 2)[pick])
        assert _rel(a, b) <= RTOL
    with pytest.raises(NotImplementedError, match="feeds/fetches"):
        TFImageTransformer(inputCol="image", outputCol="out", graph=ours_g,
                           outputTensor="nosuch:0", device="cpu").transform(
            Frame({"image": _structs(imageIO, shapes)}))


def test_batch_function_is_cached_per_configuration(files):
    g = TFInputGraph.fromKeras(files["conv_image"])
    t = TFImageTransformer(inputCol="image", outputCol="o", graph=g,
                           device="cpu")
    frame = Frame({"image": _structs(imageIO, [SHAPE] * 3)})
    t.transform(frame)
    fn = t._fn_entry[1]
    t.transform(frame)
    assert t._fn_entry[1] is fn
    t.setOutputMode("image")
    t.transform(frame)
    assert t._fn_entry[1] is not fn


def test_mixed_shapes_and_unported_knobs_are_refused(files):
    g = TFInputGraph.fromKeras(files["conv_image"])
    shapes = [SHAPE, (16, 15, 3)]
    with pytest.raises(ValueError, match="mixed image shapes"):
        TFImageTransformer(inputCol="image", outputCol="o", graph=g,
                           device="cpu").transform(
            Frame({"image": _structs(imageIO, shapes)}))
    with pytest.raises(ValueError, match="mixed image shapes"):
        JaxTFImage(inputCol="image", outputCol="o",
                   graph=JaxTFInputGraph.fromKeras(files["conv_image"])
                   ).transform(JaxFrame({"image": _structs(jax_imageIO,
                                                           shapes)}))
    with pytest.raises(TypeError, match="channelOrder"):
        TFImageTransformer(inputCol="image", outputCol="o", graph=g,
                           channelOrder="HSV")
    # mesh (once refused, 'Training, rest') runs over the mesh's entries,
    # as tpudl's stage runs over 2 of its devices
    import jax

    from tpudl import mesh as jax_mesh
    from tpudl_torch import mesh as port_mesh

    five = [SHAPE] * 5
    got = TFImageTransformer(
        inputCol="image", outputCol="o", graph=g, batchSize=4,
        mesh=port_mesh.build_mesh(devices=["cpu"] * 2)).transform(
            Frame({"image": _structs(imageIO, five)}))
    want = JaxTFImage(
        inputCol="image", outputCol="o", batchSize=4,
        graph=JaxTFInputGraph.fromKeras(files["conv_image"]),
        mesh=jax_mesh.build_mesh(devices=jax.devices()[:2])).transform(
            JaxFrame({"image": _structs(jax_imageIO, five)}))
    assert _rel(np.stack(list(got["o"])), np.stack(list(want["o"]))) <= RTOL
    # the data layer's knobs (once refused, 'Data layer') pass to the
    # executor, as tpudl's stage passes them
    for knob, value in (("cacheDir", "/tmp/x"), ("deviceCache", True),
                        ("wireCodec", "u8")):
        ours = TFImageTransformer(inputCol="image", outputCol="o", graph=g,
                                  **{knob: value})._pipeline_opts()
        theirs = JaxTFImage(inputCol="image", outputCol="o",
                            graph=JaxTFInputGraph.fromKeras(
                                files["conv_image"]),
                            **{knob: value})._pipeline_opts()
        assert ours == theirs
    with pytest.raises(RuntimeError, match="cuda"):     # default: the card
        TFImageTransformer(inputCol="image", outputCol="o",
                           graph=g).transform(
            Frame({"image": _structs(imageIO, [SHAPE])}))


def test_chip_smokes_conv_image_config_is_what_keras_writes(files):
    """chip_smoke phase 10 writes the ``conv_image`` model's config itself
    (the card's machine has no keras): it is the one keras writes."""
    import chip_smoke

    with zipfile.ZipFile(files["conv_image"]) as z:
        want = M.normalized_config(json.loads(z.read("config.json")))
    assert M.normalized_config(
        chip_smoke.keras_conv_image_config(*SHAPE[:2])) == want
