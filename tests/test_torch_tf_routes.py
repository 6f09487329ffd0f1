"""TFInputGraph's GraphDef, SavedModel and checkpoint routes in the port,
held against tpudl's routes on the same files (the committed fixtures of
``tests/fixtures/tf`` and graphs TF writes here): the names and signature
maps equal, the outputs within 1e-12 on the float64 factory graph (tpudl
under ``jax.enable_x64``) and 1e-5 relative in float32; ``GraphFunction``
as tpudl's ``tests/test_builder.py`` drives it; tpudl's hardening tests
(``tests/test_debug_ingest_hardening.py``); and ``TFTransformer``,
``TFImageTransformer`` and ``makeGraphUDF`` over proto graphs against
tpudl's stages on the same rows.

On a Keras ``model.export`` tpudl's signature route keeps the main graph
and its library functions, and its evaluator does not finish there (it
looks ``node:out_arg:idx`` names up as they are; ROADMAP Queue 3,
reference caveats), so those files are held to ``tf.saved_model.load``'s
signature instead, and tpudl's names are compared through its route on
the function graph (``fromSavedModel`` with ``keras_tensor:0`` →
``Identity:0``)."""

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

import jax  # noqa: E402

from tpudl.ingest import TFInputGraph as J  # noqa: E402
from tpudl_torch.ingest import GraphFunction, IsolatedSession  # noqa: E402
from tpudl_torch.ingest import TFInputGraph as T  # noqa: E402

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "tf"
SM = str(FIXTURES / "factory_saved_model")
CKPT = str(FIXTURES / "factory_ckpt")
X64 = np.random.default_rng(7).normal(size=(5, 3))


def _tpudl(gin, *xs, x64=False):
    with jax.enable_x64(x64):
        out = jax.jit(gin.make_fn())(*xs)
        return np.asarray(out[0] if isinstance(out, tuple) else out)


def _port(gin, *xs):
    out = gin.make_fn()(*[torch.from_numpy(np.asarray(x)) for x in xs])
    return (out[0] if isinstance(out, tuple) else out).numpy()


def _same_names(mine, theirs):
    assert mine.input_names == theirs.input_names
    assert mine.output_names == theirs.output_names
    assert (mine.input_tensor_name_from_signature
            == theirs.input_tensor_name_from_signature)
    assert (mine.output_tensor_name_from_signature
            == theirs.output_tensor_name_from_signature)
    assert mine.trainable is False and theirs.trainable is False


FACTORY_ROUTES = {
    "fromGraphDef": lambda G: G.fromGraphDef(
        _frozen_factory(G), ["x"], ["z"]),
    "fromSavedModel": lambda G: G.fromSavedModel(SM, "serve", ["x:0"],
                                                 ["z:0"]),
    "fromSavedModel-tag-list": lambda G: G.fromSavedModel(
        SM, ["serve"], ["x:0"], ["z:0"]),
    "fromSavedModelWithSignature": lambda G: G.fromSavedModelWithSignature(
        SM, "serve", "my_sig"),
    "fromCheckpoint": lambda G: G.fromCheckpoint(CKPT, ["x:0"], ["z:0"]),
    "fromCheckpointWithSignature": lambda G: G.fromCheckpointWithSignature(
        CKPT, "my_sig"),
}


def _frozen_factory(G):
    data = (FIXTURES / "factory.pb").read_bytes()
    if G is T:
        return data
    gdef = tf.compat.v1.GraphDef()
    gdef.ParseFromString(data)
    return gdef


@pytest.mark.parametrize("route", sorted(FACTORY_ROUTES))
def test_factory_routes_match_tpudl_in_float64(route):
    mine, theirs = (FACTORY_ROUTES[route](G) for G in (T, J))
    _same_names(mine, theirs)
    got = _port(mine, X64)
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, _tpudl(theirs, X64, x64=True),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got, 3 * X64 + 4, rtol=1e-12, atol=1e-12)
    # a float32 feed is cast to the placeholder's float64
    assert mine.make_fn()(torch.from_numpy(X64.astype(np.float32))).dtype \
        == torch.float64


def test_from_graph_def_takes_a_tf_proto():
    mine = T.fromGraphDef(_frozen_factory(J), ["x"], ["z"])
    np.testing.assert_allclose(_port(mine, X64), 3 * X64 + 4, rtol=1e-12)


def _v1_graph(use_resource):
    g = tf.Graph()
    with g.as_default():
        x = tf.compat.v1.placeholder(tf.float64, [None, 3], name="x")
        w = tf.compat.v1.get_variable("w", dtype=tf.float64,
                                      initializer=np.float64(3.0),
                                      use_resource=use_resource)
        b = tf.compat.v1.get_variable("b", dtype=tf.float64,
                                      initializer=np.arange(3.0),
                                      use_resource=use_resource)
        tf.add(tf.multiply(x, w), b, name="z")
    return g


@pytest.mark.parametrize("use_resource", [True, False],
                         ids=["VarHandleOp", "VariableV2"])
def test_from_graph_reads_variables_through_the_session(use_resource):
    g = _v1_graph(use_resource)
    with tf.compat.v1.Session(graph=g) as sess:
        sess.run(tf.compat.v1.global_variables_initializer())
        mine = T.fromGraph(g, sess, ["x:0"], ["z:0"])
        theirs = J.fromGraph(g, sess, ["x:0"], ["z:0"])
        want = sess.run("z:0", {"x:0": X64})
    ops = {n.op for n in mine.graph_def.node}
    assert not ops & {"VariableV2", "VarHandleOp"} and "Const" in ops
    _same_names(mine, theirs)
    np.testing.assert_allclose(_port(mine, X64), want, rtol=1e-12)
    np.testing.assert_allclose(_port(mine, X64), _tpudl(theirs, X64,
                                                        x64=True),
                               rtol=1e-12)


@pytest.mark.parametrize("use_resource", [True, False],
                         ids=["VarHandleOp", "VariableV2"])
def test_checkpoint_of_either_variable_kind(use_resource, tmp_path):
    """A Saver checkpoint of ``VariableV2`` (``Assign``, ``Identity`` reads)
    or ``VarHandleOp`` (``AssignVariableOp``, ``ReadVariableOp``)
    variables; the restore subgraph names each variable's bundle key."""
    g = _v1_graph(use_resource)
    with g.as_default(), tf.compat.v1.Session(graph=g) as sess:
        sess.run(tf.compat.v1.global_variables_initializer())
        sess.run(tf.compat.v1.assign_add(
            tf.compat.v1.global_variables()[0], np.float64(0.5)))
        tf.compat.v1.train.Saver().save(sess, str(tmp_path / "model"))
    mine = T.fromCheckpoint(str(tmp_path), ["x:0"], ["z:0"])
    theirs = J.fromCheckpoint(str(tmp_path), ["x:0"], ["z:0"])
    _same_names(mine, theirs)
    got = _port(mine, X64)
    np.testing.assert_allclose(got, _tpudl(theirs, X64, x64=True),
                               rtol=1e-12)
    np.testing.assert_allclose(got, 3.5 * X64 + np.arange(3.0), rtol=1e-12)


def _tf_signature(d, x, arg="keras_tensor", out="output_0"):
    loaded = tf.saved_model.load(d)
    return loaded.signatures["serving_default"](
        **{arg: tf.constant(x)})[out].numpy()


TF2 = {"tf2_mlp": ((5, 3), "x:0", "x", "out"),
       "keras_cnn": ((2, 16, 16, 3), "keras_tensor:0", "keras_tensor",
                     "output_0"),
       "keras_depthwise": ((2, 8, 8, 3), "keras_tensor:0", "keras_tensor",
                           "output_0")}


@pytest.mark.parametrize("name", sorted(TF2))
def test_tf2_signature_route_names_and_values(name):
    shape, feed, arg, out = TF2[name]
    d = str(FIXTURES / name)
    x = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    mine = T.fromSavedModelWithSignature(d, "serve", "serving_default")
    want = _tf_signature(d, x, arg, out)
    got = _port(mine, x)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    if name == "tf2_mlp":      # tpudl's v2 route: the function's names
        theirs = J.fromSavedModelWithSignature(d, "serve", "serving_default")
        _same_names(mine, theirs)
        np.testing.assert_allclose(got, _tpudl(theirs, x), rtol=1e-5,
                                   atol=1e-6)
    else:                      # tpudl's v1 route: the main graph's names
        assert mine.input_tensor_name_from_signature == {
            "keras_tensor": "serving_default_keras_tensor:0"}
        assert mine.output_tensor_name_from_signature == {
            "output_0": "StatefulPartitionedCall_1:0"}
    # the function graph's names through fromSavedModel, as tpudl takes them
    mine = T.fromSavedModel(d, "serve", [feed], ["Identity:0"])
    theirs = J.fromSavedModel(d, "serve", [feed], ["Identity:0"])
    _same_names(mine, theirs)
    np.testing.assert_allclose(_port(mine, x), _tpudl(theirs, x), rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_signature_and_tag_errors_name_what_is_there():
    with pytest.raises(KeyError, match="my_sig"):
        T.fromSavedModelWithSignature(SM, "serve", "nope")
    with pytest.raises(KeyError, match="serving_default"):
        T.fromSavedModelWithSignature(str(FIXTURES / "keras_cnn"), "serve",
                                      "nope")
    with pytest.raises(KeyError, match="my_sig"):
        T.fromCheckpointWithSignature(CKPT, "nope")
    with pytest.raises(RuntimeError, match="could not be found"):
        T.fromSavedModel(SM, "train", ["x:0"], ["z:0"])
    with pytest.raises(ValueError, match="no checkpoint found"):
        T.fromCheckpoint(str(FIXTURES), ["x:0"], ["z:0"])
    with pytest.raises(ValueError, match="not found"):
        T.fromSavedModel(str(FIXTURES / "tf2_mlp"), "serve",
                         ["serving_default_x:0"],
                         ["StatefulPartitionedCall:0"])


def test_corrupt_meta_graph_raises(tmp_path):
    for p in Path(CKPT).iterdir():
        shutil.copy(p, tmp_path / p.name)
    (tmp_path / "model.meta").write_bytes(b"\xff\xff\xff")
    with pytest.raises(ValueError, match="corrupt meta graph"):
        T.fromCheckpointWithSignature(str(tmp_path), "my_sig")


# -- tpudl's hardening tests (tests/test_debug_ingest_hardening.py) ---------
def _tiny_graph_def():
    with tf.Graph().as_default() as g:
        x = tf.compat.v1.placeholder(tf.float32, [None, 2], name="x")
        w = tf.constant([[3.0], [4.0]], name="w")
        tf.identity(tf.matmul(x, w), name="z")
    return g.as_graph_def(add_shapes=True)


@pytest.mark.parametrize("feeds, fetches, match", [
    (["w:0"], ["z:0"], "not a graph input"),
    (["nope:0"], ["z:0"], "not found"),
    (["x:0"], ["gone:0"], "not found")])
def test_feeds_and_fetches_are_validated_as_tpudl_does(feeds, fetches, match):
    for G in (T, J):
        with pytest.raises(ValueError, match=match):
            G.fromGraphDef(_tiny_graph_def(), feeds, fetches)


def test_valid_names_pass_and_run():
    gin = T.fromGraphDef(_tiny_graph_def(), ["x:0"], ["z:0"])
    assert np.allclose(_port(gin, np.array([[1.0, 1.0]], np.float32)),
                       [[7.0]])


def test_tf2_export_through_tf_transformer_like_tpudl():
    from tpudl.frame import Frame as JFrame
    from tpudl.ml.tf_tensor import TFTransformer as JT
    from tpudl_torch.frame import Frame
    from tpudl_torch.ml import TFTransformer

    d = str(FIXTURES / "tf2_mlp")
    x = np.random.default_rng(0).normal(size=(5, 3)).astype(np.float32)
    outs = []
    for G, stage, frame, kw in ((T, TFTransformer, Frame, {"device": "cpu"}),
                                (J, JT, JFrame, {})):
        gin = G.fromSavedModelWithSignature(d, "serve", "serving_default")
        t = stage(tfInputGraph=gin, inputMapping={"v": gin.input_names[0]},
                  outputMapping={gin.output_names[0]: "out"}, batchSize=3,
                  **kw)
        outs.append(np.stack(list(t.transform(frame({"v": x}))["out"])))
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(outs[0], _tf_signature(d, x, "x", "out"),
                               rtol=1e-5, atol=1e-6)


# -- GraphFunction (tpudl's tests/test_builder.py) ------------------------------
def test_from_list_pipes():
    g1 = GraphFunction(lambda x: x * 3.0, ["x"], ["y"])
    g2 = GraphFunction(lambda y: y + 4.0, ["y"], ["z"])
    piped = GraphFunction.fromList([("scale", g1), ("shift", g2)])
    x = torch.arange(5.0)
    np.testing.assert_allclose(piped.fn(x).numpy(), x.numpy() * 3 + 4)
    assert piped.input_names == ["scale/x:0"]
    assert piped.output_names == ["shift/z:0"]
    with pytest.raises(ValueError, match="cannot pipe"):
        GraphFunction.fromList([("two", GraphFunction(
            lambda x: (x, x), ["x"], ["a", "b"])), ("one", g1)])
    with pytest.raises(ValueError, match="zero functions"):
        GraphFunction.fromList([])
    with pytest.raises(TypeError, match="callable"):
        GraphFunction(3)


def test_multi_output_chain():
    g1 = GraphFunction(lambda x: (x + 1, x - 1), ["x"], ["hi", "lo"])
    g2 = GraphFunction(lambda a, b: a * b, ["a", "b"], ["prod"])
    piped = GraphFunction.fromList([("", g1), ("", g2)])
    assert float(piped(torch.tensor(3.0))) == 8.0


def test_from_tf_input_graph_and_from_keras_compose(tmp_path):
    """A proto graph and a Keras file as GraphFunctions, piped."""
    keras = pytest.importorskip("keras")
    from tpudl.ingest.builder import GraphFunction as JGF

    keras.utils.set_random_seed(0)
    m = keras.Sequential([keras.layers.Input((3,)),
                          keras.layers.Dense(2, activation="tanh")])
    path = str(tmp_path / "m.keras")
    m.save(path)
    x = np.random.default_rng(0).normal(size=(4, 3)).astype(np.float32)
    gfn = GraphFunction.fromKeras(path)
    np.testing.assert_allclose(gfn(torch.from_numpy(x)).numpy(),
                               m.predict(x, verbose=0), rtol=1e-5, atol=1e-6)
    pre = GraphFunction(lambda v: v / 2.0, ["raw"], ["scaled"])
    piped = GraphFunction.fromList([("pre", pre), ("net", gfn)])
    np.testing.assert_allclose(piped(torch.from_numpy(x)).numpy(),
                               m.predict(x / 2.0, verbose=0), rtol=1e-5,
                               atol=1e-6)
    mine = GraphFunction.fromTFInputGraph(FACTORY_ROUTES["fromCheckpoint"](T))
    theirs = JGF.fromTFInputGraph(FACTORY_ROUTES["fromCheckpoint"](J))
    assert (mine.input_names, mine.output_names) == (theirs.input_names,
                                                      theirs.output_names)
    np.testing.assert_allclose(mine(torch.from_numpy(X64)).numpy(),
                               3 * X64 + 4, rtol=1e-12)


def test_isolated_session_shim():
    with IsolatedSession(using_keras=True) as issn:
        gfn = issn.asGraphFunction(lambda x: torch.square(x), ["x"], ["y"])
        imported = issn.importGraphFunction(gfn, prefix="m")
        assert issn.importGraphFunction(gfn) is gfn
    assert imported.input_names == ["m/x:0"]
    assert float(imported(torch.tensor(3.0))) == 9.0


# -- stages over proto graphs, against tpudl's -------------------------------
def _two_input_graph():
    g = tf.Graph()
    with g.as_default():
        a = tf.compat.v1.placeholder(tf.float32, [None, 3], name="a")
        b = tf.compat.v1.placeholder(tf.float32, [None, 3], name="b")
        w = tf.constant(np.array([[1.0, -2.0], [0.5, 1.0], [2.0, 0.0]],
                                 np.float32))
        tf.nn.relu(tf.matmul(a * 2.0 - b, w), name="y")
    return g.as_graph_def()


def test_tf_transformer_with_two_input_columns_matches_tpudl():
    from tpudl.frame import Frame as JFrame
    from tpudl.ml.tf_tensor import TFTransformer as JT
    from tpudl_torch.frame import Frame
    from tpudl_torch.ml import TFTransformer

    rng = np.random.default_rng(1)
    cols = {"p": rng.normal(size=(7, 3)).astype(np.float32),
            "q": rng.normal(size=(7, 3)).astype(np.float32)}
    outs = []
    for G, stage, frame, kw in ((T, TFTransformer, Frame, {"device": "cpu"}),
                                (J, JT, JFrame, {})):
        gin = G.fromGraphDef(_two_input_graph(), ["a", "b"], ["y"])
        t = stage(tfInputGraph=gin, inputMapping={"p": "a:0", "q": "b:0"},
                  outputMapping={"y:0": "out"}, batchSize=3, **kw)
        outs.append(np.stack(list(t.transform(frame(cols))["out"])))
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-6, atol=1e-6)


def test_tf_transformer_resolves_signature_names_like_tpudl():
    from tpudl.frame import Frame as JFrame
    from tpudl.ml.tf_tensor import TFTransformer as JT
    from tpudl_torch.frame import Frame
    from tpudl_torch.ml import TFTransformer

    outs = []
    for G, stage, frame, kw in ((T, TFTransformer, Frame, {"device": "cpu"}),
                                (J, JT, JFrame, {})):
        gin = FACTORY_ROUTES["fromCheckpointWithSignature"](G)
        t = stage(tfInputGraph=gin, inputMapping={"v": "input_sig"},
                  outputMapping={"output_sig": "z"}, batchSize=2, **kw)
        with jax.enable_x64(True):
            outs.append(np.stack(list(t.transform(frame({"v": X64}))["z"])))
    # the port runs the float64 graph in float64; tpudl's stage returns
    # float32 rows
    assert outs[0].dtype == np.float64
    np.testing.assert_allclose(outs[0], 3 * X64 + 4, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-6, atol=1e-6)


def _structs(n, side, seed):
    from tpudl_torch.image import imageArrayToStruct

    rng = np.random.default_rng(seed)
    col = np.empty(n, dtype=object)
    col[:] = [imageArrayToStruct(rng.integers(0, 256, (side, side, 3),
                                              dtype=np.uint8))
              for _ in range(n)]
    return col


def test_tf_image_transformer_over_a_saved_model_matches_tpudl():
    from tpudl.frame import Frame as JFrame
    from tpudl.ml.tf_image import TFImageTransformer as JTI
    from tpudl_torch.frame import Frame
    from tpudl_torch.ml import TFImageTransformer

    d = str(FIXTURES / "keras_cnn")
    structs = _structs(5, 16, 0)
    outs = []
    for G, stage, frame, kw in ((T, TFImageTransformer, Frame,
                                 {"device": "cpu"}), (J, JTI, JFrame, {})):
        gin = G.fromSavedModel(d, "serve", ["keras_tensor:0"], ["Identity:0"])
        t = stage(inputCol="image", outputCol="out", graph=gin,
                  inputTensor="keras_tensor:0", outputTensor="Identity:0",
                  batchSize=2, **kw)
        outs.append(np.stack(list(t.transform(frame({"image": structs}))[
            "out"])))
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-5,
                               atol=1e-5 * np.abs(outs[1]).max())
    # the signature route's graph (main-graph names) gives the same rows
    gin = T.fromSavedModelWithSignature(d, "serve", "serving_default")
    sig = np.stack(list(TFImageTransformer(
        inputCol="image", outputCol="out", graph=gin, batchSize=2,
        device="cpu").transform(Frame({"image": structs}))["out"]))
    np.testing.assert_allclose(sig, outs[0], rtol=1e-6,
                               atol=1e-6 * np.abs(outs[0]).max())


def test_make_graph_udf_over_proto_graphs_and_graph_functions():
    from tpudl.frame import Frame as JFrame
    from tpudl.udf import makeGraphUDF as jmake
    from tpudl_torch.frame import Frame, sql
    from tpudl_torch.udf import makeGraphUDF, unregister_udf

    rng = np.random.default_rng(2)
    a = rng.normal(size=(6, 3)).astype(np.float32)
    b = rng.normal(size=(6, 3)).astype(np.float32)
    outs = []
    for G, make, frame, kw in ((T, makeGraphUDF, Frame, {"device": "cpu"}),
                               (J, jmake, JFrame, {})):
        gin = G.fromGraphDef(_two_input_graph(), ["a", "b"], ["y"])
        udf = make(gin, "two", register=False, batch_size=4, **kw)
        outs.append(np.stack(list(udf(frame({"a": a, "b": b}))["two_out"])))
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-6, atol=1e-6)
    # a GraphFunction over the checkpoint graph, through sql
    gfn = GraphFunction.fromList([
        ("ckpt", GraphFunction.fromTFInputGraph(
            FACTORY_ROUTES["fromCheckpoint"](T))),
        ("half", GraphFunction(lambda z: z / 2, ["z"], ["h"]))])
    makeGraphUDF(gfn, "ckpt_half", feeds_to_fields_map={"ckpt/x": "v"},
                 device="cpu")
    try:
        out = sql("SELECT ckpt_half(v) AS h FROM t",
                  {"t": Frame({"v": X64})})
    finally:
        unregister_udf("ckpt_half")
    np.testing.assert_allclose(np.stack(list(out["h"])), (3 * X64 + 4) / 2,
                               rtol=1e-12)
    with pytest.raises(ValueError, match="fetches"):
        makeGraphUDF(gfn, "bad", fetches=["y:0"], device="cpu")


def test_constants_are_uploaded_once_and_batches_copy_nothing():
    """After the first batch, a SavedModel graph's batch makes no
    host-to-device copy: every constant and every fold of constants is
    made once per device (a CUDA-graph capture records none)."""
    from tpudl_torch.ingest import graphdef as tg

    gin = T.fromSavedModelWithSignature(str(FIXTURES / "keras_cnn"),
                                        "serve", "serving_default")
    fn = gin.make_fn()
    x = torch.rand(2, 16, 16, 3)
    first = fn(x)
    calls = []
    orig_to_torch, orig_full = tg._to_torch, torch.full
    try:
        tg._to_torch = lambda a: calls.append("upload") or orig_to_torch(a)
        torch.full = lambda *a, **k: calls.append("fill") or orig_full(
            *a, **k)
        again = fn(x)
    finally:
        tg._to_torch, torch.full = orig_to_torch, orig_full
    assert calls == []
    assert torch.equal(first, again)
