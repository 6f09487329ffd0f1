"""Writes the TF graph fixtures of the port's ingestion tests with
tensorflow and keras (run by hand: ``python tests/fixtures/tf/make_tf_fixtures.py``;
pytest does not collect it). Every file it writes is committed:

- ``factory.pb``, ``factory_saved_model/``, ``factory_ckpt/``: tpudl's
  factory-matrix graph ``z = w*x + b`` (``tests/test_ingest.py``, float64,
  w = 3, b = 4) as a frozen GraphDef, a TF1 SavedModel with signature
  ``my_sig`` ({"input_sig": x} → {"output_sig": z}), and a TF1 Saver
  checkpoint whose ``model.meta`` carries that signature (its
  ``checkpoint`` state file names the prefix relative to the directory);
- ``tf2_mlp/``: the TF2 export of ``tests/test_debug_ingest_hardening.py``
  (``tf.saved_model.save`` of Dense 3→4 relu → 2 with a ``lambda x:
  {"out": model(x)}`` signature);
- ``keras_cnn/`` and ``keras_depthwise/``: ``model.export`` of the CNN and
  of the depth-multiplier-2 model of ``tests/test_ingest.py``, their BN
  statistics moved off 0 and 1;
- ``inception_v3_tl/``: ``model.export`` of configs[2]'s model (Keras
  InceptionV3 + ``Dense(2, softmax)`` from
  ``tests/fixtures/keras/inception_v3_tl.config.json.gz``): only
  ``saved_model.pb.gz``, the checkpointable object graph
  (``object_graph.bin.gz``) and ``variables.json.gz`` (each bundle key's
  Keras variable path), from which ``tf_bundle_writer.py`` writes its
  ``variables/`` for any weights.
"""

import gzip
import json
import os
import shutil
import sys
from pathlib import Path

os.environ.setdefault("CUDA_VISIBLE_DEVICES", "-1")
os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "2")

import numpy as np  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[1]))


def factory_graph(tf):
    g = tf.Graph()
    with g.as_default():
        x = tf.compat.v1.placeholder(tf.float64, shape=[None, 3], name="x")
        w = tf.compat.v1.get_variable(
            "w", dtype=tf.float64, initializer=np.float64(3.0))
        b = tf.compat.v1.get_variable(
            "b", dtype=tf.float64, initializer=np.float64(4.0))
        z = tf.add(tf.multiply(x, w), b, name="z")
    return g, x, z


def write_factory(tf, out: Path):
    g, x, z = factory_graph(tf)
    with tf.compat.v1.Session(graph=g) as sess:
        sess.run(tf.compat.v1.global_variables_initializer())
        frozen = tf.compat.v1.graph_util.convert_variables_to_constants(
            sess, g.as_graph_def(), ["z"])
    (out / "factory.pb").write_bytes(frozen.SerializeToString())

    sm = out / "factory_saved_model"
    shutil.rmtree(sm, ignore_errors=True)
    g, x, z = factory_graph(tf)
    with tf.compat.v1.Session(graph=g) as sess:
        sess.run(tf.compat.v1.global_variables_initializer())
        builder = tf.compat.v1.saved_model.builder.SavedModelBuilder(str(sm))
        sig = tf.compat.v1.saved_model.signature_def_utils.\
            predict_signature_def(inputs={"input_sig": x},
                                  outputs={"output_sig": z})
        builder.add_meta_graph_and_variables(
            sess, ["serve"], signature_def_map={"my_sig": sig})
        builder.save()

    ck = out / "factory_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    ck.mkdir()
    g, x, z = factory_graph(tf)
    with g.as_default(), tf.compat.v1.Session(graph=g) as sess:
        sess.run(tf.compat.v1.global_variables_initializer())
        sig = tf.compat.v1.saved_model.signature_def_utils.\
            predict_signature_def(inputs={"input_sig": x},
                                  outputs={"output_sig": z})
        saver = tf.compat.v1.train.Saver()
        saver.save(sess, str(ck / "model"))
        meta = tf.compat.v1.train.export_meta_graph(
            saver_def=saver.as_saver_def())
        meta.signature_def["my_sig"].CopyFrom(sig)
        (ck / "model.meta").write_bytes(meta.SerializeToString())
    (ck / "checkpoint").write_text(
        'model_checkpoint_path: "model"\n'
        'all_model_checkpoint_paths: "model"\n')


def write_tf2_mlp(tf, keras, out: Path):
    keras.utils.set_random_seed(0)
    model = keras.Sequential([
        keras.layers.Input((3,), name="inp"),
        keras.layers.Dense(4, activation="relu"),
        keras.layers.Dense(2),
    ])
    d = out / "tf2_mlp"
    shutil.rmtree(d, ignore_errors=True)
    tf.saved_model.save(
        model, str(d),
        signatures=tf.function(
            lambda x: {"out": model(x)}).get_concrete_function(
                tf.TensorSpec([None, 3], tf.float32, name="x")))


def keras_model(keras, name):
    keras.backend.clear_session()
    L = keras.layers
    if name == "keras_cnn":
        keras.utils.set_random_seed(0)
        m = keras.Sequential([
            L.Input((16, 16, 3)),
            L.Conv2D(4, 3, padding="same", activation="relu"),
            L.BatchNormalization(),
            L.MaxPooling2D(2),
            L.DepthwiseConv2D(3, padding="same"),
            L.AveragePooling2D(2),
            L.Flatten(),
            L.Dense(5),
        ])
    else:
        keras.utils.set_random_seed(1)
        m = keras.Sequential([
            L.Input((8, 8, 3)),
            L.DepthwiseConv2D(3, depth_multiplier=2, padding="same"),
        ])
    rng = np.random.default_rng(7)
    for w in m.weights:
        leaf = w.path.rsplit("/", 1)[1]
        if leaf in ("moving_mean", "beta"):
            w.assign(rng.normal(0, 0.1, w.shape).astype(np.float32))
        elif leaf in ("moving_variance", "gamma"):
            w.assign(rng.uniform(0.5, 1.5, w.shape).astype(np.float32))
    return m


def write_inception(tf, keras, out: Path):
    import torch_keras_models as tkm

    model = tkm.build("inception")
    rng = np.random.default_rng(0)
    for w in model.weights:          # unique values: keys map by equality
        w.assign(rng.normal(size=w.shape).astype(np.float32))
    tmp = out / "_inception_export"
    shutil.rmtree(tmp, ignore_errors=True)
    model.export(str(tmp), verbose=False)
    reader = tf.train.load_checkpoint(str(tmp / "variables" / "variables"))
    values = {w.path: np.asarray(w) for w in model.weights}
    keys = {}
    for key in sorted(reader.get_variable_to_shape_map()):
        if key == "_CHECKPOINTABLE_OBJECT_GRAPH":
            continue
        v = reader.get_tensor(key)
        match = [p for p, a in values.items()
                 if a.shape == v.shape and np.array_equal(a, v)]
        if len(match) != 1:
            raise RuntimeError(f"{key}: {len(match)} matching variables")
        keys[key] = match[0]
    d = out / "inception_v3_tl"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir()
    (d / "saved_model.pb.gz").write_bytes(gzip.compress(
        (tmp / "saved_model.pb").read_bytes(), mtime=0))
    (d / "object_graph.bin.gz").write_bytes(gzip.compress(
        reader.get_tensor("_CHECKPOINTABLE_OBJECT_GRAPH"), mtime=0))
    (d / "variables.json.gz").write_bytes(gzip.compress(
        json.dumps(keys, sort_keys=True).encode(), mtime=0))
    shutil.rmtree(tmp)


def main():
    import keras
    import tensorflow as tf

    sys.path.insert(0, str(HERE.parents[0]))
    write_factory(tf, HERE)
    write_tf2_mlp(tf, keras, HERE)
    for name in ("keras_cnn", "keras_depthwise"):
        d = HERE / name
        shutil.rmtree(d, ignore_errors=True)
        keras_model(keras, name).export(str(d), verbose=False)
    write_inception(tf, keras, HERE)
    for p in sorted(HERE.rglob("*")):
        if p.is_file():
            print(p.relative_to(HERE), p.stat().st_size)


if __name__ == "__main__":
    main()
