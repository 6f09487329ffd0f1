"""Keras models for the port's Keras-surface tests, built with keras on the
host that has it (the tests import keras; ``tpudl_torch`` never does).

- ``mlp``: ``bench.py``'s ``measure_keras_transformer`` model
  (configs[4]): Dense 100→256→64→10, relu, relu, softmax;
- ``cnn``: ``bench.py``'s ``measure_estimator_fit`` model: Conv2D(8, 3)
  relu → GlobalAveragePooling2D → Dense(2) softmax on 32×32×3;
- ``functional``: a small Functional model with what the others lack:
  stride-2 ``same`` convolutions, ``same`` average and max pooling,
  Concatenate, Add, ZeroPadding2D, BatchNormalization with
  ``scale=False``, ReLU, Dropout, Flatten and Dense;
- ``conv_image``: one stride-2 ``same`` Conv2D, sigmoid: an image out;
- ``inception``: ``bench.py``'s ``measure_estimator_inception`` model
  (configs[2]): Keras InceptionV3 (``weights=None``,
  ``include_top=False``, ``pooling="avg"``) with a ``Dense(2, softmax)``
  head named ``head``.

Run as a script, it rewrites the committed InceptionV3 config fixture:
``python tests/torch_keras_models.py``.
"""

import gzip
import json
import os
import sys
import tempfile
import zipfile
from pathlib import Path

os.environ.setdefault("CUDA_VISIBLE_DEVICES", "-1")
os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "2")

FIXTURE = (Path(__file__).resolve().parent / "fixtures" / "keras"
           / "inception_v3_tl.config.json.gz")


def build(name):
    """A fresh keras model (``clear_session`` first, so that its layer
    names do not depend on what the process built before)."""
    import keras

    keras.backend.clear_session()
    keras.utils.set_random_seed(0)
    L = keras.layers
    if name == "mlp":
        return keras.Sequential([
            L.Input((100,)),
            L.Dense(256, activation="relu"),
            L.Dense(64, activation="relu"),
            L.Dense(10, activation="softmax"),
        ])
    if name == "cnn":
        return keras.Sequential([
            L.Input((32, 32, 3)),
            L.Conv2D(8, 3, activation="relu"),
            L.GlobalAveragePooling2D(),
            L.Dense(2, activation="softmax"),
        ])
    if name == "functional":
        x = inp = L.Input((17, 15, 3))
        a = L.Conv2D(8, 3, strides=2, padding="same", use_bias=False)(x)
        a = L.BatchNormalization(scale=False)(a)
        a = L.Activation("relu")(a)
        b = L.AveragePooling2D(3, strides=1, padding="same")(a)
        c = L.Conv2D(8, 1, padding="same", activation="tanh")(a)
        y = L.Concatenate()([b, c])
        y = L.ZeroPadding2D(((1, 0), (0, 2)))(y)
        y = L.Conv2D(16, 3, strides=2, padding="same",
                     activation="sigmoid")(y)
        z = L.Conv2D(16, 1)(L.MaxPooling2D(3, strides=2, padding="same")(
            L.ZeroPadding2D(((1, 0), (0, 2)))(b)))
        y = L.ReLU()(L.Add()([y, z]))
        y = L.BatchNormalization()(y)
        y = L.Dropout(0.5)(L.Flatten()(y))
        return keras.Model(inp, L.Dense(3, activation="softmax")(y))
    if name == "conv_image":     # an image out: KerasImageFileTransformer's
        return keras.Sequential([  # outputMode="image"
            L.Input((17, 15, 3)),
            L.Conv2D(4, 3, strides=2, padding="same", activation="sigmoid"),
        ])
    if name == "inception":
        base = keras.applications.InceptionV3(
            weights=None, include_top=False, pooling="avg")
        head = L.Dense(2, activation="softmax", name="head")(base.output)
        return keras.Model(base.input, head)
    raise KeyError(name)


def saved(name, directory) -> str:
    """``build(name)`` saved to ``directory/<name>.keras`` by keras."""
    path = os.path.join(str(directory), f"{name}.keras")
    build(name).save(path)
    return path


def normalized_config(config: dict) -> dict:
    """``config`` with each ``shared_object_id`` (a Python ``id`` at save
    time) renumbered 1, 2, ... in order of appearance."""
    ids = {}

    def walk(v):
        if isinstance(v, dict):
            return {k: (ids.setdefault(x, len(ids) + 1)
                        if k == "shared_object_id" else walk(x))
                    for k, x in v.items()}
        if isinstance(v, list):
            return [walk(x) for x in v]
        return v

    return walk(config)


def inception_config() -> dict:
    """The normalized ``config.json`` that keras writes for ``inception``."""
    with tempfile.TemporaryDirectory() as d:
        with zipfile.ZipFile(saved("inception", d)) as z:
            return normalized_config(json.loads(z.read("config.json")))


def fixture_config() -> dict:
    with gzip.open(FIXTURE, "rt") as f:
        return json.load(f)


def perturbed(weights: dict, seed: int = 1) -> dict:
    """``weights`` ({variable path: array}) with BN moving statistics and
    shifts (and scales) moved away from 0 and 1, so that a BN fold is
    tested at a scale where errors show."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = {}
    for key, v in weights.items():
        var = key.rsplit("/", 1)[1]
        if var in ("moving_mean", "beta"):
            v = rng.normal(0, 0.1, v.shape)
        elif var in ("moving_variance", "gamma"):
            v = rng.uniform(0.5, 1.5, v.shape)
        out[key] = np.asarray(v, dtype=np.float32)
    return out


if __name__ == "__main__":
    FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    data = json.dumps(inception_config()).encode()
    FIXTURE.write_bytes(gzip.compress(data, mtime=0))
    print(f"wrote {FIXTURE} ({len(data)} bytes of JSON)", file=sys.stderr)
