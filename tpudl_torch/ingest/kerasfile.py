"""``.keras`` model files read and written without keras.

A Keras 3 ``.keras`` file is a zip (stored, not compressed) of
``metadata.json``, ``config.json`` (the layer graph) and
``model.weights.h5``. The weights sit at ``layers/<slot>/vars/<i>``:
``<slot>`` is the layer's class in snake case, numbered in the order of
``model.layers`` (``conv2d``, ``conv2d_1``, ...; a Sequential model's
input layer takes no slot), and ``<i>`` counts the layer's trainable
variables and then its non-trainable ones, in the order the layer made
them. :func:`load_keras_file` maps them to Keras's ``variable.path``
(``<layer name>/<variable name>``: ``conv2d/kernel``,
``batch_normalization/moving_mean``, ...), the keys tpudl's
``TFInputGraph.fromKerasTrainable`` gives its params;
:func:`save_keras_file` writes them back in Keras's own layout, so that
``keras.saving.load_model`` reads the file.

Counterparts in tpudl: ``tpudl/zoo/convert.py:load_keras_model`` (which
calls ``keras.saving.load_model``) and the ``model.save`` of
``tpudl/ml/estimator.py:_save_trained``. A legacy ``.h5`` model file
(``model.save("x.h5")``) is refused by name (ROADMAP Queue 1, 'The rest
of the sparkdl surface').
"""

from __future__ import annotations

import datetime
import io
import json
import re
import zipfile

import numpy as np

from tpudl_torch.ingest import hdf5

__all__ = ["load_keras_file", "save_keras_file", "model_layers",
           "layer_variables", "variable_shapes"]

_CONFIG, _WEIGHTS, _METADATA = "config.json", "model.weights.h5", \
    "metadata.json"
_MODEL_CLASSES = ("Sequential", "Functional", "Model")


def _refuse(what: str):
    raise NotImplementedError(
        f"{what} is not ported to tpudl_torch yet (ROADMAP Queue 1, 'The "
        "rest of the sparkdl surface')")


# copied from keras/src/utils/naming.py:to_snake_case
def _snake_case(name: str) -> str:
    name = re.sub(r"\W+", "", name)
    name = re.sub("(.)([A-Z][a-z]+)", r"\1_\2", name)
    return re.sub("([a-z])([A-Z])", r"\1_\2", name).lower()


def model_layers(config: dict) -> list[dict]:
    """The layer configs of a Sequential or Functional model config, in
    the order of ``model.layers``."""
    cls = config.get("class_name")
    if cls not in _MODEL_CLASSES:
        raise ValueError(f"config.json describes a {cls!r}, not a model")
    layers = list(config["config"]["layers"])
    if cls == "Sequential" and layers and \
            layers[0]["class_name"] == "InputLayer":
        layers = layers[1:]        # not in Sequential.layers
    for layer in layers:
        if layer["class_name"] in _MODEL_CLASSES:
            _refuse(f"a nested model ({layer['config'].get('name')!r})")
    return layers


def layer_variables(layer: dict) -> list[str]:
    """A layer's variable names in Keras's save order (trainable first,
    then non-trainable, each in the order the layer builds them)."""
    cls, c = layer["class_name"], layer["config"]
    bias = ["bias"] if c.get("use_bias", True) else []
    if cls in ("Dense", "Conv2D", "DepthwiseConv2D"):
        return ["kernel"] + bias
    if cls == "SeparableConv2D":
        return ["depthwise_kernel", "pointwise_kernel"] + bias
    if cls == "BatchNormalization":
        return ((["gamma"] if c.get("scale", True) else [])
                + (["beta"] if c.get("center", True) else [])
                + ["moving_mean", "moving_variance"])
    if cls == "Normalization" and c.get("mean") is None:
        return ["mean", "variance", "count"]
    return []


def variable_shapes(config: dict) -> dict:
    """``{variable path: shape}`` of a model of Dense, Conv2D and
    BatchNormalization layers (and weightless ones), from each layer's
    ``build_config``: what a seeded set of weights for the config needs."""
    shapes = {}
    for layer in model_layers(config):
        names = layer_variables(layer)
        if not names:
            continue
        cls, c = layer["class_name"], layer["config"]
        cin = layer["build_config"]["input_shape"]
        if cls == "Dense":
            full = {"kernel": (cin[-1], c["units"]), "bias": (c["units"],)}
        elif cls == "Conv2D":
            kh, kw = c["kernel_size"]
            full = {"kernel": (kh, kw, cin[-1], c["filters"]),
                    "bias": (c["filters"],)}
        elif cls == "BatchNormalization":
            axis = c["axis"][0] if isinstance(c["axis"], list) else c["axis"]
            full = dict.fromkeys(names, (cin[axis],))
        else:
            raise NotImplementedError(
                f"variable shapes of a {cls} layer ({c['name']})")
        shapes.update({f"{c['name']}/{n}": tuple(full[n]) for n in names})
    return shapes


def _slots(layers):
    used: dict[str, int] = {}
    for layer in layers:
        name = _snake_case(layer["class_name"])
        if name in used:
            used[name] += 1
            name = f"{name}_{used[name]}"
        else:
            used[name] = 0
        yield name, layer


def load_keras_file(path) -> tuple[dict, dict]:
    """``(config, weights)`` of a ``.keras`` file: the parsed
    ``config.json`` and an ordered ``{variable path: ndarray}`` in
    ``model.weights`` order."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head == hdf5._SIGNATURE:
        _refuse(f"{path}: a legacy .h5 model file (model.save('x.h5'))")
    if not zipfile.is_zipfile(path):
        raise ValueError(f"{path} is not a .keras file (not a zip)")
    with zipfile.ZipFile(path) as z:
        names = set(z.namelist())
        if _WEIGHTS not in names:
            if "model.weights.json" in names:
                _refuse(f"{path}: sharded Keras weights")
            raise ValueError(f"{path} holds no {_WEIGHTS}")
        config = json.loads(z.read(_CONFIG))
        root = hdf5.read(z.read(_WEIGHTS))
    weights = {}
    for slot, layer in _slots(model_layers(config)):
        var_names = layer_variables(layer)
        group = f"layers/{slot}/vars"
        stored = root[group].members if group in root else {}
        if len(stored) != len(var_names):
            if not var_names:
                _refuse(f"weights of a {layer['class_name']} layer")
            raise ValueError(
                f"{path}: {group} holds {len(stored)} variables, a "
                f"{layer['class_name']} with this config has "
                f"{len(var_names)} ({var_names})")
        lname = layer["config"]["name"]
        for i, var in enumerate(var_names):
            ds = stored[str(i)]
            if ds.attrs.get("dtype") == "bfloat16":
                _refuse(f"{path}: bfloat16 weights ({lname}/{var})")
            weights[f"{lname}/{var}"] = ds.value
    return config, weights


def save_keras_file(path, config: dict, weights: dict) -> str:
    """Write ``config`` and ``weights`` ({variable path: array}, every
    variable of every layer) as a ``.keras`` file in Keras 3's layout."""
    layers = hdf5.Group()
    missing, unused = [], set(weights)
    for slot, layer in _slots(model_layers(config)):
        lname = layer["config"]["name"]
        vars_ = hdf5.Group(attrs={"name": lname})
        for i, var in enumerate(layer_variables(layer)):
            key = f"{lname}/{var}"
            if key not in weights:
                missing.append(key)
                continue
            unused.discard(key)
            vars_.members[str(i)] = hdf5.Dataset(np.asarray(weights[key]))
        layers.members[slot] = hdf5.Group({"vars": vars_})
    if missing or unused:
        raise KeyError(f"weights lack {missing[:4]} ({len(missing)} in "
                       f"all) and have no layer for {sorted(unused)[:4]}")
    root = hdf5.Group({
        "layers": layers,
        "vars": hdf5.Group(attrs={"name": config["config"]["name"]})})
    metadata = {"keras_version": "3",
                "date_saved": datetime.datetime.now().strftime(
                    "%Y-%m-%d@%H:%M:%S")}
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED) as z:
        z.writestr(_METADATA, json.dumps(metadata))
        z.writestr(_CONFIG, json.dumps(config))
        z.writestr(_WEIGHTS, hdf5.write(root))
    with open(path, "wb") as f:
        f.write(buf.getvalue())
    return str(path)
