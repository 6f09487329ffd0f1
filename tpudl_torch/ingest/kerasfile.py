"""Keras model files read and written without keras: ``.keras`` and the
legacy ``.h5`` of ``model.save("x.h5")``.

A Keras 3 ``.keras`` file is a zip (stored, not compressed) of
``metadata.json``, ``config.json`` (the layer graph) and
``model.weights.h5``. The weights sit at ``layers/<slot>/vars/<i>``:
``<slot>`` is the layer's class in snake case, numbered in the order of
``model.layers`` (``conv2d``, ``conv2d_1``, ...; a Sequential model's
input layer takes no slot), and ``<i>`` counts the layer's trainable
variables and then its non-trainable ones, in the order the layer made
them. A model nested as a layer of another keeps its own layers under
its slot: ``layers/<slot>/layers/<slot>/vars/<i>``.
:func:`load_keras_file` maps them to Keras's ``variable.path``
(``<layer name>/<variable name>``: ``conv2d/kernel``,
``batch_normalization/moving_mean``, ...; a nested model's layers too),
the keys tpudl's ``TFInputGraph.fromKerasTrainable`` gives its params;
:func:`save_keras_file` writes them back in Keras's own layout, so that
``keras.saving.load_model`` reads the file.

A legacy ``.h5`` model file holds the config in the root attribute
``model_config`` (Keras 3's legacy form: no ``module`` keys) and each
top-level layer's variables under ``model_weights/<layer>/``, listed by
the attribute ``weight_names`` (the variables' paths when the file was
written). Keras reads it back with other paths than a ``.keras`` file
gives: a layer whose model is a Sequential is keyed under that model's
name (``sequential/dense/kernel``), as keras's legacy loader builds it
and as tpudl keys its params. :func:`file_layout` tells the two apart,
and :func:`layer_keys` gives a layer's keys in either. The config comes
back in Keras 3's ``.keras`` form, so that a model read from ``.h5`` is
written as ``.keras`` (tpudl's estimator writes ``.keras`` whatever it
read). Keras 1- and 2-era ``.h5`` files (``kernel:0`` weight names,
list-form inbound nodes) are refused by name.

Counterparts in tpudl: ``tpudl/zoo/convert.py:load_keras_model`` (which
calls ``keras.saving.load_model``) and the ``model.save`` of
``tpudl/ml/estimator.py:_save_trained``.
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
           "layer_variables", "layer_keys", "variable_paths",
           "variable_shapes", "file_layout", "is_model"]

_CONFIG, _WEIGHTS, _METADATA = "config.json", "model.weights.h5", \
    "metadata.json"
_MODEL_CLASSES = ("Sequential", "Functional", "Model")
# the module and registered name of each class in Keras 3's .keras form
_MODULES = {"Sequential": ("keras", None),
            "Functional": ("keras.src.models.functional", "Functional")}


def _refuse(what: str):
    raise NotImplementedError(
        f"{what} is not ported to tpudl_torch yet (ROADMAP Queue 1, 'The "
        "rest of the sparkdl surface')")


# copied from keras/src/utils/naming.py:to_snake_case
def _snake_case(name: str) -> str:
    name = re.sub(r"\W+", "", name)
    name = re.sub("(.)([A-Z][a-z]+)", r"\1_\2", name)
    return re.sub("([a-z])([A-Z])", r"\1_\2", name).lower()


def is_model(layer: dict) -> bool:
    """Is this layer config a model (nested in another)?"""
    return layer["class_name"] in _MODEL_CLASSES


def model_layers(config: dict) -> list[dict]:
    """The layer configs of a Sequential or Functional model config, in
    the order of ``model.layers`` (a nested model is one of them)."""
    cls = config.get("class_name")
    if cls not in _MODEL_CLASSES:
        raise ValueError(f"config.json describes a {cls!r}, not a model")
    layers = list(config["config"]["layers"])
    if cls == "Sequential" and layers and \
            layers[0]["class_name"] == "InputLayer":
        layers = layers[1:]        # not in Sequential.layers
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


def layer_keys(layer: dict, parent: dict, layout: str = "keras") -> dict:
    """``{variable name: variable path}`` of ``layer`` in the model
    ``parent``, as keras keys a model read from a ``.keras`` file
    (``layout="keras"``: ``<layer>/<var>``) or from a legacy ``.h5``
    (``"h5"``: under the Sequential's name when ``parent`` is one)."""
    if layout not in ("keras", "h5"):
        raise ValueError(f"layout must be 'keras' or 'h5', got {layout!r}")
    prefix = ""
    if layout == "h5" and parent["class_name"] == "Sequential":
        prefix = parent["config"]["name"] + "/"
    name = layer["config"]["name"]
    return {v: f"{prefix}{name}/{v}" for v in layer_variables(layer)}


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


def _walk(config: dict, group: str = "layers"):
    """``(group, layer, parent)`` of every layer, nested models' layers
    after their model's own entry, in ``model.weights`` order."""
    for slot, layer in _slots(model_layers(config)):
        yield f"{group}/{slot}", layer, config
        if is_model(layer):
            yield from _walk(layer, f"{group}/{slot}/layers")


def variable_paths(config: dict, layout: str = "keras") -> list[tuple]:
    """``[(group, layer, variable name, path)]`` of every variable of the
    model, in ``model.weights`` order (``group`` is the layer's group in
    a ``.keras`` weights file). Two variables with one path are refused:
    keras would key them as one."""
    out, seen = [], set()
    for group, layer, parent in _walk(config):
        for var, path in layer_keys(layer, parent, layout).items():
            if path in seen:
                _refuse(f"two variables with the path {path!r} (layers of "
                        "nested models with the same names)")
            seen.add(path)
            out.append((group, layer, var, path))
    return out


def variable_shapes(config: dict) -> dict:
    """``{variable path: shape}`` of a model's variables from each layer's
    ``build_config``: what a seeded set of weights for the config needs."""
    shapes = {}
    for _group, layer, var, path in variable_paths(config):
        cls, c = layer["class_name"], layer["config"]
        cin = layer["build_config"]["input_shape"]
        if cls == "Dense":
            full = {"kernel": (cin[-1], c["units"]), "bias": (c["units"],)}
        elif cls == "Conv2D":
            kh, kw = c["kernel_size"]
            full = {"kernel": (kh, kw, cin[-1] // c.get("groups", 1),
                               c["filters"]), "bias": (c["filters"],)}
        elif cls in ("DepthwiseConv2D", "SeparableConv2D"):
            kh, kw = c["kernel_size"]
            mult = c.get("depth_multiplier", 1)
            full = {"kernel": (kh, kw, cin[-1], mult),
                    "depthwise_kernel": (kh, kw, cin[-1], mult),
                    "pointwise_kernel": (1, 1, cin[-1] * mult,
                                         c.get("filters")),
                    "bias": (c.get("filters") or cin[-1] * mult,)}
        elif cls == "BatchNormalization":
            axis = c["axis"][0] if isinstance(c["axis"], list) else c["axis"]
            full = {var: (cin[axis],)}
        elif cls == "Normalization":
            axes = c["axis"] if isinstance(c["axis"], list) else [c["axis"]]
            full = {"mean": tuple(cin[a] for a in axes), "count": ()}
            full["variance"] = full["mean"]
        else:
            raise NotImplementedError(
                f"variable shapes of a {cls} layer ({c['name']})")
        shapes[path] = tuple(full[var])
    return shapes


def file_layout(path) -> str:
    """``"h5"`` for a legacy HDF5 model file, else ``"keras"``."""
    with open(path, "rb") as f:
        return "h5" if f.read(8) == hdf5._SIGNATURE else "keras"


def load_keras_file(path) -> tuple[dict, dict]:
    """``(config, weights)`` of a ``.keras`` or legacy ``.h5`` model file:
    the model config in Keras 3's ``.keras`` form and an ordered
    ``{variable path: ndarray}`` in ``model.weights`` order, keyed as
    keras keys the model it reads from that file (:func:`layer_keys`)."""
    if file_layout(path) == "h5":
        return _load_h5(path)
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
    variable_paths(config)         # refuses two variables with one path
    weights = {}
    for group, layer, parent in _walk(config):
        var_keys = list(layer_keys(layer, parent).items())
        vars_ = f"{group}/vars"
        stored = root[vars_].members if vars_ in root else {}
        if len(stored) != len(var_keys):
            if not var_keys:
                _refuse(f"weights of a {layer['class_name']} layer")
            raise ValueError(
                f"{path}: {vars_} holds {len(stored)} variables, a "
                f"{layer['class_name']} with this config has "
                f"{len(var_keys)} ({[v for v, _k in var_keys]})")
        for i, (var, key) in enumerate(var_keys):
            ds = stored[str(i)]
            if ds.attrs.get("dtype") == "bfloat16":
                _refuse(f"{path}: bfloat16 weights ({key})")
            weights[key] = ds.value
    return config, weights


def _keras3_config(config: dict) -> dict:
    """A legacy ``.h5`` ``model_config`` in Keras 3's ``.keras`` form: each
    model and layer entry gains the ``module`` and ``registered_name``
    that keras's ``.keras`` loader looks its class up by."""
    out = dict(config)
    cls = out["class_name"]
    if "module" not in out:
        out["module"], out["registered_name"] = _MODULES.get(
            cls, ("keras.layers", None))
    if cls in _MODEL_CLASSES:
        out["config"] = dict(out["config"])
        out["config"]["layers"] = [_keras3_config(layer) for layer in
                                   out["config"]["layers"]]
    return out


def _strings(attrs: dict, name: str) -> list[str]:
    """A string-list attribute that keras's legacy writer may have split
    into ``<name>0``, ``<name>1``, ... (``load_attributes_from_hdf5_group``)."""
    if name in attrs:
        parts = [attrs[name]]
    else:
        parts, i = [], 0
        while f"{name}{i}" in attrs:
            parts.append(attrs[f"{name}{i}"])
            i += 1
    out = []
    for part in parts:
        for v in np.atleast_1d(np.asarray(part, dtype=object)):
            out.append(v.decode("utf-8") if isinstance(v, bytes) else str(v))
    return out


def _load_h5(path) -> tuple[dict, dict]:
    with open(path, "rb") as f:
        root = hdf5.read(f.read())
    if "model_config" not in root.attrs or "model_weights" not in root:
        raise ValueError(f"{path} is an HDF5 file without a model_config "
                         "and model_weights: not a Keras model file")
    version = str(root.attrs.get("keras_version", ""))
    if not version.startswith("3."):
        _refuse(f"{path}: a Keras {version or '1 or 2'}-era .h5 model file "
                "(written by keras_version " f"{version or 'unknown'})")
    config = _keras3_config(json.loads(root.attrs["model_config"]))
    saved = {}            # "<layer>/<var>" → array, by the saved paths
    groups = root["model_weights"]
    for lname, g in groups.members.items():
        for wname in _strings(g.attrs, "weight_names"):
            if ":" in wname:
                _refuse(f"{path}: Keras 2-era weight names ({wname!r})")
            if lname == "top_level_model_weights":
                _refuse(f"{path}: top-level model weights ({wname!r})")
            suffix = "/".join(wname.split("/")[-2:])
            if suffix in saved:
                _refuse(f"{path}: two variables saved as {suffix!r}")
            saved[suffix] = g[wname].value
    weights = {}
    for _group, layer, var, key in variable_paths(config, "h5"):
        suffix = f"{layer['config']['name']}/{var}"
        if suffix not in saved:
            raise ValueError(f"{path}: no saved variable for {key!r}")
        weights[key] = saved.pop(suffix)
    if saved:
        raise ValueError(f"{path}: saved variables {sorted(saved)[:4]} "
                         "belong to no layer of its model_config")
    return config, weights


def _weight_groups(config, weights, layout, missing, unused):
    """The ``layers`` group of ``config``'s model in a ``.keras`` weights
    file; nested models recurse."""
    layers = hdf5.Group()
    for slot, layer in _slots(model_layers(config)):
        vars_ = hdf5.Group(attrs={"name": layer["config"]["name"]})
        keys = layer_keys(layer, config, layout)
        for i, key in enumerate(keys.values()):
            if key not in weights:
                missing.append(key)
                continue
            unused.discard(key)
            vars_.members[str(i)] = hdf5.Dataset(np.asarray(weights[key]))
        members = {"vars": vars_}
        if is_model(layer):
            members["layers"] = _weight_groups(layer, weights, layout,
                                               missing, unused)
        layers.members[slot] = hdf5.Group(members)
    return layers


def save_keras_file(path, config: dict, weights: dict,
                    layout: str = "keras") -> str:
    """Write ``config`` (Keras 3's ``.keras`` form) and ``weights``
    ({variable path: array}, every variable of every layer, keyed as
    :func:`layer_keys` keys ``layout``) as a ``.keras`` file in Keras 3's
    layout."""
    missing, unused = [], set(weights)
    layers = _weight_groups(config, weights, layout, missing, unused)
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
