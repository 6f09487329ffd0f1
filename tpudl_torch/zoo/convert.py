"""Param artifacts and the carry of tpudl's weights into the port.

Port of ``tpudl/zoo/convert.py`` (``save_params_npz``,
``load_params_npz``: pickle-free ``layer/param`` archives, the legacy
pickled layout refused unless the caller vouches for the file;
``load_keras_model`` and ``params_from_keras``, which read a ``.keras``
or legacy ``.h5`` model file without keras, through
:mod:`tpudl_torch.ingest.kerasfile`), plus
:func:`torch_params`, which turns tpudl's param pytree (numpy, Keras
names and HWIO layout) into the port's tree of torch tensors — the same
weights, so both packages compute the same model — and its inverse
:func:`keras_params`, which returns a (trained) model's weights as
tpudl's numpy tree.

Not ported yet: ``save_named_params``, which builds a keras application
with its imagenet weights (ROADMAP Queue 1, 'The rest of the sparkdl
surface').
"""

from __future__ import annotations

import re

import numpy as np
import torch

__all__ = ["torch_layout", "torch_params", "keras_layout", "keras_params",
           "save_params_npz", "load_params_npz", "params_from_keras",
           "load_keras_model", "save_named_params"]


def torch_layout(key: str, value) -> torch.Tensor:
    """One param leaf from Keras's layout to the port's: a 4-D ``kernel``
    or ``pointwise_kernel`` HWIO → OIHW; a ``depthwise_kernel``
    ``(kh, kw, cin, mult)`` → ``(cin * mult, 1, kh, kw)`` (channel
    ``c * mult + m``); everything else as it is."""
    t = torch.as_tensor(np.asarray(value))
    if key == "depthwise_kernel":
        kh, kw, cin, mult = t.shape
        return t.reshape(kh, kw, cin * mult).permute(2, 0, 1).unsqueeze(1)
    if t.ndim == 4:
        return t.permute(3, 2, 0, 1)
    return t


def _dense_copy(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy that owns its memory (a model trained in place
    must not write through to the caller's numpy arrays); 4-D kernels in
    channels_last, the format cuDNN runs NCHW-channels_last convolutions
    in (a kernel in another format would be converted on every call)."""
    if t.ndim == 4:
        return t.clone(memory_format=torch.channels_last)
    return t.clone(memory_format=torch.contiguous_format)


def torch_params(params: dict) -> dict:
    """tpudl's param pytree (numpy, Keras layout and names) → the port's
    ``{layer: {name: tensor}}`` on the CPU."""
    return {layer: {k: _dense_copy(torch_layout(k, v))
                    for k, v in leaves.items()}
            for layer, leaves in params.items()}


def keras_layout(key: str, t: torch.Tensor) -> np.ndarray:
    """The inverse of :func:`torch_layout` for the zoo's layers (depth
    multiplier 1): one tensor in the port's layout → a numpy array in
    Keras's (OIHW → HWIO; ``(cin, 1, kh, kw)`` → ``(kh, kw, cin, 1)``)."""
    t = t.detach()
    if key == "depthwise_kernel":
        t = t.permute(2, 3, 0, 1)
    elif t.ndim == 4:
        t = t.permute(2, 3, 1, 0)
    return t.cpu().contiguous().numpy().copy()


def keras_params(tree: dict) -> dict:
    """The port's ``{layer: {name: tensor}}`` (for example
    ``ImageModel.tree()``) → tpudl's param pytree of numpy arrays, Keras
    layout and names: the inverse of :func:`torch_params`."""
    return {layer: {k: keras_layout(k, t) for k, t in leaves.items()}
            for layer, leaves in tree.items()}


# copied from tpudl/zoo/convert.py:save_params_npz
def save_params_npz(params: dict, path: str) -> str:
    """Save a param pytree as a flat, pickle-free .npz artifact
    (``layer/param`` keys)."""
    flat = {}
    for layer, d in params.items():
        for k, v in d.items():
            flat[f"{layer}/{k}"] = np.asarray(v)
    np.savez(path, **flat)
    return path


# copied from tpudl/zoo/convert.py:load_params_npz
def load_params_npz(path: str, allow_legacy_pickle: bool = False) -> dict:
    """Load a .npz param artifact (flat ``layer/param`` layout; the legacy
    single pickled-dict layout only with ``allow_legacy_pickle=True``,
    because loading it runs pickle opcodes)."""
    with np.load(path, allow_pickle=False) as z:
        files = z.files
        if files != ["params"]:
            params: dict[str, dict] = {}
            for key in files:
                layer, _, pname = key.rpartition("/")
                if not layer:
                    raise ValueError(
                        f"{path}: unrecognized npz key {key!r} (expected "
                        "'layer/param' entries)")
                params.setdefault(layer, {})[pname] = z[key]
            return params
    if not allow_legacy_pickle:
        raise ValueError(
            f"{path} uses the legacy pickled single-'params' layout, which "
            "requires executing pickle opcodes to load; re-save it with "
            "save_params_npz, or pass allow_legacy_pickle=True only for a "
            "trusted file")
    with np.load(path, allow_pickle=True) as z:  # legacy pickled layout
        return z["params"].item()


def load_keras_model(path):
    """A ``.keras`` or legacy ``.h5`` model file → ``(config, weights)``
    (:func:`~tpudl_torch.ingest.kerasfile.load_keras_file`); a live keras
    model is refused: save it to ``.keras`` and pass the path."""
    from tpudl_torch.ingest.input import keras_model_path
    from tpudl_torch.ingest.kerasfile import load_keras_file

    return load_keras_file(keras_model_path(path))


# copied from tpudl/zoo/convert.py:_BASE_NAMES
_BASE_NAMES = {
    "Conv2D": "conv2d",
    "SeparableConv2D": "separable_conv2d",
    "DepthwiseConv2D": "depthwise_conv2d",
    "BatchNormalization": "batch_normalization",
    "Normalization": "normalization",
    "Dense": "dense",
}


def _canonical_names(layers, weighted) -> dict[str, str]:
    """tpudl's ``_canonical_names`` over layer configs: each weighted
    layer's name → the name a fresh process gives it (auto-named layers
    renumbered by suffix per base type; explicit names kept)."""
    from tpudl_torch.zoo.core import Namer

    auto: dict[str, list[tuple[int, str]]] = {}
    mapping: dict[str, str] = {}
    for layer in layers:
        cls, name = layer["class_name"], layer["config"]["name"]
        if cls not in _BASE_NAMES or name not in weighted:
            continue
        base = _BASE_NAMES[cls]
        m = re.fullmatch(rf"{base}(?:_(\d+))?", name)
        if m:
            auto.setdefault(base, []).append((int(m.group(1) or 0), name))
        else:
            mapping[name] = name
    namer = Namer()
    for base, entries in auto.items():
        for _suffix, runtime_name in sorted(entries):
            mapping[runtime_name] = namer(base)
    return mapping


def params_from_keras(path) -> dict:
    """A ``.keras`` or legacy ``.h5`` model file → tpudl's param pytree of
    the zoo, keyed by canonical layer names, as
    ``tpudl.zoo.convert.params_from_keras`` gives it for the loaded model:
    the model's own layers (a nested model's are not), ``moving_variance``
    → ``moving_var``, a per-channel ``Rescaling`` after ``Normalization``
    folded into its variance."""
    from tpudl_torch.ingest.input import keras_model_path
    from tpudl_torch.ingest.kerasfile import (file_layout, layer_keys,
                                              model_layers)

    config, weights = load_keras_model(path)
    layout = file_layout(keras_model_path(path))
    layers = model_layers(config)
    keys = {layer["config"]["name"]: layer_keys(layer, config, layout)
            for layer in layers}
    weighted = {name for name, k in keys.items() if k}
    names = _canonical_names(layers, weighted)
    params: dict[str, dict] = {}
    last_norm = None
    for layer in layers:
        cls, c = layer["class_name"], layer["config"]
        if cls == "Rescaling":
            scale = np.asarray(c.get("scale", 1.0), dtype=np.float64)
            offset = np.asarray(c.get("offset", 0.0))
            if last_norm is not None and scale.ndim > 0 and \
                    not np.any(offset):
                var = params[last_norm]["variance"]
                params[last_norm]["variance"] = (
                    var / np.square(scale)).astype(var.dtype)
            last_norm = None
            continue
        if cls not in _BASE_NAMES or c["name"] not in weighted:
            if cls != "InputLayer":
                last_norm = None
            continue
        name = names[c["name"]]
        if cls != "Normalization":
            last_norm = None
        w = {var: weights[key] for var, key in keys[c["name"]].items()}
        if cls == "DepthwiseConv2D":
            p = {"depthwise_kernel": w["kernel"]}
            if "bias" in w:
                p["bias"] = w["bias"]
        elif cls == "BatchNormalization":
            p = {"moving_mean": w["moving_mean"],
                 "moving_var": w["moving_variance"]}
            p.update({k: w[k] for k in ("beta", "gamma") if k in w})
        elif cls == "Normalization":
            p = {"mean": w["mean"], "variance": w["variance"]}
            last_norm = name
        else:
            p = {k: w[k] for k in ("kernel", "depthwise_kernel",
                                   "pointwise_kernel", "bias") if k in w}
        params[name] = p
    return params


def save_named_params(name: str, path: str, weights: str = "imagenet"):
    raise NotImplementedError(
        "save_named_params builds a keras application with its imagenet "
        "weights and is not ported to tpudl_torch (ROADMAP Queue 1, 'The "
        "rest of the sparkdl surface'); run tpudl's on a host with keras")
