"""Param artifacts and the carry of tpudl's weights into the port.

Port of ``tpudl/zoo/convert.py`` (``save_params_npz``,
``load_params_npz``: pickle-free ``layer/param`` archives, the legacy
pickled layout refused unless the caller vouches for the file), plus
:func:`torch_params`, which turns tpudl's param pytree (numpy, Keras
names and HWIO layout) into the port's tree of torch tensors — the same
weights, so both packages compute the same model.

Not ported yet: ``params_from_keras``, ``load_keras_model`` and
``save_named_params``, which need keras (ROADMAP Queue 1, 'The rest of
the sparkdl surface', ingest).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["torch_layout", "torch_params", "save_params_npz",
           "load_params_npz", "params_from_keras", "load_keras_model"]


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
    """A contiguous copy; 4-D kernels in channels_last, the format cuDNN
    runs NCHW-channels_last convolutions in (a kernel in another format
    would be converted on every call)."""
    if t.ndim == 4:
        return t.contiguous(memory_format=torch.channels_last)
    return t.contiguous()


def torch_params(params: dict) -> dict:
    """tpudl's param pytree (numpy, Keras layout and names) → the port's
    ``{layer: {name: tensor}}`` on the CPU."""
    return {layer: {k: _dense_copy(torch_layout(k, v))
                    for k, v in leaves.items()}
            for layer, leaves in params.items()}


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


def _keras_not_ported(what):
    raise NotImplementedError(
        f"{what} needs keras and is not ported to tpudl_torch yet (ROADMAP "
        "Queue 1, 'The rest of the sparkdl surface'); convert with tpudl "
        "and pass the .npz (save_params_npz)")


def params_from_keras(model):
    _keras_not_ported("params_from_keras")


def load_keras_model(path_or_model):
    _keras_not_ported("load_keras_model")
