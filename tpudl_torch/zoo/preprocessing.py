"""ImageNet preprocessing and decode.

Port of ``tpudl/zoo/preprocessing.py``. ``preprocess_input`` takes a
float tensor ``(..., H, W, 3)``, RGB, values in [0, 255], as tpudl's does:

- ``tf``    : x/127.5 - 1                       (InceptionV3, Xception)
- ``caffe`` : RGB→BGR, subtract ImageNet means  (ResNet, VGG)
- ``torch`` : x/255 then per-channel mean/std   (DenseNet121)
- ``raw``   : identity (EfficientNetB0 normalizes inside the model)

``decode_predictions`` and the class-index lookup are host-only and
copied from tpudl.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

__all__ = ["preprocess_input", "decode_predictions", "CAFFE_MEANS_BGR"]

CAFFE_MEANS_BGR = (103.939, 116.779, 123.68)
_TORCH_MEAN = (0.485, 0.456, 0.406)
_TORCH_STD = (0.229, 0.224, 0.225)


def _channel_const(values, x):
    """``values`` as a tensor of ``x``'s dtype on its device, made by fill
    kernels rather than a host copy, so that a CUDA-graph capture of the
    model (the executor's fused dispatch) can record it."""
    return torch.stack([x.new_full((), v) for v in values])


def preprocess_input(x, mode: str = "caffe"):
    """x: (..., H, W, 3) float, RGB, values in [0, 255]."""
    if mode == "raw":
        return x
    if mode == "tf":
        return x / 127.5 - 1.0
    if mode == "caffe":
        return x.flip(-1) - _channel_const(CAFFE_MEANS_BGR, x)
    if mode == "torch":
        x = x / 255.0
        return (x - _channel_const(_TORCH_MEAN, x)) / _channel_const(
            _TORCH_STD, x)
    raise ValueError(f"unknown preprocess mode {mode!r}")


_CLASS_INDEX = None


# copied from tpudl/zoo/preprocessing.py:_load_class_index
def _load_class_index():
    """ImageNet class index: {str(idx): [wnid, label]}, from
    $TPUDL_IMAGENET_CLASS_INDEX or the keras cache
    (~/.keras/models/imagenet_class_index.json); with neither, an empty
    index (labels fall back to ``class_<idx>``)."""
    global _CLASS_INDEX
    if _CLASS_INDEX is not None:
        return _CLASS_INDEX
    candidates = [
        os.environ.get("TPUDL_IMAGENET_CLASS_INDEX", ""),
        os.path.expanduser("~/.keras/models/imagenet_class_index.json"),
    ]
    for path in candidates:
        if path and os.path.exists(path):
            with open(path) as f:
                _CLASS_INDEX = json.load(f)
            return _CLASS_INDEX
    _CLASS_INDEX = {}
    return _CLASS_INDEX


# copied from tpudl/zoo/preprocessing.py:decode_predictions
def decode_predictions(preds, top: int = 5):
    """(B, 1000) scores → per-row list of (wnid, label, score) topK, as
    keras.applications.imagenet_utils.decode_predictions; without a
    class-index file, wnid and label are ``class_<idx>``."""
    preds = np.asarray(preds)
    if preds.ndim != 2 or preds.shape[1] != 1000:
        raise ValueError(
            f"decode_predictions expects (batch, 1000) scores, got {preds.shape}"
        )
    index = _load_class_index()
    results = []
    for row in preds:
        top_idx = row.argsort()[-top:][::-1]
        entries = []
        for i in top_idx:
            if str(i) in index:
                wnid, label = index[str(i)]
            else:
                wnid, label = f"class_{i}", f"class_{i}"
            entries.append((wnid, label, float(row[i])))
        results.append(entries)
    return results
