"""VGG16 and VGG19 as build functions over a
:class:`~tpudl_torch.zoo.core.Store`.

Port of ``tpudl/zoo/vgg.py`` (``build_vgg16``, ``build_vgg19``):
keras.applications' VGG — 3×3 SAME convs with bias and ReLU, 2×2 max
pools, then ``fc1`` and ``fc2`` of 4096. 224×224 input, 'caffe'
preprocessing. ``include_top="features"`` is the DeepImageFeaturizer cut,
the post-ReLU ``fc2`` (4096-d). The head flattens the last map in Keras's
NHWC order (:func:`~tpudl_torch.zoo.nn.flatten_nhwc`), which is the order
``fc1``'s weights expect.
"""

from __future__ import annotations

from tpudl_torch.zoo import nn
from tpudl_torch.zoo.core import Store

INPUT_SIZE = (224, 224)
FEATURE_DIM = 4096
PREPROCESS_MODE = "caffe"

_VGG16_BLOCKS = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]
_VGG19_BLOCKS = [(64, 2), (128, 2), (256, 4), (512, 4), (512, 4)]


def _build(s: Store, x, blocks, *, include_top, pooling=None, classes=1000):
    for b, (filters, convs) in enumerate(blocks, start=1):
        for c in range(1, convs + 1):
            x = nn.relu(s.conv(x, filters, 3, padding="SAME",
                               name=f"block{b}_conv{c}"))
        x = nn.max_pool(x, (2, 2), strides=(2, 2))
    if include_top:
        x = nn.flatten_nhwc(x)
        x = nn.relu(s.dense(x, 4096, name="fc1"))
        x = nn.relu(s.dense(x, 4096, name="fc2"))
        if include_top == "features":
            return x
        x = s.dense(x, classes, name="predictions")
        return nn.softmax(x)
    if pooling == "avg":
        return nn.global_avg_pool(x)
    if pooling == "max":
        return nn.global_max_pool(x)
    return x


def build_vgg16(s: Store, x, *, include_top=True, pooling=None, classes=1000):
    return _build(s, x, _VGG16_BLOCKS, include_top=include_top,
                  pooling=pooling, classes=classes)


def build_vgg19(s: Store, x, *, include_top=True, pooling=None, classes=1000):
    return _build(s, x, _VGG19_BLOCKS, include_top=include_top,
                  pooling=pooling, classes=classes)
