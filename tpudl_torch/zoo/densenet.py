"""DenseNet121 as a build function over a
:class:`~tpudl_torch.zoo.core.Store`.

Port of ``tpudl/zoo/densenet.py`` (``build``, ``_conv_block``,
``_transition_block``): keras.applications' DenseNet121 with its layer
names — dense blocks of BN, ReLU, 1×1 conv, BN, ReLU, 3×3 conv, each
concatenated onto its input on the channel axis (axis 1 here, -1 in
tpudl's NHWC), and transitions that halve the channels and average-pool
2×2. BN eps 1.001e-5. 224×224 input, 'torch' preprocessing, 1024-d
features.
"""

from __future__ import annotations

import torch

from tpudl_torch.zoo import nn
from tpudl_torch.zoo.core import Store

NAME = "DenseNet121"
INPUT_SIZE = (224, 224)
FEATURE_DIM = 1024
PREPROCESS_MODE = "torch"

_BLOCKS = (6, 12, 24, 16)
_GROWTH = 32
_EPS = 1.001e-5


def _conv_block(s: Store, x, name):
    x1 = nn.relu(s.bn(x, epsilon=_EPS, name=f"{name}_0_bn"))
    x1 = s.conv(x1, 4 * _GROWTH, 1, use_bias=False, name=f"{name}_1_conv")
    x1 = nn.relu(s.bn(x1, epsilon=_EPS, name=f"{name}_1_bn"))
    x1 = s.conv(x1, _GROWTH, 3, padding="SAME", use_bias=False,
                name=f"{name}_2_conv")
    return torch.cat([x, x1], dim=1)


def _transition_block(s: Store, x, name):
    x = nn.relu(s.bn(x, epsilon=_EPS, name=f"{name}_bn"))
    x = s.conv(x, int(x.shape[1] * 0.5), 1, use_bias=False,
               name=f"{name}_conv")
    return nn.avg_pool(x, (2, 2), strides=(2, 2), padding="VALID")


def build(s: Store, x, *, include_top=True, pooling=None, classes=1000):
    x = nn.zero_pad(x, ((3, 3), (3, 3)))
    x = s.conv(x, 64, 7, strides=(2, 2), padding="VALID", use_bias=False,
               name="conv1_conv")
    x = nn.relu(s.bn(x, epsilon=_EPS, name="conv1_bn"))
    x = nn.zero_pad(x, ((1, 1), (1, 1)))
    x = nn.max_pool(x, (3, 3), strides=(2, 2))

    for i, blocks in enumerate(_BLOCKS):
        for b in range(blocks):
            x = _conv_block(s, x, name=f"conv{i + 2}_block{b + 1}")
        if i < len(_BLOCKS) - 1:
            x = _transition_block(s, x, name=f"pool{i + 2}")

    x = nn.relu(s.bn(x, epsilon=_EPS, name="bn"))

    if include_top:
        x = nn.global_avg_pool(x)
        x = s.dense(x, classes, name="predictions")
        return nn.softmax(x)
    if pooling == "avg":
        return nn.global_avg_pool(x)
    if pooling == "max":
        return nn.global_max_pool(x)
    return x
