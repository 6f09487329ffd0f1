"""Xception as a build function over a :class:`~tpudl_torch.zoo.core.Store`.

Port of ``tpudl/zoo/xception.py`` (``build``): keras.applications'
Xception. The sepconvs and their BNs carry Keras's stable names; the four
residual-projection convs and their BNs are unnamed in Keras, so they take
the auto names (``conv2d``, ``conv2d_1``, ..., ``batch_normalization``,
``batch_normalization_1``, ...) in Keras's creation order: each projection
is built before the block's sepconvs. 299×299 input, 'tf' preprocessing,
2048-d features. Max pools are SAME (``-inf`` pads, ``nn.max_pool``).
"""

from __future__ import annotations

from tpudl_torch.zoo import nn
from tpudl_torch.zoo.core import Store

NAME = "Xception"
INPUT_SIZE = (299, 299)
FEATURE_DIM = 2048
PREPROCESS_MODE = "tf"


def _sepconv_bn(s: Store, x, filters, name):
    x = s.sep_conv(x, filters, 3, padding="SAME", use_bias=False, name=name)
    return s.bn(x, name=f"{name}_bn")


def _projection(s: Store, x, filters):
    x = s.conv(x, filters, 1, strides=(2, 2), padding="SAME", use_bias=False)
    return s.bn(x)


def build(s: Store, x, *, include_top=True, pooling=None, classes=1000):
    x = s.conv(x, 32, 3, strides=(2, 2), padding="VALID", use_bias=False,
               name="block1_conv1")
    x = nn.relu(s.bn(x, name="block1_conv1_bn"))
    x = s.conv(x, 64, 3, padding="VALID", use_bias=False, name="block1_conv2")
    x = nn.relu(s.bn(x, name="block1_conv2_bn"))

    # entry flow: blocks 2-4
    for i, filters in enumerate((128, 256, 728)):
        residual = _projection(s, x, filters)
        block = f"block{i + 2}"
        if i > 0:
            x = nn.relu(x)
        x = nn.relu(_sepconv_bn(s, x, filters, f"{block}_sepconv1"))
        x = _sepconv_bn(s, x, filters, f"{block}_sepconv2")
        x = nn.max_pool(x, (3, 3), strides=(2, 2), padding="SAME")
        x = x + residual

    # middle flow: blocks 5-12
    for i in range(8):
        block = f"block{i + 5}"
        residual = x
        for j in range(1, 4):
            x = _sepconv_bn(s, nn.relu(x), 728, f"{block}_sepconv{j}")
        x = x + residual

    # exit flow: blocks 13-14
    residual = _projection(s, x, 1024)
    x = _sepconv_bn(s, nn.relu(x), 728, "block13_sepconv1")
    x = _sepconv_bn(s, nn.relu(x), 1024, "block13_sepconv2")
    x = nn.max_pool(x, (3, 3), strides=(2, 2), padding="SAME")
    x = x + residual

    x = nn.relu(_sepconv_bn(s, x, 1536, "block14_sepconv1"))
    x = nn.relu(_sepconv_bn(s, x, 2048, "block14_sepconv2"))

    if include_top:
        x = nn.global_avg_pool(x)
        x = s.dense(x, classes, name="predictions")
        return nn.softmax(x)
    if pooling == "avg":
        return nn.global_avg_pool(x)
    if pooling == "max":
        return nn.global_max_pool(x)
    return x
