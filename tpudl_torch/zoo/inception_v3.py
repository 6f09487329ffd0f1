"""InceptionV3 as a build function over a :class:`~tpudl_torch.zoo.core.Store`.

Port of ``tpudl/zoo/inception_v3.py`` (``build``, ``_conv2d_bn``,
``_mixed_7x7``): keras.applications' InceptionV3, layer creation order
included, so the canonical auto-names (``conv2d_N``,
``batch_normalization_N``) line up with tpudl's params and Keras's
weights. 299×299 input, 'tf' preprocessing, 2048-d features. Activations
are NCHW (``tpudl_torch.zoo.nn``); branches concatenate on the channel
axis in Keras's order. BN uses scale=False and eps 1e-3.

Not ported yet: tpudl's space-to-depth stem (``TPUDL_S2D_STEM``, off by
default there; ROADMAP Queue 1, 'Image path'). The port always runs the
canonical stem and reads no environment variable.
"""

from __future__ import annotations

import torch

from tpudl_torch.zoo import nn
from tpudl_torch.zoo.core import Store

NAME = "InceptionV3"
INPUT_SIZE = (299, 299)
FEATURE_DIM = 2048
PREPROCESS_MODE = "tf"


def _conv2d_bn(s: Store, x, filters, num_row, num_col, *, padding="SAME",
               strides=(1, 1)):
    x = s.conv(x, filters, (num_row, num_col), strides=strides,
               padding=padding, use_bias=False)
    x = s.bn(x, scale=False)
    return nn.relu(x)


def build(s: Store, x, *, include_top=True, pooling=None, classes=1000):
    x = _conv2d_bn(s, x, 32, 3, 3, strides=(2, 2), padding="VALID")
    x = _conv2d_bn(s, x, 32, 3, 3, padding="VALID")
    x = _conv2d_bn(s, x, 64, 3, 3)
    x = nn.max_pool(x, (3, 3), strides=(2, 2))

    x = _conv2d_bn(s, x, 80, 1, 1, padding="VALID")
    x = _conv2d_bn(s, x, 192, 3, 3, padding="VALID")
    x = nn.max_pool(x, (3, 3), strides=(2, 2))

    # mixed 0, 1, 2: 35 x 35
    for pool_filters in (32, 64, 64):
        branch1x1 = _conv2d_bn(s, x, 64, 1, 1)
        branch5x5 = _conv2d_bn(s, x, 48, 1, 1)
        branch5x5 = _conv2d_bn(s, branch5x5, 64, 5, 5)
        branch3x3dbl = _conv2d_bn(s, x, 64, 1, 1)
        branch3x3dbl = _conv2d_bn(s, branch3x3dbl, 96, 3, 3)
        branch3x3dbl = _conv2d_bn(s, branch3x3dbl, 96, 3, 3)
        branch_pool = nn.avg_pool(x, (3, 3), strides=(1, 1), padding="SAME")
        branch_pool = _conv2d_bn(s, branch_pool, pool_filters, 1, 1)
        x = torch.cat([branch1x1, branch5x5, branch3x3dbl, branch_pool],
                      dim=1)

    # mixed 3: 17 x 17
    branch3x3 = _conv2d_bn(s, x, 384, 3, 3, strides=(2, 2), padding="VALID")
    branch3x3dbl = _conv2d_bn(s, x, 64, 1, 1)
    branch3x3dbl = _conv2d_bn(s, branch3x3dbl, 96, 3, 3)
    branch3x3dbl = _conv2d_bn(s, branch3x3dbl, 96, 3, 3, strides=(2, 2),
                              padding="VALID")
    branch_pool = nn.max_pool(x, (3, 3), strides=(2, 2))
    x = torch.cat([branch3x3, branch3x3dbl, branch_pool], dim=1)

    # mixed 4: 17 x 17, 128-wide 7x7 factorized
    x = _mixed_7x7(s, x, 128)
    # mixed 5, 6: 160-wide
    for _ in range(2):
        x = _mixed_7x7(s, x, 160)
    # mixed 7: 192-wide
    x = _mixed_7x7(s, x, 192)

    # mixed 8: 8 x 8
    branch3x3 = _conv2d_bn(s, x, 192, 1, 1)
    branch3x3 = _conv2d_bn(s, branch3x3, 320, 3, 3, strides=(2, 2),
                           padding="VALID")
    branch7x7x3 = _conv2d_bn(s, x, 192, 1, 1)
    branch7x7x3 = _conv2d_bn(s, branch7x7x3, 192, 1, 7)
    branch7x7x3 = _conv2d_bn(s, branch7x7x3, 192, 7, 1)
    branch7x7x3 = _conv2d_bn(s, branch7x7x3, 192, 3, 3, strides=(2, 2),
                             padding="VALID")
    branch_pool = nn.max_pool(x, (3, 3), strides=(2, 2))
    x = torch.cat([branch3x3, branch7x7x3, branch_pool], dim=1)

    # mixed 9, 10: 8 x 8 x 2048
    for _ in range(2):
        branch1x1 = _conv2d_bn(s, x, 320, 1, 1)
        branch3x3 = _conv2d_bn(s, x, 384, 1, 1)
        branch3x3_1 = _conv2d_bn(s, branch3x3, 384, 1, 3)
        branch3x3_2 = _conv2d_bn(s, branch3x3, 384, 3, 1)
        branch3x3 = torch.cat([branch3x3_1, branch3x3_2], dim=1)
        branch3x3dbl = _conv2d_bn(s, x, 448, 1, 1)
        branch3x3dbl = _conv2d_bn(s, branch3x3dbl, 384, 3, 3)
        branch3x3dbl_1 = _conv2d_bn(s, branch3x3dbl, 384, 1, 3)
        branch3x3dbl_2 = _conv2d_bn(s, branch3x3dbl, 384, 3, 1)
        branch3x3dbl = torch.cat([branch3x3dbl_1, branch3x3dbl_2], dim=1)
        branch_pool = nn.avg_pool(x, (3, 3), strides=(1, 1), padding="SAME")
        branch_pool = _conv2d_bn(s, branch_pool, 192, 1, 1)
        x = torch.cat([branch1x1, branch3x3, branch3x3dbl, branch_pool],
                      dim=1)

    if include_top:
        x = nn.global_avg_pool(x)
        x = s.dense(x, classes, name="predictions")
        return nn.softmax(x)
    if pooling == "avg":
        return nn.global_avg_pool(x)
    if pooling == "max":
        return nn.global_max_pool(x)
    return x


def _mixed_7x7(s: Store, x, width):
    branch1x1 = _conv2d_bn(s, x, 192, 1, 1)
    branch7x7 = _conv2d_bn(s, x, width, 1, 1)
    branch7x7 = _conv2d_bn(s, branch7x7, width, 1, 7)
    branch7x7 = _conv2d_bn(s, branch7x7, 192, 7, 1)
    branch7x7dbl = _conv2d_bn(s, x, width, 1, 1)
    branch7x7dbl = _conv2d_bn(s, branch7x7dbl, width, 7, 1)
    branch7x7dbl = _conv2d_bn(s, branch7x7dbl, width, 1, 7)
    branch7x7dbl = _conv2d_bn(s, branch7x7dbl, width, 7, 1)
    branch7x7dbl = _conv2d_bn(s, branch7x7dbl, 192, 1, 7)
    branch_pool = nn.avg_pool(x, (3, 3), strides=(1, 1), padding="SAME")
    branch_pool = _conv2d_bn(s, branch_pool, 192, 1, 1)
    return torch.cat([branch1x1, branch7x7, branch7x7dbl, branch_pool], dim=1)
