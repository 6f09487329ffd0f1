"""MobileNetV2 (alpha 1.0) as a build function over a
:class:`~tpudl_torch.zoo.core.Store`.

Port of ``tpudl/zoo/mobilenet_v2.py`` (``build``, ``_correct_pad``,
``_inverted_res_block``): keras.applications' MobileNetV2 with its layer
names — inverted residual blocks (1×1 expand, 3×3 depthwise, 1×1 linear
project), ReLU6, BN momentum 0.999 and eps 1e-3; stride-2 blocks pad with
``correct_pad`` and run a VALID depthwise conv. 224×224 input, 'tf'
preprocessing, 1280-d features. tpudl reads channels off an NHWC array;
here they come off the NCHW one (``x.shape[1]``).
"""

from __future__ import annotations

from tpudl_torch.zoo import nn
from tpudl_torch.zoo.core import Store

NAME = "MobileNetV2"
INPUT_SIZE = (224, 224)
FEATURE_DIM = 1280
PREPROCESS_MODE = "tf"

# (filters, stride, expansion) per inverted-residual block, ids 0..16
_BLOCKS = [
    (16, 1, 1),
    (24, 2, 6), (24, 1, 6),
    (32, 2, 6), (32, 1, 6), (32, 1, 6),
    (64, 2, 6), (64, 1, 6), (64, 1, 6), (64, 1, 6),
    (96, 1, 6), (96, 1, 6), (96, 1, 6),
    (160, 2, 6), (160, 1, 6), (160, 1, 6),
    (320, 1, 6),
]


def _inverted_res_block(s: Store, x, *, filters, stride, expansion,
                        block_id):
    in_channels = x.shape[1]
    prefix = f"block_{block_id}_" if block_id else "expanded_conv_"
    inputs = x
    if block_id:
        x = s.conv(x, expansion * in_channels, 1, use_bias=False,
                   name=f"{prefix}expand")
        x = nn.relu6(s.bn(x, momentum=0.999, name=f"{prefix}expand_BN"))
    if stride == 2:
        x = nn.zero_pad(x, nn.correct_pad(x, 3))
    x = s.depthwise_conv(x, 3, strides=(stride, stride),
                         padding="SAME" if stride == 1 else "VALID",
                         use_bias=False, name=f"{prefix}depthwise")
    x = nn.relu6(s.bn(x, momentum=0.999, name=f"{prefix}depthwise_BN"))
    x = s.conv(x, filters, 1, use_bias=False, name=f"{prefix}project")
    x = s.bn(x, momentum=0.999, name=f"{prefix}project_BN")
    if in_channels == filters and stride == 1:
        return inputs + x
    return x


def build(s: Store, x, *, include_top=True, pooling=None, classes=1000):
    x = s.conv(x, 32, 3, strides=(2, 2), padding="SAME", use_bias=False,
               name="Conv1")
    x = nn.relu6(s.bn(x, momentum=0.999, name="bn_Conv1"))
    for block_id, (filters, stride, expansion) in enumerate(_BLOCKS):
        x = _inverted_res_block(s, x, filters=filters, stride=stride,
                                expansion=expansion, block_id=block_id)
    x = s.conv(x, 1280, 1, use_bias=False, name="Conv_1")
    x = nn.relu6(s.bn(x, momentum=0.999, name="Conv_1_bn"))

    if include_top:
        x = nn.global_avg_pool(x)
        x = s.dense(x, classes, name="predictions")
        return nn.softmax(x)
    if pooling == "avg":
        return nn.global_avg_pool(x)
    if pooling == "max":
        return nn.global_max_pool(x)
    return x
