"""EfficientNetB0 as a build function over a
:class:`~tpudl_torch.zoo.core.Store`.

Port of ``tpudl/zoo/efficientnet.py`` (``build``, ``_block``,
``_conv_bn_act``): keras.applications' EfficientNetB0 with its layer
names (``stem_conv``, ``block1a_dwconv``, ..., ``top_conv``). 224×224
input, 'raw' preprocessing: the model rescales by 1/255 and applies its
``Normalization`` layer (:meth:`Store.norm_stats`) itself. MBConv blocks
use swish, a squeeze-excite of ``filters_in / 4`` with a sigmoid gate
(``se_reduce`` built before ``se_expand``), ``nn.correct_pad`` before each
stride-2 VALID depthwise conv, a projection with no activation, and a
residual add only where the stride is 1 and ``filters_in ==
filters_out``. 1280-d features.
"""

from __future__ import annotations

from tpudl_torch.zoo import nn
from tpudl_torch.zoo.core import Store

NAME = "EfficientNetB0"
INPUT_SIZE = (224, 224)
FEATURE_DIM = 1280
PREPROCESS_MODE = "raw"

# Keras's DEFAULT_BLOCKS_ARGS; B0's width and depth coefficients (1.0)
# leave the table as it is
_BLOCKS = [
    # kernel, repeats, filters_in, filters_out, expand, strides
    (3, 1, 32, 16, 1, 1),
    (3, 2, 16, 24, 6, 2),
    (5, 2, 24, 40, 6, 2),
    (3, 3, 40, 80, 6, 2),
    (5, 3, 80, 112, 6, 1),
    (5, 4, 112, 192, 6, 2),
    (3, 1, 192, 320, 6, 1),
]
_SE_RATIO = 0.25


def _block(s: Store, x, kernel, filters_in, filters_out, expand, stride,
           name):
    filters = filters_in * expand
    h = x
    if expand != 1:
        h = s.conv(h, filters, 1, padding="SAME", use_bias=False,
                   name=f"{name}_expand_conv")
        h = nn.swish(s.bn(h, name=f"{name}_expand_bn"))
    pad = "SAME"
    if stride == 2:
        h = nn.zero_pad(h, nn.correct_pad(h, kernel))
        pad = "VALID"
    h = s.depthwise_conv(h, kernel, strides=(stride, stride), padding=pad,
                         use_bias=False, name=f"{name}_dwconv")
    h = nn.swish(s.bn(h, name=f"{name}_bn"))

    # squeeze-excite: mean over space, a swish bottleneck, a sigmoid gate
    se = h.mean(dim=(2, 3), keepdim=True)
    se = s.conv(se, max(1, int(filters_in * _SE_RATIO)), 1, padding="SAME",
                name=f"{name}_se_reduce")
    se = s.conv(nn.swish(se), filters, 1, padding="SAME",
                name=f"{name}_se_expand")
    h = h * nn.sigmoid(se)

    h = s.conv(h, filters_out, 1, padding="SAME", use_bias=False,
               name=f"{name}_project_conv")
    h = s.bn(h, name=f"{name}_project_bn")
    if stride == 1 and filters_in == filters_out:
        h = h + x   # Keras's dropout before the add is the identity here
    return h


def build(s: Store, x, *, include_top=True, pooling=None, classes=1000):
    x = s.norm_stats(x / 255.0)

    x = nn.zero_pad(x, nn.correct_pad(x, 3))
    x = s.conv(x, 32, 3, strides=(2, 2), padding="VALID", use_bias=False,
               name="stem_conv")
    x = nn.swish(s.bn(x, name="stem_bn"))

    for i, (kernel, repeats, f_in, f_out, expand, stride) in enumerate(
            _BLOCKS):
        for j in range(repeats):
            x = _block(s, x, kernel, f_in if j == 0 else f_out, f_out,
                       expand, stride if j == 0 else 1,
                       name=f"block{i + 1}{chr(97 + j)}")

    x = s.conv(x, 1280, 1, padding="SAME", use_bias=False, name="top_conv")
    x = nn.swish(s.bn(x, name="top_bn"))

    if include_top:
        x = nn.global_avg_pool(x)
        x = s.dense(x, classes, name="predictions")
        return nn.softmax(x)
    if pooling == "avg":
        return nn.global_avg_pool(x)
    if pooling == "max":
        return nn.global_max_pool(x)
    return x
