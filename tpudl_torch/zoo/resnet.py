"""ResNet50, ResNet101 and ResNet152 (v1) as build functions over a
:class:`~tpudl_torch.zoo.core.Store`.

Port of ``tpudl/zoo/resnet.py`` (``build``, ``build_resnet101``,
``build_resnet152`` over one ``_build_resnet``): keras.applications'
ResNet v1 with its stable layer names (``conv1_conv``,
``conv2_block1_0_conv``, ...). 224×224 input, 'caffe' preprocessing,
2048-d features. All convs carry a bias, BN eps is 1.001e-5, and each
first block builds its 1×1 shortcut conv before its ``_1_conv``, as
Keras creates them, so ``init(seed)`` draws in tpudl's order.
"""

from __future__ import annotations

from tpudl_torch.zoo import nn
from tpudl_torch.zoo.core import Store

NAME = "ResNet50"
INPUT_SIZE = (224, 224)
FEATURE_DIM = 2048
PREPROCESS_MODE = "caffe"

_EPS = 1.001e-5


def _block(s: Store, x, filters, *, stride=1, conv_shortcut=True, name=""):
    if conv_shortcut:
        shortcut = s.conv(x, 4 * filters, 1, strides=(stride, stride),
                          padding="VALID", name=f"{name}_0_conv")
        shortcut = s.bn(shortcut, epsilon=_EPS, name=f"{name}_0_bn")
    else:
        shortcut = x
    x = s.conv(x, filters, 1, strides=(stride, stride), padding="VALID",
               name=f"{name}_1_conv")
    x = nn.relu(s.bn(x, epsilon=_EPS, name=f"{name}_1_bn"))
    x = s.conv(x, filters, 3, padding="SAME", name=f"{name}_2_conv")
    x = nn.relu(s.bn(x, epsilon=_EPS, name=f"{name}_2_bn"))
    x = s.conv(x, 4 * filters, 1, padding="VALID", name=f"{name}_3_conv")
    x = s.bn(x, epsilon=_EPS, name=f"{name}_3_bn")
    return nn.relu(shortcut + x)


def _build_resnet(s: Store, x, stacks, *, include_top=True, pooling=None,
                  classes=1000):
    """The v1 bottleneck skeleton; ``stacks`` holds the blocks of the
    conv2..conv5 stages."""
    x = nn.zero_pad(x, ((3, 3), (3, 3)))
    x = s.conv(x, 64, 7, strides=(2, 2), padding="VALID", name="conv1_conv")
    x = nn.relu(s.bn(x, epsilon=_EPS, name="conv1_bn"))
    x = nn.zero_pad(x, ((1, 1), (1, 1)))
    x = nn.max_pool(x, (3, 3), strides=(2, 2))

    for i, (filters, blocks) in enumerate(zip((64, 128, 256, 512), stacks)):
        stage = f"conv{i + 2}"
        x = _block(s, x, filters, stride=1 if i == 0 else 2,
                   name=f"{stage}_block1")
        for b in range(2, blocks + 1):
            x = _block(s, x, filters, conv_shortcut=False,
                       name=f"{stage}_block{b}")

    if include_top:
        x = nn.global_avg_pool(x)
        x = s.dense(x, classes, name="predictions")
        return nn.softmax(x)
    if pooling == "avg":
        return nn.global_avg_pool(x)
    if pooling == "max":
        return nn.global_max_pool(x)
    return x


def build(s: Store, x, *, include_top=True, pooling=None, classes=1000):
    """ResNet50: stacks (3, 4, 6, 3)."""
    return _build_resnet(s, x, (3, 4, 6, 3), include_top=include_top,
                         pooling=pooling, classes=classes)


def build_resnet101(s: Store, x, *, include_top=True, pooling=None,
                    classes=1000):
    """ResNet101: stacks (3, 4, 23, 3)."""
    return _build_resnet(s, x, (3, 4, 23, 3), include_top=include_top,
                         pooling=pooling, classes=classes)


def build_resnet152(s: Store, x, *, include_top=True, pooling=None,
                    classes=1000):
    """ResNet152: stacks (3, 8, 36, 3)."""
    return _build_resnet(s, x, (3, 8, 36, 3), include_top=include_top,
                         pooling=pooling, classes=classes)
