"""The port's zoo ops (``tpudl_torch.zoo.nn``) and param store
(``tpudl_torch.zoo.core``) against tpudl's, on the same seeded numpy
inputs and weights at small sizes.

Layouts: tpudl takes NHWC activations and HWIO kernels; the port takes
NCHW activations and OIHW kernels (``convert.torch_layout``), so each
case transposes on the way in and out.

Tolerances: f32 on the CPU with sums in another order — every op within
1e-5 of max(1, max |y|) (values here are O(1)); ops that move or compare
values without arithmetic (pads, max pools, relu) are held exactly."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tpudl.zoo import core as jcore
from tpudl.zoo import efficientnet as jeff
from tpudl.zoo import mobilenet_v2 as jmobile
from tpudl.zoo import nn as jnn
from tpudl_torch.zoo import core, nn
from tpudl_torch.zoo.convert import torch_layout, torch_params

torch.set_num_threads(1)

TOL = 1e-5


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(y):
    y = y.detach()
    return (y.permute(0, 2, 3, 1) if y.ndim == 4 else y).numpy()


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= tol * scale, np.abs(got - want).max()


# (input NHWC, kernel HWIO, strides, padding)
CONV_CASES = {
    "same s2 odd": ((2, 9, 11, 3), (3, 3, 3, 4), (2, 2), "SAME"),
    "same s2 even": ((2, 8, 10, 3), (3, 3, 3, 4), (2, 2), "SAME"),
    "same s2 k2": ((1, 7, 8, 2), (2, 2, 2, 3), (2, 2), "SAME"),
    "same s3 k5": ((1, 10, 11, 2), (5, 5, 2, 3), (3, 3), "SAME"),
    "same s1 k3": ((2, 6, 7, 3), (3, 3, 3, 5), (1, 1), "SAME"),
    "same s1 k4 (asymmetric)": ((1, 6, 7, 2), (4, 4, 2, 3), (1, 1), "SAME"),
    "same 1x7": ((2, 9, 9, 4), (1, 7, 4, 3), (1, 1), "SAME"),
    "same 7x1": ((2, 9, 9, 4), (7, 1, 4, 3), (1, 1), "SAME"),
    "valid s1": ((2, 9, 9, 3), (3, 3, 3, 4), (1, 1), "VALID"),
    "valid s2": ((2, 10, 9, 3), (3, 3, 3, 4), (2, 2), "VALID"),
    "valid s2x1": ((1, 10, 9, 3), (3, 2, 3, 4), (2, 1), "VALID"),
}


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv2d_matches_tpudl(case, bias):
    xs, ks, strides, padding = CONV_CASES[case]
    x, k = _x(xs), _x(ks, 1)
    b = _x((ks[-1],), 2) if bias else None
    want = jnn.conv2d(jnp.asarray(x), jnp.asarray(k),
                      None if b is None else jnp.asarray(b),
                      strides=strides, padding=padding)
    got = nn.conv2d(_nchw(x), torch_layout("kernel", k),
                    None if b is None else torch.from_numpy(b),
                    strides=strides, padding=padding)
    _close(_nhwc(got), want)


@pytest.mark.parametrize("mult", [1, 2])
@pytest.mark.parametrize("strides,padding", [((1, 1), "SAME"),
                                             ((2, 2), "SAME"),
                                             ((2, 2), "VALID")])
def test_depthwise_conv2d_matches_tpudl(mult, strides, padding):
    x, k, b = _x((2, 9, 8, 3)), _x((3, 3, 3, mult), 1), _x((3 * mult,), 2)
    want = jnn.depthwise_conv2d(jnp.asarray(x), jnp.asarray(k),
                                jnp.asarray(b), strides=strides,
                                padding=padding)
    got = nn.depthwise_conv2d(_nchw(x), torch_layout("depthwise_kernel", k),
                              torch.from_numpy(b), strides=strides,
                              padding=padding)
    _close(_nhwc(got), want)


def test_depthwise_channel_order_is_group_major():
    """Output channel c * mult + m reads input channel c with kernel
    [:, :, c, m]: a 1x1 kernel makes it visible exactly."""
    x = _x((1, 3, 3, 2))
    k = np.arange(1, 7, dtype=np.float32).reshape(1, 1, 2, 3)  # mult 3
    got = _nhwc(nn.depthwise_conv2d(_nchw(x), torch_layout(
        "depthwise_kernel", k), padding="VALID"))
    for c in range(2):
        for m in range(3):
            np.testing.assert_array_equal(got[..., c * 3 + m],
                                          x[..., c] * k[0, 0, c, m])


def test_separable_conv2d_matches_tpudl():
    x, dk, pk, b = (_x((2, 8, 9, 3)), _x((3, 3, 3, 1), 1),
                    _x((1, 1, 3, 5), 2), _x((5,), 3))
    want = jnn.separable_conv2d(jnp.asarray(x), jnp.asarray(dk),
                                jnp.asarray(pk), jnp.asarray(b),
                                strides=(2, 2))
    got = nn.separable_conv2d(_nchw(x), torch_layout("depthwise_kernel", dk),
                              torch_layout("pointwise_kernel", pk),
                              torch.from_numpy(b), strides=(2, 2))
    _close(_nhwc(got), want)


def test_dense_matches_tpudl():
    x, k, b = _x((3, 7)), _x((7, 5), 1), _x((5,), 2)
    want = jnn.dense(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))
    got = nn.dense(torch.from_numpy(x), torch.from_numpy(k),
                   torch.from_numpy(b))
    _close(got.numpy(), want)


def _bn_params(c, scale, seed=3):
    rng = np.random.default_rng(seed)
    p = {"beta": rng.normal(0, 0.1, c).astype(np.float32),
         "moving_mean": rng.normal(0, 0.1, c).astype(np.float32),
         "moving_var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
    if scale:
        p["gamma"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
    return p


@pytest.mark.parametrize("scale", [False, True])
def test_batch_norm_inference_matches_tpudl(scale):
    x, p = _x((2, 5, 6, 4)), _bn_params(4, scale)
    want = jnn.batch_norm(jnp.asarray(x), p)
    got = nn.batch_norm(_nchw(x), {k: torch.from_numpy(v)
                                   for k, v in p.items()})
    _close(_nhwc(got), want)


def test_batch_norm_inference_bf16_folds_in_f32_like_tpudl():
    """The scale and shift are folded in f32 and cast to bf16 once, as
    tpudl does; both then multiply-add in bf16. Held to one bf16 ulp of
    each value (they may round the product differently)."""
    x, p = _x((2, 5, 6, 4)), _bn_params(4, True)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jnn.batch_norm(xb, p).astype(jnp.float32))
    got = nn.batch_norm(_nchw(x).to(torch.bfloat16),
                        {k: torch.from_numpy(v) for k, v in p.items()})
    got = _nhwc(got.float())
    assert np.all(np.abs(got - want) <= 2.0 ** -7 * np.abs(want) + 1e-6)


@pytest.mark.parametrize("scale", [False, True])
def test_batch_norm_train_matches_tpudl(scale):
    x, p = _x((3, 5, 6, 4)), _bn_params(4, scale)
    want, want_stats = jnn.batch_norm(jnp.asarray(x), p, train=True)
    got, stats = nn.batch_norm(_nchw(x), {k: torch.from_numpy(v)
                                          for k, v in p.items()}, train=True)
    _close(_nhwc(got), want)
    assert sorted(stats) == sorted(want_stats)
    for k in stats:
        _close(stats[k].numpy(), want_stats[k])


# (input NHWC, window, strides, padding)
POOL_CASES = {
    "same k3 s1": ((2, 7, 6, 3), (3, 3), (1, 1), "SAME"),
    "same k3 s2 odd": ((2, 7, 9, 3), (3, 3), (2, 2), "SAME"),
    "same k3 s2 even": ((2, 8, 6, 3), (3, 3), (2, 2), "SAME"),
    "same k2 s1 (asymmetric)": ((1, 5, 6, 2), (2, 2), (1, 1), "SAME"),
    "same k3 s3": ((1, 8, 7, 2), (3, 3), (3, 3), "SAME"),
    "valid k3 s2": ((2, 9, 8, 3), (3, 3), (2, 2), "VALID"),
    "valid k2 s1": ((1, 5, 6, 2), (2, 2), (1, 1), "VALID"),
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_avg_pool_matches_tpudl(case):
    xs, w, s, padding = POOL_CASES[case]
    x = _x(xs)
    want = jnn.avg_pool(jnp.asarray(x), w, strides=s, padding=padding)
    got = nn.avg_pool(_nchw(x), w, strides=s, padding=padding)
    _close(_nhwc(got), want)


def test_avg_pool_same_leaves_pads_out_of_the_divisor():
    """At a corner a 3x3 SAME window holds 4 real cells: on ones the mean
    stays exactly 1 everywhere (a divisor of 9 would give 4/9)."""
    ones = torch.ones(1, 1, 5, 5)
    got = nn.avg_pool(ones, (3, 3), strides=(1, 1), padding="SAME")
    assert torch.equal(got, ones)
    got = nn.avg_pool(ones, (2, 2), strides=(1, 1), padding="SAME")
    assert torch.equal(got, ones)


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_max_pool_matches_tpudl(case):
    xs, w, s, padding = POOL_CASES[case]
    x = _x(xs) - 10.0   # all negative: a zero pad would win
    want = jnn.max_pool(jnp.asarray(x), w, strides=s, padding=padding)
    got = nn.max_pool(_nchw(x), w, strides=s, padding=padding)
    np.testing.assert_array_equal(_nhwc(got), np.asarray(want))


@pytest.mark.parametrize("name", ["global_avg_pool", "global_max_pool",
                                  "relu", "relu6"])
def test_elementwise_and_global_ops_match_tpudl(name):
    x = _x((2, 5, 4, 3)) * 8.0
    want = np.asarray(getattr(jnn, name)(jnp.asarray(x)))
    got = _nhwc(getattr(nn, name)(_nchw(x)))
    _close(got, want)
    if name != "global_avg_pool":
        np.testing.assert_array_equal(got, want)


def test_softmax_and_zero_pad_match_tpudl():
    z = _x((3, 10)) * 4.0
    _close(nn.softmax(torch.from_numpy(z)).numpy(),
           jnn.softmax(jnp.asarray(z)))
    x = _x((2, 4, 5, 3))
    pad = ((1, 2), (3, 0))
    np.testing.assert_array_equal(_nhwc(nn.zero_pad(_nchw(x), pad)),
                                  np.asarray(jnn.zero_pad(jnp.asarray(x),
                                                          pad)))


@pytest.mark.parametrize("name,jax_fn", [("swish", jax.nn.silu),
                                         ("sigmoid", jax.nn.sigmoid)])
def test_swish_and_sigmoid_match_jax_nn(name, jax_fn):
    """EfficientNet's activations, which tpudl takes from ``jax.nn``."""
    x = _x((2, 5, 4, 3)) * 8.0
    _close(_nhwc(getattr(nn, name)(_nchw(x))), jax_fn(jnp.asarray(x)))


def test_flatten_nhwc_is_keras_flatten():
    """VGG's head: the NCHW map flattened in Keras's NHWC row-major order,
    as tpudl reshapes its NHWC map."""
    x = _x((2, 3, 2, 5))
    np.testing.assert_array_equal(nn.flatten_nhwc(_nchw(x)).numpy(),
                                  x.reshape(2, -1))


@pytest.mark.parametrize("hw", [(32, 32), (33, 33), (16, 17), (9, 8)])
@pytest.mark.parametrize("kernel", [3, 5])
def test_correct_pad_matches_tpudl(hw, kernel):
    """Keras's ``correct_pad`` as MobileNetV2 and EfficientNet call it:
    tpudl reads (h, w) off NHWC, the port off NCHW; 3 channels would read
    as an odd height if the axes were carried over."""
    x = np.zeros((1, *hw, 3), np.float32)
    want = jeff._correct_pad(x, kernel)
    if kernel == 3:
        assert jmobile._correct_pad(x, kernel) == want
    assert nn.correct_pad(_nchw(x), kernel) == want


def test_same_pads_is_tf_same():
    # pad = max((ceil(n / s) - 1) * s + k - n, 0), the extra one after
    assert nn.same_pads((9, 8), (3, 3), (2, 2)) == ((1, 1), (0, 1))
    assert nn.same_pads((5, 5), (2, 2), (1, 1)) == ((0, 1), (0, 1))
    assert nn.same_pads((4, 4), (1, 1), (2, 2)) == ((0, 0), (0, 0))


def test_bad_padding_raises():
    x = torch.zeros(1, 1, 4, 4)
    with pytest.raises(ValueError, match="padding"):
        nn.conv2d(x, torch.zeros(1, 1, 3, 3), padding="same")
    with pytest.raises(ValueError, match="padding"):
        nn.avg_pool(x, 2, strides=1, padding="FULL")


# -- Store: one small build over every layer type, in all three modes -----

def _build(s, x, *, jax_side):
    cat = ((lambda ts: jnp.concatenate(ts, axis=-1)) if jax_side
           else (lambda ts: torch.cat(ts, dim=1)))
    ops = jnn if jax_side else nn
    a = s.conv(x, 6, 3, strides=(2, 2), padding="VALID", use_bias=False)
    a = ops.relu(s.bn(a, scale=False))
    b = s.sep_conv(x, 4, 3, strides=(2, 2), padding="VALID")
    b = s.bn(b)
    a = s.depthwise_conv(cat([a, b]), (1, 3))
    a = s.bn(ops.relu(a), name="named_bn")
    y = ops.global_avg_pool(a)
    return ops.softmax(s.dense(y, 7, name="predictions"))


def _perturbed(params):
    rng = np.random.default_rng(5)
    out = {}
    for layer, leaves in params.items():
        out[layer] = {k: (v + rng.normal(0, 0.1, v.shape).astype(np.float32)
                          if k in ("beta", "moving_mean", "bias") else v)
                      for k, v in leaves.items()}
    return out


def test_store_init_apply_train_match_tpudl():
    shape = (2, 9, 9, 3)
    js = jcore.Store(rng=np.random.default_rng(0))
    _build(js, jnp.zeros(shape, jnp.float32), jax_side=True)
    ts = core.Store(rng=np.random.default_rng(0))
    _build(ts, torch.empty((2, 3, 9, 9), device="meta"), jax_side=False)
    # init: the same names in the same order, bit-equal draws
    assert list(ts.params) == list(js.params)
    assert list(ts.params) == ["conv2d", "batch_normalization",
                               "separable_conv2d", "batch_normalization_1",
                               "depthwise_conv2d", "named_bn", "predictions"]
    for layer in js.params:
        assert sorted(ts.params[layer]) == sorted(js.params[layer])
        for k, v in js.params[layer].items():
            got = ts.params[layer][k]
            assert isinstance(got, np.ndarray) and got.dtype == v.dtype
            np.testing.assert_array_equal(got, np.asarray(v))

    params = _perturbed(js.params)
    x = _x(shape, 4)
    want = _build(jcore.Store(params=params), jnp.asarray(x), jax_side=True)
    got = _build(core.Store(params=torch_params(params)), _nchw(x),
                 jax_side=False)
    _close(got.numpy(), want)

    jtrain = jcore.Store(params=params, train=True)
    want = _build(jtrain, jnp.asarray(x), jax_side=True)
    ttrain = core.Store(params=torch_params(params), train=True)
    got = _build(ttrain, _nchw(x), jax_side=False)
    _close(got.numpy(), want)
    assert sorted(ttrain.bn_updates) == sorted(jtrain.bn_updates)
    merged, jmerged = ttrain.merged_params(), jtrain.merged_params()
    for layer in jtrain.bn_updates:
        assert sorted(merged[layer]) == sorted(jmerged[layer])
        for k, v in jmerged[layer].items():
            _close(np.asarray(merged[layer][k]), v)


def test_store_modes_and_missing_params():
    with pytest.raises(ValueError, match="exactly one"):
        core.Store()
    with pytest.raises(TypeError, match="Generator"):
        core.Store(rng=0)
    with pytest.raises(KeyError, match="conv2d"):
        core.Store(params={}).conv(torch.zeros(1, 1, 4, 4), 2, 3)


def test_namer_is_keras_auto_naming():
    n = core.Namer()
    assert [n("conv2d"), n("conv2d"), n("dense"), n("conv2d", "x"),
            n("conv2d")] == ["conv2d", "conv2d_1", "dense", "x", "conv2d_2"]
