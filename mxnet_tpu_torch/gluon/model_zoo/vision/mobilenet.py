"""MobileNet v1 and v2 (counterpart of
`mxnet_tpu/gluon/model_zoo/vision/mobilenet.py`; reference:
python/mxnet/gluon/model_zoo/vision/mobilenet.py), with the JAX net's block
structure and parameter names. The depthwise convolutions are grouped
convolutions (``groups`` = channels); RELU6 is ``clip(x, 0, 6)``, whose
gradient at 0 and at 6 is the JAX package's 0.5 (`ops.tensor.clip`)."""
from __future__ import annotations

import functools

from ... import nn
from ...nn.basic_layers import _Layer
from ._common import _Net, _factory

__all__ = ["MobileNet", "MobileNetV2", "mobilenet1_0", "mobilenet0_75",
           "mobilenet0_5", "mobilenet0_25", "mobilenet_v2_1_0",
           "mobilenet_v2_0_75", "mobilenet_v2_0_5", "mobilenet_v2_0_25"]


def _add_conv(out, channels=1, kernel=1, stride=1, pad=0, num_group=1,
              active=True, relu6=False, in_channels=0):
    out.add(nn.Conv2D(channels, kernel, stride, pad, groups=num_group,
                      use_bias=False, in_channels=in_channels))
    out.add(nn.BatchNorm(scale=True))
    if active:
        out.add(_ReLU6() if relu6 else nn.Activation("relu"))


class _ReLU6(_Layer):
    def hybrid_forward(self, F, x):
        return F.clip(x, 0, 6)


def _add_conv_dw(out, dw_channels, channels, stride, relu6=False):
    _add_conv(out, channels=dw_channels, kernel=3, stride=stride, pad=1,
              num_group=dw_channels, relu6=relu6)
    _add_conv(out, channels=channels, relu6=relu6)


class _LinearBottleneck(_Layer):
    """1x1 expansion by ``t`` (BN, RELU6), 3x3 depthwise (BN, RELU6), 1x1
    projection (BN); the input added when the shape is kept."""

    def __init__(self, in_channels, channels, t, stride, **kwargs):
        super().__init__(**kwargs)
        self.use_shortcut = stride == 1 and in_channels == channels
        self.out = nn.HybridSequential()
        _add_conv(self.out, in_channels * t, relu6=True)
        _add_conv(self.out, in_channels * t, kernel=3, stride=stride, pad=1,
                  num_group=in_channels * t, relu6=True)
        _add_conv(self.out, channels, active=False, relu6=True)

    def hybrid_forward(self, F, x):
        out = self.out(x)
        if self.use_shortcut:
            out = out + x
        return out


class MobileNet(_Net):
    """MobileNet v1 at width ``multiplier``: a 3x3/2 conv, 13 depthwise
    separable pairs, global average pool, Flatten, the classifier."""

    def __init__(self, multiplier=1.0, classes=1000, in_channels=0,
                 device=None, **kwargs):
        super().__init__(device=device, **kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            with self.features.name_scope():
                _add_conv(self.features, channels=int(32 * multiplier),
                          kernel=3, pad=1, stride=2, in_channels=in_channels)
                dw_channels = [int(x * multiplier) for x in
                               [32, 64] + [128] * 2 + [256] * 2 + [512] * 6
                               + [1024]]
                channels = [int(x * multiplier) for x in
                            [64] + [128] * 2 + [256] * 2 + [512] * 6
                            + [1024] * 2]
                strides = [1, 2] * 3 + [1] * 5 + [2, 1]
                for dwc, c, s in zip(dw_channels, channels, strides):
                    _add_conv_dw(self.features, dw_channels=dwc, channels=c,
                                 stride=s)
                self.features.add(nn.GlobalAvgPool2D())
                self.features.add(nn.Flatten())
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


class MobileNetV2(_Net):
    """MobileNet v2 at width ``multiplier``: a 3x3/2 conv, 17 linear
    bottlenecks, a 1x1 conv to 1280 (RELU6 throughout), global average
    pool, and a 1x1 conv to the classes, flattened."""

    def __init__(self, multiplier=1.0, classes=1000, in_channels=0,
                 device=None, **kwargs):
        super().__init__(device=device, **kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="features_")
            with self.features.name_scope():
                _add_conv(self.features, int(32 * multiplier), kernel=3,
                          stride=2, pad=1, relu6=True,
                          in_channels=in_channels)
                in_channels_group = [int(x * multiplier) for x in
                                     [32] + [16] + [24] * 2 + [32] * 3
                                     + [64] * 4 + [96] * 3 + [160] * 3]
                channels_group = [int(x * multiplier) for x in
                                  [16] + [24] * 2 + [32] * 3 + [64] * 4
                                  + [96] * 3 + [160] * 3 + [320]]
                ts = [1] + [6] * 16
                strides = [1, 2] * 2 + [1, 1, 2] + [1] * 6 + [2] + [1] * 3
                for in_c, c, t, s in zip(in_channels_group, channels_group,
                                         ts, strides):
                    self.features.add(_LinearBottleneck(
                        in_channels=in_c, channels=c, t=t, stride=s))
                last_channels = int(1280 * multiplier) \
                    if multiplier > 1.0 else 1280
                _add_conv(self.features, last_channels, relu6=True)
                self.features.add(nn.GlobalAvgPool2D())
            self.output = nn.HybridSequential(prefix="output_")
            with self.output.name_scope():
                self.output.add(nn.Conv2D(classes, 1, use_bias=False,
                                          prefix="pred_"),
                                nn.Flatten())

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def get_mobilenet(multiplier, pretrained=False, ctx=None, root=None,
                  **kwargs):
    return _factory(functools.partial(MobileNet, multiplier), pretrained,
                    ctx, kwargs)


def get_mobilenet_v2(multiplier, pretrained=False, ctx=None, root=None,
                     **kwargs):
    return _factory(functools.partial(MobileNetV2, multiplier), pretrained,
                    ctx, kwargs)


def mobilenet1_0(**kwargs):
    return get_mobilenet(1.0, **kwargs)


def mobilenet0_75(**kwargs):
    return get_mobilenet(0.75, **kwargs)


def mobilenet0_5(**kwargs):
    return get_mobilenet(0.5, **kwargs)


def mobilenet0_25(**kwargs):
    return get_mobilenet(0.25, **kwargs)


def mobilenet_v2_1_0(**kwargs):
    return get_mobilenet_v2(1.0, **kwargs)


def mobilenet_v2_0_75(**kwargs):
    return get_mobilenet_v2(0.75, **kwargs)


def mobilenet_v2_0_5(**kwargs):
    return get_mobilenet_v2(0.5, **kwargs)


def mobilenet_v2_0_25(**kwargs):
    return get_mobilenet_v2(0.25, **kwargs)
