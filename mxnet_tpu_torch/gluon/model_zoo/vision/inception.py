"""Inception V3 (counterpart of
`mxnet_tpu/gluon/model_zoo/vision/inception.py`; reference:
python/mxnet/gluon/model_zoo/vision/inception.py), with the JAX net's block
structure and parameter names: the stem, the concurrent branches A (x3),
B, C (x4, the 1x7 / 7x1 kernels), D and E (x2), AvgPool2D(8) (so a 299 x
299 input), Dropout(0.5) and the classifier. Each BatchNorm (eps 1e-3)
trains through the conv-epilogue kernels on the card. Branch outputs are
concatenated on the channel axis of the layout scope the block was built
in (fixed at construction, as the JAX blocks capture it)."""
from __future__ import annotations

from ... import nn
from ...nn.basic_layers import _Layer
from ._common import _Net, _factory

__all__ = ["Inception3", "inception_v3"]


def _make_basic_conv(**kwargs):
    out = nn.HybridSequential(prefix="")
    out.add(nn.Conv2D(use_bias=False, **kwargs))
    out.add(nn.BatchNorm(epsilon=0.001))
    out.add(nn.Activation("relu"))
    return out


class _Concurrent(_Layer):
    """Its children applied to one input, the outputs concatenated."""

    def __init__(self, prefix=None):
        super().__init__(prefix=prefix)
        self._c_axis = -1 if nn.in_channels_last_scope() else 1

    def add(self, block):
        self.register_child(block)

    def hybrid_forward(self, F, x):
        return F.concat(*[block(x) for block in self._children.values()],
                        dim=self._c_axis)


def _make_branch(use_pool, *conv_settings):
    out = nn.HybridSequential(prefix="")
    if use_pool == "avg":
        out.add(nn.AvgPool2D(pool_size=3, strides=1, padding=1))
    elif use_pool == "max":
        out.add(nn.MaxPool2D(pool_size=3, strides=2))
    setting_names = ["channels", "kernel_size", "strides", "padding"]
    for setting in conv_settings:
        kwargs = {}
        for i, value in enumerate(setting):
            if value is not None:
                kwargs[setting_names[i]] = value
        out.add(_make_basic_conv(**kwargs))
    return out


def _make_A(pool_features, prefix):
    out = _Concurrent(prefix=prefix)
    out.add(_make_branch(None, (64, 1, None, None)))
    out.add(_make_branch(None, (48, 1, None, None), (64, 5, None, 2)))
    out.add(_make_branch(None, (64, 1, None, None), (96, 3, None, 1),
                         (96, 3, None, 1)))
    out.add(_make_branch("avg", (pool_features, 1, None, None)))
    return out


def _make_B(prefix):
    out = _Concurrent(prefix=prefix)
    out.add(_make_branch(None, (384, 3, 2, None)))
    out.add(_make_branch(None, (64, 1, None, None), (96, 3, None, 1),
                         (96, 3, 2, None)))
    out.add(_make_branch("max"))
    return out


def _make_C(channels_7x7, prefix):
    out = _Concurrent(prefix=prefix)
    out.add(_make_branch(None, (192, 1, None, None)))
    out.add(_make_branch(None, (channels_7x7, 1, None, None),
                         (channels_7x7, (1, 7), None, (0, 3)),
                         (192, (7, 1), None, (3, 0))))
    out.add(_make_branch(None, (channels_7x7, 1, None, None),
                         (channels_7x7, (7, 1), None, (3, 0)),
                         (channels_7x7, (1, 7), None, (0, 3)),
                         (channels_7x7, (7, 1), None, (3, 0)),
                         (192, (1, 7), None, (0, 3))))
    out.add(_make_branch("avg", (192, 1, None, None)))
    return out


def _make_D(prefix):
    out = _Concurrent(prefix=prefix)
    out.add(_make_branch(None, (192, 1, None, None), (320, 3, 2, None)))
    out.add(_make_branch(None, (192, 1, None, None),
                         (192, (1, 7), None, (0, 3)),
                         (192, (7, 1), None, (3, 0)), (192, 3, 2, None)))
    out.add(_make_branch("max"))
    return out


class _InceptionE(_Layer):
    """Branch E: 1x1; 1x1 then 1x3 and 3x1 side by side; 1x1, 3x3 then 1x3
    and 3x1 side by side; 3x3/1 average pool then 1x1."""

    def __init__(self, prefix):
        super().__init__(prefix=prefix)
        self.branch1 = _make_branch(None, (320, 1, None, None))
        self.branch2_stem = _make_basic_conv(channels=384, kernel_size=1)
        self.branch2_a = _make_basic_conv(channels=384, kernel_size=(1, 3),
                                          padding=(0, 1))
        self.branch2_b = _make_basic_conv(channels=384, kernel_size=(3, 1),
                                          padding=(1, 0))
        self.branch3_stem = _make_branch(None, (448, 1, None, None),
                                         (384, 3, None, 1))
        self.branch3_a = _make_basic_conv(channels=384, kernel_size=(1, 3),
                                          padding=(0, 1))
        self.branch3_b = _make_basic_conv(channels=384, kernel_size=(3, 1),
                                          padding=(1, 0))
        self.branch4 = _make_branch("avg", (192, 1, None, None))
        self._c_axis = -1 if nn.in_channels_last_scope() else 1

    def hybrid_forward(self, F, x):
        c = self._c_axis
        b1 = self.branch1(x)
        s2 = self.branch2_stem(x)
        b2 = F.concat(self.branch2_a(s2), self.branch2_b(s2), dim=c)
        s3 = self.branch3_stem(x)
        b3 = F.concat(self.branch3_a(s3), self.branch3_b(s3), dim=c)
        b4 = self.branch4(x)
        return F.concat(b1, b2, b3, b4, dim=c)


class Inception3(_Net):
    """Inception V3 (94 convolutions, each with a BatchNorm of eps 1e-3)
    for a 299 x 299 input. ``in_channels`` sizes the first convolution (0:
    from the first input)."""

    def __init__(self, classes=1000, in_channels=0, device=None, **kwargs):
        super().__init__(device=device, **kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(_make_basic_conv(channels=32, kernel_size=3,
                                               strides=2,
                                               in_channels=in_channels))
            self.features.add(_make_basic_conv(channels=32, kernel_size=3))
            self.features.add(_make_basic_conv(channels=64, kernel_size=3,
                                               padding=1))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
            self.features.add(_make_basic_conv(channels=80, kernel_size=1))
            self.features.add(_make_basic_conv(channels=192, kernel_size=3))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
            self.features.add(_make_A(32, "A1_"))
            self.features.add(_make_A(64, "A2_"))
            self.features.add(_make_A(64, "A3_"))
            self.features.add(_make_B("B_"))
            self.features.add(_make_C(128, "C1_"))
            self.features.add(_make_C(160, "C2_"))
            self.features.add(_make_C(160, "C3_"))
            self.features.add(_make_C(192, "C4_"))
            self.features.add(_make_D("D_"))
            self.features.add(_InceptionE("E1_"))
            self.features.add(_InceptionE("E2_"))
            self.features.add(nn.AvgPool2D(pool_size=8))
            self.features.add(nn.Dropout(0.5))
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def inception_v3(pretrained=False, ctx=None, root=None, **kwargs):
    return _factory(Inception3, pretrained, ctx, kwargs)
