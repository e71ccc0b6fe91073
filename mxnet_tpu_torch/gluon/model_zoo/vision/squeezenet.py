"""SqueezeNet 1.0 and 1.1 (counterpart of
`mxnet_tpu/gluon/model_zoo/vision/squeezenet.py`; reference:
python/mxnet/gluon/model_zoo/vision/squeezenet.py), with the JAX net's
block structure and parameter names."""
from __future__ import annotations

import functools

from ... import nn
from ...nn.basic_layers import _Layer
from ._common import _Net, _factory

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]


class _Fire(_Layer):
    """Squeeze 1x1, then 1x1 and 3x3 expansions concatenated on the channel
    axis of the layout scope it was built in."""

    def __init__(self, squeeze_channels, expand1x1_channels,
                 expand3x3_channels, **kwargs):
        super().__init__(**kwargs)
        self.squeeze = nn.Conv2D(squeeze_channels, kernel_size=1,
                                 activation="relu")
        self.expand1x1 = nn.Conv2D(expand1x1_channels, kernel_size=1,
                                   activation="relu")
        self.expand3x3 = nn.Conv2D(expand3x3_channels, kernel_size=3,
                                   padding=1, activation="relu")
        self._c_axis = -1 if nn.in_channels_last_scope() else 1

    def hybrid_forward(self, F, x):
        x = self.squeeze(x)
        return F.concat(self.expand1x1(x), self.expand3x3(x),
                        dim=self._c_axis)


class SqueezeNet(_Net):
    """SqueezeNet ``version`` "1.0" or "1.1": the stem, Fire modules
    between ceil-mode max pools, Dropout(0.5), a 1x1 conv to the classes,
    ReLU, AvgPool2D(13) and Flatten (224 x 224 input)."""

    def __init__(self, version, classes=1000, in_channels=0, device=None,
                 **kwargs):
        super().__init__(device=device, **kwargs)
        assert version in ("1.0", "1.1")
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            if version == "1.0":
                self.features.add(nn.Conv2D(96, kernel_size=7, strides=2,
                                            activation="relu",
                                            in_channels=in_channels))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                               ceil_mode=True))
                self.features.add(_Fire(16, 64, 64))
                self.features.add(_Fire(16, 64, 64))
                self.features.add(_Fire(32, 128, 128))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                               ceil_mode=True))
                self.features.add(_Fire(32, 128, 128))
                self.features.add(_Fire(48, 192, 192))
                self.features.add(_Fire(48, 192, 192))
                self.features.add(_Fire(64, 256, 256))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                               ceil_mode=True))
                self.features.add(_Fire(64, 256, 256))
            else:
                self.features.add(nn.Conv2D(64, kernel_size=3, strides=2,
                                            activation="relu",
                                            in_channels=in_channels))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                               ceil_mode=True))
                self.features.add(_Fire(16, 64, 64))
                self.features.add(_Fire(16, 64, 64))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                               ceil_mode=True))
                self.features.add(_Fire(32, 128, 128))
                self.features.add(_Fire(32, 128, 128))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                               ceil_mode=True))
                self.features.add(_Fire(48, 192, 192))
                self.features.add(_Fire(48, 192, 192))
                self.features.add(_Fire(64, 256, 256))
                self.features.add(_Fire(64, 256, 256))
            self.features.add(nn.Dropout(0.5))
            self.output = nn.HybridSequential(prefix="")
            self.output.add(nn.Conv2D(classes, kernel_size=1))
            self.output.add(nn.Activation("relu"))
            self.output.add(nn.AvgPool2D(13))
            self.output.add(nn.Flatten())

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def squeezenet1_0(pretrained=False, ctx=None, root=None, **kwargs):
    return _factory(functools.partial(SqueezeNet, "1.0"), pretrained, ctx,
                    kwargs)


def squeezenet1_1(pretrained=False, ctx=None, root=None, **kwargs):
    return _factory(functools.partial(SqueezeNet, "1.1"), pretrained, ctx,
                    kwargs)
