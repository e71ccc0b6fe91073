"""AlexNet (counterpart of `mxnet_tpu/gluon/model_zoo/vision/alexnet.py`;
reference: python/mxnet/gluon/model_zoo/vision/alexnet.py), with the JAX
net's block structure and parameter names."""
from __future__ import annotations

from ... import nn
from ._common import _Net, _factory

__all__ = ["AlexNet", "alexnet"]


class AlexNet(_Net):
    """Five convolutions (ReLU), three max pools, two Dense(4096) with
    Dropout(0.5), and the classifier. ``in_channels`` sizes the first
    convolution (0: from the first input)."""

    def __init__(self, classes=1000, in_channels=0, device=None, **kwargs):
        super().__init__(device=device, **kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            with self.features.name_scope():
                self.features.add(nn.Conv2D(64, kernel_size=11, strides=4,
                                            padding=2, activation="relu",
                                            in_channels=in_channels))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
                self.features.add(nn.Conv2D(192, kernel_size=5, padding=2,
                                            activation="relu"))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
                self.features.add(nn.Conv2D(384, kernel_size=3, padding=1,
                                            activation="relu"))
                self.features.add(nn.Conv2D(256, kernel_size=3, padding=1,
                                            activation="relu"))
                self.features.add(nn.Conv2D(256, kernel_size=3, padding=1,
                                            activation="relu"))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
                self.features.add(nn.Flatten())
                self.features.add(nn.Dense(4096, activation="relu"))
                self.features.add(nn.Dropout(0.5))
                self.features.add(nn.Dense(4096, activation="relu"))
                self.features.add(nn.Dropout(0.5))
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def alexnet(pretrained=False, ctx=None, root=None, **kwargs):
    return _factory(AlexNet, pretrained, ctx, kwargs)
