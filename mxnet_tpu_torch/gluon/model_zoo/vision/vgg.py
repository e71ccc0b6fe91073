"""VGG 11/13/16/19 and their BatchNorm variants (counterpart of
`mxnet_tpu/gluon/model_zoo/vision/vgg.py`; reference:
python/mxnet/gluon/model_zoo/vision/vgg.py), with the JAX net's block
structure and parameter names."""
from __future__ import annotations

import functools

from ... import nn
from ._common import _Net, _factory

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19", "vgg11_bn", "vgg13_bn",
           "vgg16_bn", "vgg19_bn", "get_vgg"]


class VGG(_Net):
    """``layers[i]`` 3x3 convolutions of ``filters[i]`` channels a stage
    (each followed by BatchNorm with ``batch_norm``, then ReLU), a 2x2 max
    pool after each stage, two Dense(4096) with Dropout(0.5) and the
    classifier (normal initialisation for the dense layers)."""

    def __init__(self, layers, filters, classes=1000, batch_norm=False,
                 in_channels=0, device=None, **kwargs):
        super().__init__(device=device, **kwargs)
        assert len(layers) == len(filters)
        with self.name_scope():
            self.features = self._make_features(layers, filters, batch_norm,
                                                in_channels)
            self.features.add(nn.Dense(4096, activation="relu",
                                       weight_initializer="normal"))
            self.features.add(nn.Dropout(rate=0.5))
            self.features.add(nn.Dense(4096, activation="relu",
                                       weight_initializer="normal"))
            self.features.add(nn.Dropout(rate=0.5))
            self.output = nn.Dense(classes, weight_initializer="normal")

    @staticmethod
    def _make_features(layers, filters, batch_norm, in_channels):
        featurizer = nn.HybridSequential(prefix="")
        for i, num in enumerate(layers):
            for _ in range(num):
                featurizer.add(nn.Conv2D(filters[i], kernel_size=3,
                                         padding=1, weight_initializer=None,
                                         in_channels=in_channels))
                in_channels = filters[i]
                if batch_norm:
                    featurizer.add(nn.BatchNorm())
                featurizer.add(nn.Activation("relu"))
            featurizer.add(nn.MaxPool2D(strides=2))
        return featurizer

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


vgg_spec = {11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
            13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
            16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
            19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512])}


def get_vgg(num_layers, pretrained=False, ctx=None, root=None, **kwargs):
    layers, filters = vgg_spec[num_layers]
    return _factory(functools.partial(VGG, layers, filters), pretrained, ctx,
                    kwargs)


def vgg11(**kwargs):
    return get_vgg(11, **kwargs)


def vgg13(**kwargs):
    return get_vgg(13, **kwargs)


def vgg16(**kwargs):
    return get_vgg(16, **kwargs)


def vgg19(**kwargs):
    return get_vgg(19, **kwargs)


def vgg11_bn(**kwargs):
    kwargs["batch_norm"] = True
    return get_vgg(11, **kwargs)


def vgg13_bn(**kwargs):
    kwargs["batch_norm"] = True
    return get_vgg(13, **kwargs)


def vgg16_bn(**kwargs):
    kwargs["batch_norm"] = True
    return get_vgg(16, **kwargs)


def vgg19_bn(**kwargs):
    kwargs["batch_norm"] = True
    return get_vgg(19, **kwargs)
