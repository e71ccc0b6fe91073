"""Convolution and pooling layers.

Counterpart of `mxnet_tpu/gluon/nn/conv_layers.py` (Conv2D, MaxPool2D,
GlobalAvgPool2D and the construction-time `layout_scope`) as
`torch.nn.Module`s over `ops.nn`. Parameter shapes are the JAX package's:
a channels-last conv weight is (O, kh, kw, I). The port does not defer a
shape to the first forward: ``in_channels`` is required.
"""
from __future__ import annotations

import threading

import torch
from torch import nn

from ...base import MXNetError
from ...ops import nn as _ops

__all__ = ["layout_scope", "in_channels_last_scope", "Conv2D", "MaxPool2D",
           "GlobalAvgPool2D"]


def _pair(x, n):
    if isinstance(x, (list, tuple)):
        return tuple(int(i) for i in x)
    return (int(x),) * n


# ---------------------------------------------------------------------------
# construction-time default-layout scope: `with layout_scope(): net =
# resnet50_v1(...)` makes conv and pool layers default to channels-last
# (and BatchNorm's default axis to -1) while they are constructed. An
# explicit layout= / axis= argument always wins.
# ---------------------------------------------------------------------------

_LAYOUT_SCOPE = threading.local()


class layout_scope:
    def __init__(self, channels_last=True):
        self._want = channels_last

    def __enter__(self):
        self._prev = getattr(_LAYOUT_SCOPE, "channels_last", False)
        _LAYOUT_SCOPE.channels_last = self._want
        return self

    def __exit__(self, *exc):
        _LAYOUT_SCOPE.channels_last = self._prev
        return False


def in_channels_last_scope():
    return getattr(_LAYOUT_SCOPE, "channels_last", False)


def _default_layout(explicit):
    if explicit is not None:
        return explicit
    return "NHWC" if in_channels_last_scope() else "NCHW"


class Conv2D(nn.Module):
    """2-D convolution. Weight (O, kh, kw, I/groups) under a channels-last
    layout, (O, I/groups, kh, kw) otherwise; optional bias (O,)."""

    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout=None, use_bias=True,
                 in_channels=0, device=None):
        super().__init__()
        if not in_channels:
            raise MXNetError("Conv2D: in_channels must be given (the port "
                             "does not infer shapes at the first forward)")
        self._layout = _default_layout(layout)
        k = _pair(kernel_size, 2)
        self._kwargs = {"kernel": k, "stride": _pair(strides, 2),
                        "dilate": _pair(dilation, 2),
                        "pad": _pair(padding, 2), "num_group": groups,
                        "layout": self._layout}
        in_cg = in_channels // groups
        wshape = ((channels,) + k + (in_cg,)
                  if _ops._channels_last(self._layout)
                  else (channels, in_cg) + k)
        self.weight = nn.Parameter(torch.zeros(wshape, device=device))
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(channels, device=device))
        else:
            self.register_parameter("bias", None)

    def forward(self, x):
        return _ops.convolution(x, self.weight, self.bias, **self._kwargs)


class MaxPool2D(nn.Module):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout=None, ceil_mode=False):
        super().__init__()
        k = _pair(pool_size, 2)
        self._kwargs = {"kernel": k,
                        "stride": k if strides is None else _pair(strides, 2),
                        "pad": _pair(padding, 2), "pool_type": "max",
                        "pooling_convention": "full" if ceil_mode
                        else "valid",
                        "layout": _default_layout(layout)}

    def forward(self, x):
        return _ops.pooling(x, **self._kwargs)


class GlobalAvgPool2D(nn.Module):
    """Mean over the spatial extent, kept as 1 x 1."""

    def __init__(self, layout=None):
        super().__init__()
        self._layout = _default_layout(layout)

    def forward(self, x):
        return _ops.pooling(x, pool_type="avg", global_pool=True,
                            layout=self._layout)
