"""Convolution and pooling layers.

Counterpart of `mxnet_tpu/gluon/nn/conv_layers.py` (Conv2D, MaxPool2D,
GlobalAvgPool2D and the construction-time `layout_scope`) as
`HybridBlock`s that compute on tensors over `ops.nn`. Parameter shapes are
the JAX package's: a channels-last conv weight is (O, kh, kw, I).
``in_channels`` left at 0 is taken from the first input (deferred
initialisation). Called with `Symbol`s, each composes the JAX package's
Convolution or Pooling op (`HybridBlock.export`).
"""
from __future__ import annotations

import threading

from ...ops import nn as _ops
from .basic_layers import _Layer, _materialize

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


class Conv2D(_Layer):
    """2-D convolution. Weight (O, kh, kw, I/groups) under a channels-last
    layout, (O, I/groups, kh, kw) otherwise; optional bias (O,);
    ``activation`` (an `ops.nn.activation` type) on the output."""

    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout=None, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, device=None,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._layout = _default_layout(layout)
        self._act_type = activation
        k = _pair(kernel_size, 2)
        self._kwargs = {"kernel": k, "stride": _pair(strides, 2),
                        "dilate": _pair(dilation, 2),
                        "pad": _pair(padding, 2), "num_group": groups,
                        "layout": self._layout}
        self._ch_last = _ops._channels_last(self._layout)
        self._channels = channels
        with self.name_scope():
            self._param("weight", device=device,
                        shape=self._wshape(in_channels // groups),
                        init=weight_initializer, allow_deferred_init=True)
            if use_bias:
                self._param("bias", device=device, shape=(channels,),
                            init=bias_initializer, allow_deferred_init=True)
            else:
                self.register_parameter("bias", None)

    def _wshape(self, in_cg):
        k = self._kwargs["kernel"]
        return (self._channels,) + k + (in_cg,) if self._ch_last \
            else (self._channels, in_cg) + k

    def forward(self, x):
        if self.weight is None:
            c = x.shape[-1 if self._ch_last else 1]
            weight = self._reg_params["weight"]
            weight.shape = self._wshape(c // self._kwargs["num_group"])
            _materialize(weight, self._reg_params.get("bias"))
        out = _ops.convolution(x, self.weight, self.bias, **self._kwargs)
        if self._act_type is not None:
            out = _ops.activation(out, act_type=self._act_type)
        return out

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.Convolution(x, weight, bias, num_filter=self._channels,
                            no_bias=bias is None, **self._kwargs)
        if self._act_type is not None:
            out = F.Activation(out, act_type=self._act_type)
        return out


class MaxPool2D(_Layer):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout=None, ceil_mode=False, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        k = _pair(pool_size, 2)
        self._kwargs = {"kernel": k,
                        "stride": k if strides is None else _pair(strides, 2),
                        "pad": _pair(padding, 2), "pool_type": "max",
                        "pooling_convention": "full" if ceil_mode
                        else "valid",
                        "layout": _default_layout(layout)}

    def forward(self, x):
        return _ops.pooling(x, **self._kwargs)

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self._kwargs)


class GlobalAvgPool2D(_Layer):
    """Mean over the spatial extent, kept as 1 x 1."""

    def __init__(self, layout=None, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._layout = _default_layout(layout)

    def forward(self, x):
        return _ops.pooling(x, pool_type="avg", global_pool=True,
                            layout=self._layout)

    def hybrid_forward(self, F, x):
        return F.Pooling(x, kernel=(1, 1), pool_type="avg", global_pool=True,
                         layout=self._layout)
