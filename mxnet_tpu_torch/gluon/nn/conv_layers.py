"""Convolution and pooling layers.

Counterpart of `mxnet_tpu/gluon/nn/conv_layers.py` (Conv1D/2D/3D,
Conv1D/2D/3DTranspose, MaxPool1D/2D/3D, AvgPool1D/2D/3D,
GlobalMaxPool1D/2D/3D, GlobalAvgPool1D/2D/3D, ReflectionPad2D and the
construction-time `layout_scope`) as `HybridBlock`s that compute on
tensors over `ops.nn`. Parameter shapes are the JAX package's: a
channels-last conv weight is (O, *k, I/g), a transposed conv's (I, *k,
O/g) and (I, O/g, *k) channels-first. ``in_channels`` left at 0 is taken
from the first input (deferred initialisation). Called with `Symbol`s,
each composes the JAX package's Convolution, Deconvolution, Pooling or Pad
op with its attributes (`HybridBlock.export`).
"""
from __future__ import annotations

import threading

from ...ops import nn as _ops
from .basic_layers import _Layer, _materialize

__all__ = ["layout_scope", "in_channels_last_scope", "Conv1D", "Conv2D",
           "Conv3D", "Conv1DTranspose", "Conv2DTranspose", "Conv3DTranspose",
           "MaxPool1D", "MaxPool2D", "MaxPool3D", "AvgPool1D", "AvgPool2D",
           "AvgPool3D", "GlobalMaxPool1D", "GlobalMaxPool2D",
           "GlobalMaxPool3D", "GlobalAvgPool1D", "GlobalAvgPool2D",
           "GlobalAvgPool3D", "ReflectionPad2D"]


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

_CHANNELS_LAST = {1: "NWC", 2: "NHWC", 3: "NDHWC"}
_CHANNELS_FIRST = {1: "NCW", 2: "NCHW", 3: "NCDHW"}


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


def _default_layout(explicit, nsp=2):
    if explicit is not None:
        return explicit
    return (_CHANNELS_LAST if in_channels_last_scope()
            else _CHANNELS_FIRST)[nsp]


class _Conv(_Layer):
    """Convolution (``op_name`` "Convolution") or transposed convolution
    ("Deconvolution") over ``len(kernel_size)`` spatial axes; optional bias
    (O,); ``activation`` (an `ops.nn.activation` type) on the output."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", op_name="Convolution", adj=None,
                 device=None, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._channels = channels
        self._layout = layout
        self._act_type = activation
        self._op_name = op_name
        self._ch_last = _ops._channels_last(layout)
        self._kwargs = {"kernel": kernel_size, "stride": strides,
                        "dilate": dilation, "pad": padding,
                        "num_group": groups, "layout": layout}
        if adj is not None:
            self._kwargs["adj"] = adj
        with self.name_scope():
            self._param("weight", device=device,
                        shape=self._wshape(in_channels),
                        init=weight_initializer, allow_deferred_init=True)
            if use_bias:
                self._param("bias", device=device, shape=(channels,),
                            init=bias_initializer, allow_deferred_init=True)
            else:
                self.register_parameter("bias", None)

    def _wshape(self, in_channels):
        k, g = self._kwargs["kernel"], self._kwargs["num_group"]
        if self._op_name == "Convolution":
            in_cg = in_channels // g
            return (self._channels,) + k + (in_cg,) if self._ch_last \
                else (self._channels, in_cg) + k
        return (in_channels,) + k + (self._channels // g,) \
            if self._ch_last else (in_channels, self._channels // g) + k

    def forward(self, x):
        if self._held("weight") is None:
            weight = self._reg_params["weight"]
            weight.shape = self._wshape(x.shape[-1 if self._ch_last else 1])
            _materialize(weight, self._reg_params.get("bias"))
        fn = _ops.convolution if self._op_name == "Convolution" \
            else _ops.deconvolution
        out = fn(x, self._held("weight"), self._held("bias"), **self._kwargs)
        if self._act_type is not None:
            out = _ops.activation(out, act_type=self._act_type)
        return out

    def hybrid_forward(self, F, x, weight, bias=None):
        out = getattr(F, self._op_name)(x, weight, bias,
                                        num_filter=self._channels,
                                        no_bias=bias is None, **self._kwargs)
        if self._act_type is not None:
            out = F.Activation(out, act_type=self._act_type)
        return out


def _conv_args(nsp, kernel_size, strides, padding, dilation):
    return (_pair(kernel_size, nsp), _pair(strides, nsp),
            _pair(padding, nsp), _pair(dilation, nsp))


class Conv1D(_Conv):
    """1-D convolution: weight (O, I/g, k), or (O, k, I/g) under NWC."""

    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout=None, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, *_conv_args(1, kernel_size, strides,
                                               padding, dilation), groups,
                         _default_layout(layout, 1), in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         **kwargs)


class Conv2D(_Conv):
    """2-D convolution: weight (O, I/g, kh, kw), or (O, kh, kw, I/g) under
    NHWC."""

    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout=None, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, *_conv_args(2, kernel_size, strides,
                                               padding, dilation), groups,
                         _default_layout(layout, 2), in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         **kwargs)


class Conv3D(_Conv):
    """3-D convolution: weight (O, I/g, kd, kh, kw), or (O, kd, kh, kw,
    I/g) under NDHWC."""

    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout=None, activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(channels, *_conv_args(3, kernel_size, strides,
                                               padding, dilation), groups,
                         _default_layout(layout, 3), in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         **kwargs)


class Conv1DTranspose(_Conv):
    """1-D transposed convolution: weight (I, O/g, k), or (I, k, O/g)
    under NWC; ``output_padding`` is the op's ``adj``."""

    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout=None,
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, *_conv_args(1, kernel_size, strides,
                                               padding, dilation), groups,
                         _default_layout(layout, 1), in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         op_name="Deconvolution",
                         adj=_pair(output_padding, 1), **kwargs)


class Conv2DTranspose(_Conv):
    """2-D transposed convolution: weight (I, O/g, kh, kw), or (I, kh, kw,
    O/g) under NHWC."""

    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), groups=1,
                 layout=None, activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(channels, *_conv_args(2, kernel_size, strides,
                                               padding, dilation), groups,
                         _default_layout(layout, 2), in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         op_name="Deconvolution",
                         adj=_pair(output_padding, 2), **kwargs)


class Conv3DTranspose(_Conv):
    """3-D transposed convolution: weight (I, O/g, kd, kh, kw), or (I, kd,
    kh, kw, O/g) under NDHWC."""

    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout=None, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, *_conv_args(3, kernel_size, strides,
                                               padding, dilation), groups,
                         _default_layout(layout, 3), in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         op_name="Deconvolution",
                         adj=_pair(output_padding, 3), **kwargs)


class _Pooling(_Layer):
    """`ops.nn.pooling` with the JAX layer's attributes: ``ceil_mode`` is
    the "full" convention, ``strides`` default to the window."""

    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, count_include_pad=None, layout=None, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._kwargs = {
            "kernel": pool_size,
            "stride": pool_size if strides is None else strides,
            "pad": padding, "global_pool": global_pool,
            "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid",
            "layout": layout}
        if count_include_pad is not None:
            self._kwargs["count_include_pad"] = count_include_pad

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self._kwargs)


def _window(nsp, pool_size, strides, padding):
    return (_pair(pool_size, nsp),
            None if strides is None else _pair(strides, nsp),
            _pair(padding, nsp))


class MaxPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout=None,
                 ceil_mode=False, **kwargs):
        super().__init__(*_window(1, pool_size, strides, padding), ceil_mode,
                         False, "max", layout=_default_layout(layout, 1),
                         **kwargs)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout=None, ceil_mode=False, **kwargs):
        super().__init__(*_window(2, pool_size, strides, padding), ceil_mode,
                         False, "max", layout=_default_layout(layout, 2),
                         **kwargs)


class MaxPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout=None, ceil_mode=False, **kwargs):
        super().__init__(*_window(3, pool_size, strides, padding), ceil_mode,
                         False, "max", layout=_default_layout(layout, 3),
                         **kwargs)


class AvgPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout=None,
                 ceil_mode=False, count_include_pad=True, **kwargs):
        super().__init__(*_window(1, pool_size, strides, padding), ceil_mode,
                         False, "avg", count_include_pad,
                         layout=_default_layout(layout, 1), **kwargs)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout=None, ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(*_window(2, pool_size, strides, padding), ceil_mode,
                         False, "avg", count_include_pad,
                         layout=_default_layout(layout, 2), **kwargs)


class AvgPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout=None, ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(*_window(3, pool_size, strides, padding), ceil_mode,
                         False, "avg", count_include_pad,
                         layout=_default_layout(layout, 3), **kwargs)


def _global(nsp, pool_type):
    class _Global(_Pooling):
        def __init__(self, layout=None, **kwargs):
            super().__init__((1,) * nsp, None, (0,) * nsp, True, True,
                             pool_type, layout=_default_layout(layout, nsp),
                             **kwargs)

    return _Global


class GlobalMaxPool1D(_global(1, "max")):
    """Max over the spatial extent, kept as size 1."""


class GlobalMaxPool2D(_global(2, "max")):
    """Max over the spatial extent, kept as 1 x 1."""


class GlobalMaxPool3D(_global(3, "max")):
    """Max over the spatial extent, kept as 1 x 1 x 1."""


class GlobalAvgPool1D(_global(1, "avg")):
    """Mean over the spatial extent (in f32), kept as size 1."""


class GlobalAvgPool2D(_global(2, "avg")):
    """Mean over the spatial extent (in f32), kept as 1 x 1."""


class GlobalAvgPool3D(_global(3, "avg")):
    """Mean over the spatial extent (in f32), kept as 1 x 1 x 1."""


class ReflectionPad2D(_Layer):
    """Reflection padding of the two trailing axes: ``padding`` an int (the
    same on every side of H and W) or the Pad op's 8-entry ``pad_width``."""

    def __init__(self, padding=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if isinstance(padding, int):
            padding = (0, 0, 0, 0, padding, padding, padding, padding)
        self._padding = tuple(padding)

    def hybrid_forward(self, F, x):
        return F.Pad(x, mode="reflect", pad_width=self._padding)
