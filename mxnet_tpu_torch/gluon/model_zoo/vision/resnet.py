"""ResNet v1 and v2 (counterpart of
`mxnet_tpu/gluon/model_zoo/vision/resnet.py`: `ResNetV1`, `BasicBlockV1`,
`BottleneckV1`, `ResNetV2`, `BasicBlockV2`, `BottleneckV2` and
`resnet18_v1` ... `resnet152_v2` as `HybridBlock`s; `get_resnet`).

Both versions are built as the JAX package builds them (the `HybridBlock`
tree with the JAX prefixes), so their parameter names are the JAX net's
and their ``.params`` files and export are the JAX package's. Build under
`gluon.nn.layout_scope()` for the channels-last layout: inputs (N, H, W,
C), conv weights (O, kh, kw, I). ``device``: where `initialize` puts the
parameters (`_Net`; default `current_context`); a v1 net given one makes
its parameters there at construction.

``fuse_epilogue`` (default: ``MXTPU_PALLAS_CONV_EPILOGUE`` set and not
"0", as in the JAX package) builds every BN -> ReLU as one
``BatchNorm(act_type="relu")`` and each v1 block's tail as BN + add + ReLU;
the reference graph holds each ReLU as a paramless ``Activation`` child, as
the JAX package does. The parameter names are the same in both graphs; the
module paths (``state_dict`` keys, `convert.resnet_params_from_jax`) count
the ``Activation`` children. Either graph runs training-mode BatchNorm
through the conv-epilogue kernels on the card.

ResNet v2 is pre-activation: BN -> ReLU before each convolution, one BN ->
ReLU after the last stage, and a first BatchNorm of the input image
without gamma or beta (``scale=False, center=False``). The space-to-depth
stem (``stem_s2d``) is not ported yet (ROADMAP queue 1 item 9).
"""
from __future__ import annotations

import functools

from .... import env as _env
from ... import nn
from ...nn.basic_layers import _Layer
from ._common import _Net, _factory

__all__ = ["ResNetV1", "ResNetV2", "BasicBlockV1", "BasicBlockV2",
           "BottleneckV1", "BottleneckV2", "resnet18_v1", "resnet34_v1",
           "resnet50_v1", "resnet101_v1", "resnet152_v1", "resnet18_v2",
           "resnet34_v2", "resnet50_v2", "resnet101_v2", "resnet152_v2",
           "get_resnet"]


def _fuse_epilogue_default(flag):
    """An explicit flag wins; else set-and-not-"0" in
    MXTPU_PALLAS_CONV_EPILOGUE builds the fused graph."""
    if flag is not None:
        return bool(flag)
    return _env.get("MXTPU_PALLAS_CONV_EPILOGUE") not in ("", "0")


def _conv3x3(channels, stride, in_channels, device=None):
    return nn.Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                     use_bias=False, in_channels=in_channels, device=device)


def _bn_relu(seq, fused, channels, device):
    """Add a BatchNorm followed by a ReLU to ``seq``: one BatchNorm carrying
    the ReLU when ``fused``, else a BatchNorm and an ``Activation``."""
    seq.add(nn.BatchNorm(act_type="relu" if fused else None,
                         in_channels=channels, device=device))
    if not fused:
        seq.add(nn.Activation("relu"))


def _bn_tail(fused, channels, device):
    """A block's last BatchNorm: BN + add + ReLU when ``fused``."""
    return nn.BatchNorm(act_type="relu" if fused else None,
                        in_channels=channels, device=device)


class _BlockV1(_Layer):
    """Shared forward of the v1 blocks. The body is conv, BN, ReLU, conv,
    BN (, ReLU, conv, BN). Fused graph: each BN but the last carries the
    ReLU, and the last takes the residual as its second input (BN + add +
    ReLU). Reference graph: ``relu(body(x) + residual)``."""

    def _add_downsample(self, downsample, channels, stride, in_channels,
                        device):
        if downsample:
            self.downsample = nn.HybridSequential(prefix="")
            self.downsample.add(nn.Conv2D(channels, kernel_size=1,
                                          strides=stride, use_bias=False,
                                          in_channels=in_channels,
                                          device=device))
            self.downsample.add(nn.BatchNorm(in_channels=channels,
                                             device=device))
        else:
            self.downsample = None

    def hybrid_forward(self, F, x):
        residual = x if self.downsample is None else self.downsample(x)
        if not self._fused:
            return F.Activation(self.body(x) + residual, act_type="relu")
        layers = list(self.body._children.values())
        out = x
        for layer in layers[:-1]:
            out = layer(out)
        return layers[-1](out, residual)


class BasicBlockV1(_BlockV1):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 fuse_epilogue=False, device=None, **kwargs):
        super().__init__(**kwargs)
        self._fused = fuse_epilogue
        self.body = nn.HybridSequential(prefix="")
        self.body.add(_conv3x3(channels, stride, in_channels, device))
        _bn_relu(self.body, fuse_epilogue, channels, device)
        self.body.add(_conv3x3(channels, 1, channels, device))
        self.body.add(_bn_tail(fuse_epilogue, channels, device))
        self._add_downsample(downsample, channels, stride, in_channels,
                             device)


class BottleneckV1(_BlockV1):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 fuse_epilogue=False, device=None, **kwargs):
        super().__init__(**kwargs)
        self._fused = fuse_epilogue
        mid = channels // 4
        self.body = nn.HybridSequential(prefix="")
        self.body.add(nn.Conv2D(mid, kernel_size=1, strides=stride,
                                use_bias=False, in_channels=in_channels,
                                device=device))
        _bn_relu(self.body, fuse_epilogue, mid, device)
        self.body.add(_conv3x3(mid, 1, mid, device))
        _bn_relu(self.body, fuse_epilogue, mid, device)
        self.body.add(nn.Conv2D(channels, kernel_size=1, strides=1,
                                use_bias=False, in_channels=mid,
                                device=device))
        self.body.add(_bn_tail(fuse_epilogue, channels, device))
        self._add_downsample(downsample, channels, stride, in_channels,
                             device)


class ResNetV1(_Net):
    """ResNet v1: stem (7x7/2 conv, BN, ReLU, 3x3/2 max pool; a 3x3/1 conv
    alone when ``thumbnail``), ``len(layers)`` stages, global average pool,
    dense classifier. ``channels[0]`` is the stem width, ``channels[i+1]``
    stage i's; ``in_channels`` the image's. Every width is known at
    construction, so a net given a ``device`` makes its parameters there
    then (`_Net` otherwise)."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, fuse_epilogue=None, in_channels=3,
                 device=None, **kwargs):
        super().__init__(device=device, **kwargs)
        assert len(layers) == len(channels) - 1
        device = self._device
        fuse_epilogue = _fuse_epilogue_default(fuse_epilogue)
        self._fuse_epilogue = fuse_epilogue
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            if thumbnail:
                self.features.add(_conv3x3(channels[0], 1, in_channels,
                                           device))
            else:
                self.features.add(nn.Conv2D(channels[0], 7, 2, 3,
                                            use_bias=False,
                                            in_channels=in_channels,
                                            device=device))
                _bn_relu(self.features, fuse_epilogue, channels[0], device)
                self.features.add(nn.MaxPool2D(3, 2, 1))
            for i, num_layer in enumerate(layers):
                stride = 1 if i == 0 else 2
                self.features.add(self._make_layer(
                    block, num_layer, channels[i + 1], stride, i + 1,
                    channels[i], fuse_epilogue, device))
            self.features.add(nn.GlobalAvgPool2D())
            self.output = nn.Dense(classes, in_units=channels[-1],
                                   device=device)

    @staticmethod
    def _make_layer(block, layers, channels, stride, stage_index,
                    in_channels, fuse_epilogue, device):
        layer = nn.HybridSequential(prefix="stage%d_" % stage_index)
        with layer.name_scope():
            layer.add(block(channels, stride, channels != in_channels,
                            in_channels=in_channels,
                            fuse_epilogue=fuse_epilogue, device=device,
                            prefix=""))
            for _ in range(layers - 1):
                layer.add(block(channels, 1, False, in_channels=channels,
                                fuse_epilogue=fuse_epilogue, device=device,
                                prefix=""))
        return layer

    def initialize(self, init="xavier", ctx=None, verbose=False,
                   force_reinit=False, seed=None):
        """Fill the weights (default Xavier, as the training script), BN
        gamma 1 / beta 0, running mean 0 / var 1, biases 0 (`_Net`). Returns
        self."""
        return super().initialize(init, ctx, verbose, force_reinit, seed)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


class BasicBlockV2(_Layer):
    """BN, ReLU, 3x3 conv (stride), BN, ReLU, 3x3 conv, plus the input (or
    its 1x1 projection of the first BN -> ReLU when ``downsample``). Under
    ``fuse_epilogue`` each BN carries its ReLU."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 fuse_epilogue=False, **kwargs):
        super().__init__(**kwargs)
        self._fused = fuse_epilogue
        self.bn1 = _bn_v2(fuse_epilogue)
        self.conv1 = _conv3x3(channels, stride, in_channels, None)
        self.bn2 = _bn_v2(fuse_epilogue)
        self.conv2 = _conv3x3(channels, 1, channels, None)
        self.downsample = nn.Conv2D(channels, 1, stride, use_bias=False,
                                    in_channels=in_channels) \
            if downsample else None

    def hybrid_forward(self, F, x):
        residual = x
        out = _act_v2(F, self.bn1(x), self._fused)
        if self.downsample is not None:
            residual = self.downsample(out)
        out = self.conv1(out)
        out = _act_v2(F, self.bn2(out), self._fused)
        return self.conv2(out) + residual


class BottleneckV2(_Layer):
    """BN, ReLU, 1x1 conv to ``channels // 4``, BN, ReLU, 3x3 conv
    (stride), BN, ReLU, 1x1 conv to ``channels``, plus the input (or its
    projection, as in `BasicBlockV2`)."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 fuse_epilogue=False, **kwargs):
        super().__init__(**kwargs)
        self._fused = fuse_epilogue
        self.bn1 = _bn_v2(fuse_epilogue)
        self.conv1 = nn.Conv2D(channels // 4, kernel_size=1, strides=1,
                               use_bias=False)
        self.bn2 = _bn_v2(fuse_epilogue)
        self.conv2 = _conv3x3(channels // 4, stride, channels // 4, None)
        self.bn3 = _bn_v2(fuse_epilogue)
        self.conv3 = nn.Conv2D(channels, kernel_size=1, strides=1,
                               use_bias=False)
        self.downsample = nn.Conv2D(channels, 1, stride, use_bias=False,
                                    in_channels=in_channels) \
            if downsample else None

    def hybrid_forward(self, F, x):
        residual = x
        out = _act_v2(F, self.bn1(x), self._fused)
        if self.downsample is not None:
            residual = self.downsample(out)
        out = self.conv1(out)
        out = _act_v2(F, self.bn2(out), self._fused)
        out = self.conv2(out)
        out = _act_v2(F, self.bn3(out), self._fused)
        return self.conv3(out) + residual


def _bn_v2(fused):
    """A v2 BatchNorm of a deferred width, carrying the ReLU when
    ``fused``."""
    return nn.BatchNorm(act_type="relu" if fused else None)


def _act_v2(F, x, fused):
    return x if fused else F.Activation(x, act_type="relu")


class ResNetV2(_Net):
    """ResNet v2: BatchNorm of the input (no gamma, no beta), the stem
    (7x7/2 conv, BN, ReLU, 3x3/2 max pool; a 3x3/1 conv alone when
    ``thumbnail``), ``len(layers)`` stages of pre-activation blocks, BN,
    ReLU, global average pool, Flatten, the classifier. ``in_channels``
    sizes the input BatchNorm and the stem (0: from the first input);
    ``device`` as `_Net`."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, fuse_epilogue=None, in_channels=0,
                 device=None, **kwargs):
        super().__init__(device=device, **kwargs)
        assert len(layers) == len(channels) - 1
        fuse_epilogue = _fuse_epilogue_default(fuse_epilogue)
        self._fuse_epilogue = fuse_epilogue
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(nn.BatchNorm(scale=False, center=False,
                                           in_channels=in_channels))
            if thumbnail:
                self.features.add(_conv3x3(channels[0], 1, in_channels,
                                           None))
            else:
                self.features.add(nn.Conv2D(channels[0], 7, 2, 3,
                                            use_bias=False,
                                            in_channels=in_channels))
                self.features.add(_bn_v2(fuse_epilogue))
                if not fuse_epilogue:
                    self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(3, 2, 1))
            in_channels = channels[0]
            for i, num_layer in enumerate(layers):
                stride = 1 if i == 0 else 2
                self.features.add(self._make_layer(
                    block, num_layer, channels[i + 1], stride, i + 1,
                    in_channels, fuse_epilogue))
                in_channels = channels[i + 1]
            self.features.add(_bn_v2(fuse_epilogue))
            if not fuse_epilogue:
                self.features.add(nn.Activation("relu"))
            self.features.add(nn.GlobalAvgPool2D())
            self.features.add(nn.Flatten())
            self.output = nn.Dense(classes, in_units=in_channels)

    @staticmethod
    def _make_layer(block, layers, channels, stride, stage_index,
                    in_channels, fuse_epilogue):
        layer = nn.HybridSequential(prefix="stage%d_" % stage_index)
        with layer.name_scope():
            layer.add(block(channels, stride, channels != in_channels,
                            in_channels=in_channels,
                            fuse_epilogue=fuse_epilogue, prefix=""))
            for _ in range(layers - 1):
                layer.add(block(channels, 1, False, in_channels=channels,
                                fuse_epilogue=fuse_epilogue, prefix=""))
        return layer

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


resnet_spec = {18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
               34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
               50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
               101: ("bottle_neck", [3, 4, 23, 3],
                     [64, 256, 512, 1024, 2048]),
               152: ("bottle_neck", [3, 8, 36, 3],
                     [64, 256, 512, 1024, 2048])}

_NETS = {1: ResNetV1, 2: ResNetV2}
_BLOCKS = {1: {"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1},
           2: {"basic_block": BasicBlockV2, "bottle_neck": BottleneckV2}}


def get_resnet(version, num_layers, pretrained=False, ctx=None, root=None,
               **kwargs):
    """ResNet ``version`` 1 or 2 of ``num_layers`` (18, 34, 50, 101,
    152), built for ``ctx`` (or ``device``)."""
    if num_layers not in resnet_spec:
        raise ValueError("Invalid resnet depth %d; options: %s"
                         % (num_layers, sorted(resnet_spec)))
    if version not in _NETS:
        raise ValueError("Invalid resnet version %r; options: 1, 2"
                         % (version,))
    block_type, layers, channels = resnet_spec[num_layers]
    return _factory(functools.partial(_NETS[version],
                                      _BLOCKS[version][block_type], layers,
                                      channels), pretrained, ctx, kwargs)


def resnet18_v1(**kwargs):
    return get_resnet(1, 18, **kwargs)


def resnet34_v1(**kwargs):
    return get_resnet(1, 34, **kwargs)


def resnet50_v1(**kwargs):
    return get_resnet(1, 50, **kwargs)


def resnet101_v1(**kwargs):
    return get_resnet(1, 101, **kwargs)


def resnet152_v1(**kwargs):
    return get_resnet(1, 152, **kwargs)


def resnet18_v2(**kwargs):
    return get_resnet(2, 18, **kwargs)


def resnet34_v2(**kwargs):
    return get_resnet(2, 34, **kwargs)


def resnet50_v2(**kwargs):
    return get_resnet(2, 50, **kwargs)


def resnet101_v2(**kwargs):
    return get_resnet(2, 101, **kwargs)


def resnet152_v2(**kwargs):
    return get_resnet(2, 152, **kwargs)
