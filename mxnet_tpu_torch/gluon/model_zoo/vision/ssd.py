"""The SSD detection family (counterpart of
`mxnet_tpu/gluon/model_zoo/vision/ssd.py`; reference:
example/ssd/symbol/symbol_builder.py, symbol/common.py, configs from
symbol/symbol_factory.py): `SSD` over a cut backbone and an extra feature
pyramid, `SSDMultiBoxLoss`, `get_ssd` and the factories
``ssd_512_resnet50_v1``, ``ssd_300_resnet50_v1``, ``ssd_512_mobilenet1_0``
and ``ssd_test_tiny``.

Built as the JAX package builds them, so the parameter names are the JAX
net's: the backbone's under the ResNet's (or MobileNet's) own prefix
(``resnetv10_conv2d0_weight``), the rest under the SSD's
(``ssd0__extrafeature0_conv2d0_weight``, ``ssd0_conv2d11_bias``).
Channels-first only (the heads' reshapes and ``MultiBoxPrior``'s H and W
read NCHW). Every BatchNorm of a training forward runs the conv-epilogue
kernels on the card over its channels moved last (`ops.nn._bn_act`: a
copy only where the tensor is not channels-last in memory; the kernels'
output is, so later layers' mostly are); the detection ops are
`ops.contrib`'s.

The ResNet base is cut by role: the stem through stage 3 (stride 16), then
stage 4 (stride 32). The JAX package cuts at child index 7, which assumes
the reference graph's stem of four children; its fused graph
(``MXTPU_PALLAS_CONV_EPILOGUE``) has three, so there the cut falls after
stage 4 (ROADMAP, "Not queued"). In the reference graph both cuts are the
same. ``fuse_epilogue`` (the port's; default from the environment, as
`get_resnet`) picks the ResNet base's graph; ``device`` is where
`initialize` puts the parameters.
"""
from __future__ import annotations

import torch

from ....base import MXNetError
from ....ndarray import NDArray
from ... import nn
from ...loss import Loss
from ...nn.basic_layers import _TENSOR_F, _Layer
from ._common import _Net

__all__ = ["SSD", "SSDMultiBoxLoss", "get_ssd", "ssd_512_resnet50_v1",
           "ssd_300_resnet50_v1", "ssd_512_mobilenet1_0", "ssd_test_tiny"]

# per-(network, data_shape) anchor configs (reference: symbol_factory.py
# get_config)
_SIZES_512 = [[.1, .141], [.2, .272], [.37, .447], [.54, .619],
              [.71, .79], [.88, .961]]
_SIZES_300 = [[.1, .141], [.2, .272], [.37, .447], [.54, .619],
              [.71, .79], [.88, .961]]
_RATIOS_6 = [[1, 2, .5], [1, 2, .5, 3, 1. / 3], [1, 2, .5, 3, 1. / 3],
             [1, 2, .5, 3, 1. / 3], [1, 2, .5, 3, 1. / 3], [1, 2, .5]]


def _ops(x):
    """The op namespace for ``x``: `nd` for an NDArray, the registered ops
    on tensors for a tensor."""
    if isinstance(x, NDArray):
        from .... import ndarray as nd

        return nd
    return _TENSOR_F


class _ExtraFeature(_Layer):
    """One extra downsampling block: a 1x1 channel reduction, then a 3x3
    stride-2 convolution, each followed by BatchNorm and ReLU (reference:
    symbol/common.py multi_layer_feature)."""

    def __init__(self, num_filters, min_filter=128, stride=2, padding=1,
                 **kwargs):
        super().__init__(**kwargs)
        reduced = max(num_filters // 2, min_filter)
        with self.name_scope():
            self.body = nn.HybridSequential(prefix="")
            self.body.add(nn.Conv2D(reduced, kernel_size=1, use_bias=False))
            self.body.add(nn.BatchNorm())
            self.body.add(nn.Activation("relu"))
            self.body.add(nn.Conv2D(num_filters, kernel_size=3,
                                    strides=stride, padding=padding,
                                    use_bias=False))
            self.body.add(nn.BatchNorm())
            self.body.add(nn.Activation("relu"))

    def hybrid_forward(self, F, x):
        return self.body(x)


class SSD(_Net):
    """Single-shot detector over backbone stages and an extra feature
    pyramid: ``forward(x) -> (cls_preds (B, A, C+1), loc_preds (B, 4A),
    anchors (1, A, 4))``, the layouts `training_targets` and `detections`
    take."""

    def __init__(self, num_classes, base_blocks, num_extras=4,
                 extra_filters=(512, 256, 256, 128), sizes=None, ratios=None,
                 anchor_clip=False, device=None, **kwargs):
        super().__init__(device=device, **kwargs)
        if nn.in_channels_last_scope():
            raise ValueError(
                "SSD does not support channels-last layout_scope; build it "
                "outside the scope (its heads assume NCHW)")
        nscales = len(base_blocks) + num_extras
        sizes = sizes if sizes is not None else _SIZES_512[:nscales]
        ratios = ratios if ratios is not None else _RATIOS_6[:nscales]
        if not len(sizes) == len(ratios) == nscales:
            raise MXNetError("sizes/ratios must have one entry per scale "
                             "(%d base + %d extra)" % (len(base_blocks),
                                                       num_extras))
        self.num_classes = num_classes
        self._sizes = [tuple(s) for s in sizes]
        self._ratios = [tuple(r) for r in ratios]
        self._anchor_clip = anchor_clip
        with self.name_scope():
            self.base_stages = nn.HybridSequential(prefix="base_")
            for b in base_blocks:
                self.base_stages.add(b)
            self.extras = nn.HybridSequential(prefix="extra_")
            for f in extra_filters[:num_extras]:
                self.extras.add(_ExtraFeature(f))
            self.class_preds = nn.HybridSequential(prefix="cls_pred_")
            self.box_preds = nn.HybridSequential(prefix="box_pred_")
            for s, r in zip(self._sizes, self._ratios):
                na = len(s) + len(r) - 1
                self.class_preds.add(nn.Conv2D(na * (num_classes + 1),
                                               kernel_size=3, padding=1))
                self.box_preds.add(nn.Conv2D(na * 4, kernel_size=3,
                                             padding=1))

    def hybrid_forward(self, F, x):
        feats = []
        for stage in self.base_stages._children.values():
            x = stage(x)
            feats.append(x)
        for extra in self.extras._children.values():
            x = extra(x)
            feats.append(x)
        cls_list, loc_list, anchor_list = [], [], []
        for feat, cp, bp, s, r in zip(feats,
                                      self.class_preds._children.values(),
                                      self.box_preds._children.values(),
                                      self._sizes, self._ratios):
            cls = F.transpose(cp(feat), (0, 2, 3, 1))
            cls_list.append(F.reshape(cls, (0, -1, self.num_classes + 1)))
            loc = F.transpose(bp(feat), (0, 2, 3, 1))
            loc_list.append(F.reshape(loc, (0, -1)))
            anchor_list.append(F.contrib.MultiBoxPrior(
                feat, sizes=s, ratios=r, clip=self._anchor_clip))
        return (F.concat(*cls_list, dim=1), F.concat(*loc_list, dim=1),
                F.concat(*anchor_list, dim=1))

    def training_targets(self, anchors, cls_preds, labels,
                         overlap_threshold=0.5, negative_mining_ratio=3,
                         negative_mining_thresh=0.5,
                         variances=(0.1, 0.1, 0.2, 0.2)):
        """Anchor matching and encoding of one batch (``MultiBoxTarget``):
        ``labels`` (B, M, 5) rows ``[cls, x1, y1, x2, y2]``, cls -1 pads ->
        ``(cls_target (B, A), loc_target (B, 4A), loc_mask (B, 4A))``.
        NDArrays in, NDArrays out; tensors in, tensors out."""
        F = _ops(cls_preds)
        loc_target, loc_mask, cls_target = F.contrib.MultiBoxTarget(
            anchors, labels, F.transpose(cls_preds, (0, 2, 1)),
            overlap_threshold=overlap_threshold, ignore_label=-1,
            negative_mining_ratio=negative_mining_ratio,
            negative_mining_thresh=negative_mining_thresh,
            variances=variances)
        return cls_target, loc_target, loc_mask

    def detections(self, cls_preds, loc_preds, anchors, nms_thresh=0.45,
                   nms_topk=400, threshold=0.01, force_suppress=False,
                   variances=(0.1, 0.1, 0.2, 0.2)):
        """Decode and NMS (``MultiBoxDetection``): (B, A, 6) rows ``[cls_id,
        score, x1, y1, x2, y2]``, id -1 for a suppressed or invalid row."""
        F = _ops(cls_preds)
        cls_prob = F.softmax(F.transpose(cls_preds, (0, 2, 1)), axis=1)
        return F.contrib.MultiBoxDetection(
            cls_prob, loc_preds, anchors, nms_threshold=nms_thresh,
            nms_topk=nms_topk, threshold=threshold,
            force_suppress=force_suppress, variances=variances)


class SSDMultiBoxLoss(Loss):
    """The classification and localization loss of SSD training
    (reference: symbol_builder.py get_symbol_train): cross entropy over the
    anchors whose target is not -1, divided by their count, plus ``lambd``
    x smooth L1 of ``loc_mask (loc_preds - loc_target)``, divided by the
    mask's sum. ``negative_mining_ratio`` is taken and unused: the mining
    is `SSD.training_targets`'."""

    def __init__(self, negative_mining_ratio=3, lambd=1.0, weight=None,
                 batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._lambd = lambd

    def forward(self, cls_preds, loc_preds, cls_target, loc_target,
                loc_mask):
        lp = torch.log_softmax(cls_preds, dim=-1)
        valid = cls_target >= 0
        tgt = torch.clamp(cls_target, min=0.0).long()
        ce = -torch.gather(lp, -1, tgt[..., None])[..., 0]
        n_valid = torch.clamp(valid.to(lp.dtype).sum(), min=1.0)
        cls_loss = torch.where(valid, ce, torch.zeros_like(ce)).sum() \
            / n_valid
        sl1 = _TENSOR_F.smooth_l1(loc_mask * (loc_preds - loc_target),
                                  scalar=1.0)
        loc_loss = sl1.sum() / torch.clamp(loc_mask.sum(), min=1.0)
        return cls_loss + self._lambd * loc_loss


def _resnet_base(version, num_layers, fuse_epilogue=None, **kwargs):
    """The SSD backbone stages of a ResNet: [stem through stage 3] (stride
    16) and [stage 4] (stride 32), the reference's cut points for resnet50
    (symbol_factory.py get_config), found by the stages' prefixes."""
    from .resnet import get_resnet

    net = get_resnet(version, num_layers, fuse_epilogue=fuse_epilogue,
                     **kwargs)
    children = list(net.features._children.values())
    at = {c.prefix.rsplit("_", 2)[-2]: i for i, c in enumerate(children)
          if c.prefix.endswith(("stage3_", "stage4_"))}
    stem_through_stage3 = nn.HybridSequential(prefix="")
    for c in children[:at["stage3"] + 1]:
        stem_through_stage3.add(c)
    stage4 = nn.HybridSequential(prefix="")
    stage4.add(children[at["stage4"]])
    return [stem_through_stage3, stage4]


def _mobilenet_base(multiplier=1.0, **kwargs):
    """MobileNet v1's features without the pool and Flatten, cut at three
    quarters of the stack (the stride-16 / stride-32 boundary)."""
    from .mobilenet import get_mobilenet

    net = get_mobilenet(multiplier, **kwargs)
    body = list(net.features._children.values())[:-2]
    cut = max(1, len(body) * 3 // 4)
    first = nn.HybridSequential(prefix="")
    for c in body[:cut]:
        first.add(c)
    second = nn.HybridSequential(prefix="")
    for c in body[cut:]:
        second.add(c)
    return [first, second]


def get_ssd(base="resnet50_v1", data_shape=512, num_classes=20,
            pretrained_base=False, fuse_epilogue=None, ctx=None,
            device=None, **kwargs):
    """An SSD over ``base`` ("resnet50_v1", "resnet18_v1" or
    "mobilenet1.0") with the anchor sizes of ``data_shape`` (reference:
    symbol_factory.py get_symbol_train)."""
    if pretrained_base:
        raise MXNetError("pretrained weights are not downloaded: load them "
                         "with net.load_parameters(path)")
    if base == "resnet50_v1":
        blocks = _resnet_base(1, 50, fuse_epilogue)
    elif base == "resnet18_v1":
        blocks = _resnet_base(1, 18, fuse_epilogue)
    elif base == "mobilenet1.0":
        blocks = _mobilenet_base(1.0)
    else:
        raise MXNetError("unsupported SSD base '%s'" % base)
    sizes = _SIZES_512 if data_shape >= 512 else _SIZES_300
    return SSD(num_classes, blocks, num_extras=4, sizes=sizes,
               ratios=_RATIOS_6, device=device if device is not None
               else ctx, **kwargs)


def ssd_512_resnet50_v1(num_classes=20, **kwargs):
    return get_ssd("resnet50_v1", 512, num_classes, **kwargs)


def ssd_300_resnet50_v1(num_classes=20, **kwargs):
    return get_ssd("resnet50_v1", 300, num_classes, **kwargs)


def ssd_512_mobilenet1_0(num_classes=20, **kwargs):
    return get_ssd("mobilenet1.0", 512, num_classes, **kwargs)


def ssd_test_tiny(num_classes=3, fuse_epilogue=None, **kwargs):
    """The small configuration of the tests and CPU runs: a ResNet-18 base
    and 2 extra scales, from 64 x 64 inputs."""
    blocks = _resnet_base(1, 18, fuse_epilogue)
    return SSD(num_classes, blocks, num_extras=2, extra_filters=(128, 128),
               sizes=_SIZES_512[:4], ratios=_RATIOS_6[:4], **kwargs)
