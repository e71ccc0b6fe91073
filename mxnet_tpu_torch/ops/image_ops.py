"""The image op family (counterpart of `mxnet_tpu/ops/image_ops.py`;
reference: src/operator/image/ — ``_image_to_tensor``, ``_image_normalize``,
``_image_resize``, ``_image_crop``, reached as ``mx.nd.image.*``).

HWC layout in, the reference's semantics: to_tensor gives CHW float32 in
[0, 1]; normalize is per channel on CHW; resize and crop work on HWC
(batched NHWC allowed). Divisions are by tensors on the input's device, so
a CUDA and a CPU call round alike (PyTorch multiplies by the reciprocal
when a CUDA tensor is divided by a Python number).
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from . import register


def _per_channel(val, c, like):
    t = torch.as_tensor(val, dtype=like.dtype).to(like.device)
    if t.dim() == 0:
        t = t.expand(c)
    return t


@register("_image_to_tensor", aliases=("to_tensor",))
def image_to_tensor(data):
    """(H, W, C) or (N, H, W, C) in [0, 255] -> (C, H, W) / (N, C, H, W)
    float32 in [0, 1] (reference: image_random.cc _image_to_tensor)."""
    x = data.float() / torch.full((), 255.0, device=data.device)
    if data.dim() == 3:
        return x.permute(2, 0, 1).contiguous()
    return x.permute(0, 3, 1, 2).contiguous()


@register("_image_normalize", aliases=("image_normalize",))
def image_normalize(data, mean=0.0, std=1.0):
    """(C, H, W) / (N, C, H, W) float: ``(x - mean[c]) / std[c]``
    (reference: image_random.cc _image_normalize; an integer input raises,
    as a float mean would truncate)."""
    if not data.is_floating_point():
        raise MXNetError("image.normalize expects a float input (run "
                         "to_tensor first); got %s" % data.dtype)
    c = data.shape[0] if data.dim() == 3 else data.shape[1]
    shape = (c, 1, 1) if data.dim() == 3 else (1, c, 1, 1)
    m = _per_channel(mean, c, data).reshape(shape)
    s = _per_channel(std, c, data).reshape(shape)
    return (data - m) / s


@register("_image_resize", aliases=("image_resize",))
def image_resize(data, size=(), keep_ratio=False, interp=1):
    """(H, W, C) / (N, H, W, C) resize (reference: resize.cc). ``size``: an
    int (the short side when ``keep_ratio``, else a square) or (w, h).
    ``interp`` 0 is nearest, anything else bilinear (antialiased when
    shrinking), as in the JAX package. Integer images are rounded and
    clipped to their type."""
    batched = data.dim() == 4
    h, w = (data.shape[1], data.shape[2]) if batched \
        else (data.shape[0], data.shape[1])
    if isinstance(size, (tuple, list)) and len(size) not in (1, 2):
        raise MXNetError("image.resize: size must be an int, (s,) or "
                         "(w, h); got %r" % (size,))
    if isinstance(size, (tuple, list)) and len(size) == 2:
        new_w, new_h = int(size[0]), int(size[1])
    else:
        s = int(size[0]) if isinstance(size, (tuple, list)) else int(size)
        if s < 1:
            raise MXNetError("image.resize: size is required and must be "
                             "positive; got %r" % (size,))
        if keep_ratio:
            # the reference truncates (static_cast<int>), not rounds
            if h < w:
                new_h, new_w = s, max(1, w * s // h)
            else:
                new_w, new_h = s, max(1, h * s // w)
        else:
            new_w = new_h = s
    x = data.float()
    x = x.permute(0, 3, 1, 2) if batched else x.permute(2, 0, 1)[None]
    if int(interp) == 0:
        out = torch.nn.functional.interpolate(x, size=(new_h, new_w),
                                              mode="nearest-exact")
    else:
        out = torch.nn.functional.interpolate(x, size=(new_h, new_w),
                                              mode="bilinear",
                                              align_corners=False,
                                              antialias=True)
    out = out.permute(0, 2, 3, 1) if batched else out[0].permute(1, 2, 0)
    if not data.is_floating_point():
        info = torch.iinfo(data.dtype)
        out = out.round().clamp(info.min, info.max)
    return out.to(data.dtype).contiguous()


@register("_image_crop", aliases=("image_crop",))
def image_crop(data, x=0, y=0, width=1, height=1):
    """The (width, height) window at (x, y) of (H, W, C) / (N, H, W, C)
    (reference: crop.cc _image_crop)."""
    x, y, width, height = int(x), int(y), int(width), int(height)
    if data.dim() == 3:
        return data[y:y + height, x:x + width].contiguous()
    return data[:, y:y + height, x:x + width].contiguous()
