"""Contrib ops (counterpart of `mxnet_tpu/ops/contrib.py`; reference:
src/operator/contrib/**): flash attention over its CUDA kernels; the
transformer helper ``div_sqrt_dim``; the SSD ops (``MultiBoxPrior``,
``MultiBoxTarget``, ``MultiBoxDetection``, ``box_iou``, ``box_nms``); the
R-CNN ops (``ROIAlign``, ``ROIPooling``, ``Proposal``); resize
(``BilinearResize2D``, ``AdaptiveAvgPooling2D``), ``fft`` / ``ifft``,
``quadratic``, ``arange_like``, ``boolean_mask``, ``index_copy``,
``index_array``, ``count_sketch``, ``SVMOutput`` and
``DeformableConvolution``; and the mixture-of-experts ops ``switch_moe`` /
``topk_moe`` (the dense dispatch / combine formulation; inside a
`parallel.DistributedTrainer` step they route the global batch over the
mesh's ``dp`` ranks and run this rank's experts over ``ep``, see
`topk_moe`).

Every op here but flash attention is plain PyTorch, on the card as on the
CPU: the JAX package computes them in jnp (no Pallas kernel). Shapes stay
static as there (suppressed rows keep their place with a -1 sentinel).

Orders follow the JAX package exactly: a descending sort is the stable
sort of the negated scores (``jnp.argsort`` is stable; ``lax.top_k`` puts
the lower index first among ties), never `torch.topk`, whose tie order on
CUDA is unspecified; ``argmax`` takes the first maximum. The greedy NMS of
``MultiBoxDetection``, ``box_nms`` and ``Proposal`` (JAX: a ``fori_loop``
over the anchors) builds the suppression matrix on the tensor's device,
packed 32 columns a word, and sweeps it on the host in one read
(`_greedy_nms`). ``MultiBoxTarget`` forces a match at each valid ground
truth's best anchor as the OR over those boxes (the reference's meaning);
the JAX package's scatter keeps the last write instead, so a padded label
row after a valid box whose best anchor is anchor 0 unmatches it there
(ROADMAP, "Not queued").
"""
from __future__ import annotations

import math

import numpy as _np
import torch
import torch.nn.functional as F

from . import pallas_kernels, register

__all__ = ["flash_attention", "div_sqrt_dim", "quadratic", "arange_like",
           "bilinear_resize_2d", "adaptive_avg_pooling_2d", "boolean_mask",
           "index_copy", "index_array", "fft", "ifft", "roi_align",
           "roi_pooling", "multibox_prior", "box_iou", "multibox_target",
           "multibox_detection", "box_nms", "count_sketch", "svm_output",
           "proposal", "deformable_convolution", "switch_moe", "topk_moe"]


@register("_contrib_div_sqrt_dim", aliases=("div_sqrt_dim",))
def div_sqrt_dim(data):
    """``data / sqrt(data.shape[-1])`` (reference: transformer.cc:34)."""
    return data / torch.sqrt(torch.tensor(float(data.shape[-1]),
                                          dtype=data.dtype,
                                          device=data.device))


@register("_contrib_quadratic", aliases=("quadratic",))
def quadratic(data, a=0.0, b=0.0, c=0.0):
    """``a x^2 + b x + c`` (reference: quadratic_op-inl.h)."""
    return a * data.square() + b * data + c


@register("_contrib_arange_like", aliases=("arange_like",))
def arange_like(data, start=0.0, step=1.0, repeat=1, axis=None):
    """``start + step * i`` over ``data``'s elements (its shape), or along
    ``axis`` (a vector); ``repeat`` is taken and ignored, as in the JAX
    package."""
    n = data.numel() if axis is None else data.shape[axis]
    out = start + step * torch.arange(n, dtype=data.dtype,
                                      device=data.device)
    return out.reshape(data.shape) if axis is None else out


@register("_contrib_BilinearResize2D",
          aliases=("BilinearResize2D", "bilinear_resize_2d"))
def bilinear_resize_2d(data, height=1, width=1, scale_height=None,
                       scale_width=None, mode="size", align_corners=True):
    """Bilinear resize of (N, C, H, W) (reference: bilinear_resize-inl.h):
    corners to corners by default (``src = dst (in - 1) / (out - 1)``);
    with ``align_corners=False`` the half-pixel convention, antialiased
    when it shrinks (the JAX package's ``jax.image.resize``)."""
    n, c, h, w = data.shape
    if scale_height is not None:
        height = int(h * scale_height)
        width = int(w * (scale_width if scale_width is not None
                         else scale_height))
    if not align_corners:
        return F.interpolate(data, size=(height, width), mode="bilinear",
                             align_corners=False, antialias=True)

    def axis_coords(in_sz, out_sz):
        if out_sz == 1:
            return torch.zeros(1, device=data.device)
        return torch.linspace(0.0, in_sz - 1.0, out_sz, device=data.device)

    ys = axis_coords(h, height)
    xs = axis_coords(w, width)
    y0 = torch.floor(ys).long().clamp(0, h - 1)
    y1 = (y0 + 1).clamp(max=h - 1)
    wy = (ys - y0).to(data.dtype).reshape(1, 1, height, 1)
    x0 = torch.floor(xs).long().clamp(0, w - 1)
    x1 = (x0 + 1).clamp(max=w - 1)
    wx = (xs - x0).to(data.dtype).reshape(1, 1, 1, width)
    rowi = data[:, :, y0] * (1 - wy) + data[:, :, y1] * wy
    return rowi[..., x0] * (1 - wx) + rowi[..., x1] * wx


@register("_contrib_AdaptiveAvgPooling2D", aliases=("AdaptiveAvgPooling2D",))
def adaptive_avg_pooling_2d(data, output_size=()):
    """The mean over equal windows when the output size divides the input;
    otherwise the JAX package's linear resize."""
    n, c, h, w = data.shape
    if not output_size:
        oh = ow = 1
    elif isinstance(output_size, int):
        oh = ow = output_size
    else:
        oh, ow = output_size if len(output_size) == 2 \
            else (output_size[0],) * 2
    if h % oh == 0 and w % ow == 0:
        return data.reshape(n, c, oh, h // oh, ow, w // ow).mean(dim=(3, 5))
    return F.interpolate(data, size=(oh, ow), mode="bilinear",
                         align_corners=False, antialias=True)


@register("_contrib_boolean_mask", aliases=("boolean_mask",))
def boolean_mask(data, index, axis=0):
    """Static-shape boolean mask: the kept rows compacted to the front in
    order, the rest zero (the reference returns only the kept rows,
    contrib/boolean_mask.cc)."""
    mask = index.bool()
    order = torch.sort((~mask).to(torch.uint8), stable=True).indices
    gathered = torch.index_select(data, axis, order)
    keep = torch.arange(mask.numel(), device=data.device) < mask.sum()
    bshape = (-1,) + (1,) * (data.dim() - 1 - axis)
    return gathered * keep.reshape(bshape).to(data.dtype)


@register("_contrib_index_copy", aliases=("index_copy",))
def index_copy(old, index, new):
    """``old`` with the rows at ``index`` replaced by ``new``'s."""
    out = old.clone()
    out[index.long()] = new
    return out


@register("_contrib_index_array", aliases=("index_array",))
def index_array(data, axes=None):
    """Each element's coordinates along ``axes`` (default all), int32 of
    shape ``data.shape + (len(axes),)`` (reference: index_array.cc)."""
    axes = tuple(axes) if axes else tuple(range(data.dim()))
    comps = []
    for a in axes:
        shape1 = [1] * data.dim()
        shape1[a] = data.shape[a]
        comps.append(torch.arange(data.shape[a], device=data.device)
                     .reshape(shape1).expand(data.shape))
    return torch.stack(comps, dim=-1).to(torch.int32)


@register("_contrib_fft", aliases=("fft",))
def fft(data, compute_size=128):
    """FFT over the last axis, real and imaginary parts interleaved."""
    out = torch.fft.fft(data.to(torch.complex64), dim=-1)
    return torch.stack([out.real, out.imag], dim=-1).reshape(
        data.shape[:-1] + (2 * data.shape[-1],))


@register("_contrib_ifft", aliases=("ifft",))
def ifft(data, compute_size=128):
    """Inverse of `fft`'s layout, unnormalized: the real part times n."""
    n = data.shape[-1] // 2
    cplx = data.reshape(data.shape[:-1] + (n, 2))
    out = torch.fft.ifft(torch.complex(cplx[..., 0].float(),
                                       cplx[..., 1].float()), dim=-1)
    return out.real.float() * n


# ---------------------------------------------------------------------------
# ROI ops (reference: roi_align.cc, ../roi_pooling.cc)
# ---------------------------------------------------------------------------

def _bilinear_sample(data, bidx, y, x):
    """Bilinear samples of ``data`` (N, C, H, W): image ``bidx`` (R,) at
    points ``y``, ``x`` (R, S), corners clipped into the image (the JAX
    package's sampler, vmapped there over ROIs and points) -> (R, S, C)."""
    h, w = data.shape[2], data.shape[3]
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    wy = y - y0
    wx = x - x0
    b = bidx[:, None]

    def g(yy, xx):
        yi = yy.to(torch.int32).clamp(0, h - 1).long()
        xi = xx.to(torch.int32).clamp(0, w - 1).long()
        return data[b, :, yi, xi]

    wy, wx = wy[..., None], wx[..., None]
    return (g(y0, x0) * (1 - wy) * (1 - wx) + g(y0, x0 + 1) * (1 - wy) * wx
            + g(y0 + 1, x0) * wy * (1 - wx) + g(y0 + 1, x0 + 1) * wy * wx)


@register("_contrib_ROIAlign", aliases=("ROIAlign", "roi_align"))
def roi_align(data, rois, pooled_size=(7, 7), spatial_scale=1.0,
              sample_ratio=2, position_sensitive=False, aligned=False):
    """ROI Align: each ROI row ``[batch, x1, y1, x2, y2]`` (image
    coordinates) pooled to (C, ph, pw) by the mean of ``sample_ratio^2``
    bilinear samples a bin -> (R, C, ph, pw); gradients by autograd."""
    ph, pw = pooled_size
    sr = max(int(sample_ratio), 1)
    offset = 0.5 if aligned else 0.0
    r = rois.shape[0]
    bidx = rois[:, 0].to(torch.int32).clamp(0, data.shape[0] - 1).long()
    x1 = rois[:, 1] * spatial_scale - offset
    y1 = rois[:, 2] * spatial_scale - offset
    x2 = rois[:, 3] * spatial_scale - offset
    y2 = rois[:, 4] * spatial_scale - offset
    rh = torch.clamp(y2 - y1, min=1.0)
    rw = torch.clamp(x2 - x1, min=1.0)
    bh = (rh / ph).reshape(r, 1, 1, 1, 1)
    bw = (rw / pw).reshape(r, 1, 1, 1, 1)
    dev = data.device
    iy = (torch.arange(ph, device=dev).reshape(1, ph, 1, 1, 1) * bh
          + y1.reshape(r, 1, 1, 1, 1)
          + (torch.arange(sr, device=dev).reshape(1, 1, 1, sr, 1) + 0.5)
          * bh / sr)
    ix = (torch.arange(pw, device=dev).reshape(1, 1, pw, 1, 1) * bw
          + x1.reshape(r, 1, 1, 1, 1)
          + (torch.arange(sr, device=dev).reshape(1, 1, 1, 1, sr) + 0.5)
          * bw / sr)
    shape = (r, ph, pw, sr, sr)
    ys = iy.expand(shape).reshape(r, -1)
    xs = ix.expand(shape).reshape(r, -1)
    samples = _bilinear_sample(data, bidx, ys, xs)     # (R, S, C)
    samples = samples.reshape(r, ph, pw, sr * sr, -1).mean(dim=3)
    return samples.permute(0, 3, 1, 2)


@register("ROIPooling")
def roi_pooling(data, rois, pooled_size=(7, 7), spatial_scale=1.0):
    """ROI max pooling: each ROI's rounded window split into ph x pw bins,
    the max of each bin (0 for an empty one) -> (R, C, ph, pw). The
    gradient of a bin goes to its maximum, split evenly among ties (JAX's
    scatter-max and ``scatter_reduce("amax")`` both)."""
    ph, pw = pooled_size
    n, c, h, w = data.shape
    r = rois.shape[0]
    bidx = rois[:, 0].to(torch.int32).clamp(0, n - 1).long()
    x1 = torch.round(rois[:, 1] * spatial_scale)[:, None]
    y1 = torch.round(rois[:, 2] * spatial_scale)[:, None]
    x2 = torch.round(rois[:, 3] * spatial_scale)[:, None]
    y2 = torch.round(rois[:, 4] * spatial_scale)[:, None]
    rh = torch.clamp(y2 - y1 + 1, min=1.0)
    rw = torch.clamp(x2 - x1 + 1, min=1.0)
    gy = torch.arange(h, dtype=torch.float32, device=data.device)[None]
    gx = torch.arange(w, dtype=torch.float32, device=data.device)[None]
    biny = torch.floor((gy - y1) * ph / rh).clamp(-1, ph - 1)
    binx = torch.floor((gx - x1) * pw / rw).clamp(-1, pw - 1)
    oh = torch.where((gy >= y1) & (gy <= y2), biny, float(ph)).long()
    ow = torch.where((gx >= x1) & (gx <= x2), binx, float(pw)).long()
    bins = (oh[:, :, None] * (pw + 1) + ow[:, None, :]).reshape(r, 1, h * w)
    feat = data[bidx].reshape(r, c, h * w)
    out = torch.full((r, c, (ph + 1) * (pw + 1)), -math.inf,
                     dtype=data.dtype, device=data.device)
    out = out.scatter_reduce(2, bins.expand(r, c, h * w), feat, "amax")
    out = out.reshape(r, c, ph + 1, pw + 1)[:, :, :ph, :pw]
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


# ---------------------------------------------------------------------------
# SSD ops (reference: multibox_prior.cc, multibox_target.cc,
# multibox_detection.cc, bounding_box.cc)
# ---------------------------------------------------------------------------

@register("_contrib_MultiBoxPrior", aliases=("MultiBoxPrior",))
def multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                   steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """Anchors of a (N, C, H, W) feature map, (1, H W (S + R - 1), 4)
    normalized corners, computed on the host from the shape alone (as the
    JAX package folds them to a constant) and placed on ``data``'s
    device."""
    h, w = data.shape[2], data.shape[3]
    step_y = steps[0] if steps[0] > 0 else 1.0 / h
    step_x = steps[1] if steps[1] > 0 else 1.0 / w
    cy = (_np.arange(h) + offsets[0]) * step_y
    cx = (_np.arange(w) + offsets[1]) * step_x
    cy, cx = _np.meshgrid(cy, cx, indexing="ij")
    boxes = []
    for i in range(len(sizes) + len(ratios) - 1):
        if i < len(sizes):
            bw = bh = sizes[i] / 2.0
            bw *= _np.sqrt(ratios[0])
            bh /= _np.sqrt(ratios[0])
        else:
            r = ratios[i - len(sizes) + 1]
            bw = sizes[0] / 2.0 * _np.sqrt(r)
            bh = sizes[0] / 2.0 / _np.sqrt(r)
        boxes.append(_np.stack([cx - bw, cy - bh, cx + bw, cy + bh], axis=-1))
    out = _np.stack(boxes, axis=2).reshape(1, -1, 4).astype(_np.float32)
    if clip:
        out = _np.clip(out, 0.0, 1.0)
    return torch.as_tensor(out, device=data.device)


def _box_iou_corner(a, b):
    """IoU of corner boxes ``a`` (..., 4) and ``b`` (..., 4), broadcast."""
    tl = torch.maximum(a[..., :2], b[..., :2])
    br = torch.minimum(a[..., 2:], b[..., 2:])
    wh = torch.clamp(br - tl, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = torch.clamp((a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1]),
                         min=0.0)
    area_b = torch.clamp((b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1]),
                         min=0.0)
    return inter / torch.clamp(area_a + area_b - inter, min=1e-12)


@register("_contrib_box_iou", aliases=("box_iou",))
def box_iou(lhs, rhs, format="corner"):
    """IoU of every box of ``lhs`` (..., N, 4) with every box of ``rhs``
    (..., M, 4) -> (..., N, M)."""
    return _box_iou_corner(lhs[..., :, None, :], rhs[..., None, :, :])


def _descending(score):
    """Indices sorting ``score`` (..., n) descending, ties in index order
    (``jnp.argsort(-score)``, ``lax.top_k``)."""
    return torch.sort(-score, dim=-1, stable=True).indices


# elements of one block of the IoU matrix (rows x n x batch), which bounds
# the NMS's device memory to a few hundred MB at any n
_NMS_BLOCK = 1 << 24
# bit k's weight in a packed int32 word: 2^k, and -2^31 for bit 31 (two's
# complement)
_BIT = [1 << k for k in range(31)] + [-(1 << 31)]


def _suppression_words(boxes, thresh, ids=None):
    """The greedy NMS's suppression matrix of ``boxes`` (B, n, 4) in score
    order: bit j of row i set when ``iou(i, j) > thresh``, ``j > i`` and
    (given ``ids`` (B, n)) the ids are equal; packed 32 columns an int32
    word -> (B, n, ceil(n / 32)), on the boxes' device."""
    b, n = boxes.shape[:2]
    words = -(-n // 32)
    bit = torch.tensor(_BIT, dtype=torch.int32, device=boxes.device)
    col = torch.arange(n, device=boxes.device)
    rows = max(1, _NMS_BLOCK // max(1, b * n))
    out = []
    for r0 in range(0, n, rows):
        r1 = min(n, r0 + rows)
        sup = _box_iou_corner(boxes[:, r0:r1, None, :],
                              boxes[:, None, :, :]) > thresh
        sup &= col[None, None, :] > torch.arange(r0, r1,
                                                 device=boxes.device)[
            None, :, None]
        if ids is not None:
            sup &= ids[:, r0:r1, None] == ids[:, None, :]
        sup = F.pad(sup, (0, words * 32 - n))
        out.append((sup.reshape(b, r1 - r0, words, 32).to(torch.int32)
                    * bit).sum(-1, dtype=torch.int32))
    return torch.cat(out, dim=1)


def _greedy_nms(boxes, alive, thresh, ids=None):
    """The JAX package's greedy pass (``fori_loop`` over i: while i is
    alive, kill every later j it suppresses) over ``boxes`` (B, n, 4) in
    score order, starting from ``alive`` (B, n) bool; returns the final
    alive mask on ``alive``'s device. The suppression matrix is built on
    the device (`_suppression_words`) and read once; the sweep runs on
    the host over packed words, all B rows at once."""
    b, n = alive.shape
    if n == 0:
        return alive
    with torch.no_grad():
        words = _suppression_words(boxes.detach(), thresh, ids)
    rows = words.cpu().numpy().view(_np.uint32)
    nw = rows.shape[2]
    live = _np.zeros((b, nw * 32), bool)
    live[:, :n] = alive.cpu().numpy()
    live = _np.packbits(live, axis=1, bitorder="little").view("<u4").copy()
    for i in range(n):
        w, k = divmod(i, 32)
        cur = (live[:, w] >> _np.uint32(k)) & _np.uint32(1)
        if cur.any():
            live &= ~(rows[:, i, :] * cur[:, None])
    out = _np.unpackbits(live.view(_np.uint8), axis=1,
                         bitorder="little")[:, :n].astype(bool)
    return torch.from_numpy(out).to(alive.device)


def _take_rows(x, order):
    """``x`` (B, n, ...) reordered along dim 1 by ``order`` (B, n)."""
    idx = order.reshape(order.shape + (1,) * (x.dim() - 2)).expand(
        order.shape + x.shape[2:])
    return torch.gather(x, 1, idx)


@register("_contrib_MultiBoxTarget", aliases=("MultiBoxTarget",),
          num_outputs=3)
@torch.no_grad()
def multibox_target(anchor, label, cls_pred, overlap_threshold=0.5,
                    ignore_label=-1.0, negative_mining_ratio=-1.0,
                    negative_mining_thresh=0.5, minimum_negative_samples=0,
                    variances=(0.1, 0.1, 0.2, 0.2)):
    """Anchor matching and target encoding for SSD training (reference:
    multibox_target.cc). ``anchor`` (1, A, 4), ``label`` (B, M, 5+) rows
    ``[cls, x1, y1, x2, y2]`` (cls -1 pads), ``cls_pred`` (B, C, A) raw ->
    ``(loc_target (B, 4A), loc_mask (B, 4A), cls_target (B, A))``, no
    gradient. With ``negative_mining_ratio > 0`` the unmatched anchors
    below ``negative_mining_thresh`` are ranked by their non-background
    probability; the hardest ``ratio x matched`` stay background (0), the
    rest get ``ignore_label``."""
    anchors = anchor.reshape(-1, 4)
    a = anchors.shape[0]
    bsz = label.shape[0]
    valid = label[:, :, 0] >= 0                                  # (B, M)
    ious = _box_iou_corner(anchors[None, :, None, :],
                           label[:, None, :, 1:5])               # (B, A, M)
    ious = torch.where(valid[:, None, :], ious, torch.zeros_like(ious))
    best_gt = torch.argmax(ious, dim=2)                          # (B, A)
    best_iou = torch.amax(ious, dim=2)
    matched = best_iou > overlap_threshold
    best_anchor = torch.argmax(ious, dim=1)                      # (B, M)
    forced = torch.zeros(bsz, a, dtype=torch.int32, device=anchor.device)
    forced.scatter_add_(1, best_anchor, valid.to(torch.int32))
    matched = matched | (forced > 0)
    gt = _take_rows(label, best_gt)                              # (B, A, W)
    cls_target = torch.where(matched, gt[:, :, 0] + 1.0,
                             torch.zeros_like(best_iou))
    if negative_mining_ratio > 0:
        prob = torch.softmax(cls_pred, dim=1)                    # (B, C, A)
        hardness = 1.0 - prob[:, 0]
        candidate = (~matched) & (best_iou < negative_mining_thresh)
        score = torch.where(candidate, hardness,
                            torch.full_like(hardness, -math.inf))
        order = _descending(score)
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(a, device=anchor.device).expand(bsz, a))
        quota = (torch.tensor(float(negative_mining_ratio),
                              dtype=torch.float32, device=anchor.device)
                 * matched.sum(dim=1).to(torch.float32)).to(torch.int32)
        quota = torch.clamp(quota, min=int(minimum_negative_samples))
        keep_neg = candidate & (rank < quota[:, None])
        cls_target = torch.where(
            matched, cls_target,
            torch.where(keep_neg, torch.zeros_like(cls_target),
                        torch.full_like(cls_target, float(ignore_label))))
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    acx = (anchors[:, 0] + anchors[:, 2]) / 2
    acy = (anchors[:, 1] + anchors[:, 3]) / 2
    gw = torch.clamp(gt[..., 3] - gt[..., 1], min=1e-12)
    gh = torch.clamp(gt[..., 4] - gt[..., 2], min=1e-12)
    gcx = (gt[..., 1] + gt[..., 3]) / 2
    gcy = (gt[..., 2] + gt[..., 4]) / 2
    aw_ = torch.clamp(aw, min=1e-12)
    ah_ = torch.clamp(ah, min=1e-12)
    tx = (gcx - acx) / aw_ / variances[0]
    ty = (gcy - acy) / ah_ / variances[1]
    tw = torch.log(gw / aw_) / variances[2]
    th = torch.log(gh / ah_) / variances[3]
    loc_t = torch.stack([tx, ty, tw, th], dim=-1)
    m = matched[..., None]
    loc_t = torch.where(m, loc_t, torch.zeros_like(loc_t))
    loc_mask = m.to(loc_t.dtype).expand(bsz, a, 4)
    return (loc_t.reshape(bsz, -1), loc_mask.reshape(bsz, -1).contiguous(),
            cls_target)


@register("_contrib_MultiBoxDetection", aliases=("MultiBoxDetection",))
def multibox_detection(cls_prob, loc_pred, anchor, clip=True, threshold=0.01,
                       background_id=0, nms_threshold=0.5,
                       force_suppress=False, variances=(0.1, 0.1, 0.2, 0.2),
                       nms_topk=-1):
    """Decode and NMS (reference: multibox_detection.cc): ``cls_prob``
    (B, C, A), ``loc_pred`` (B, 4A), ``anchor`` (1, A, 4) -> (B, A, 6)
    rows ``[id, score, x1, y1, x2, y2]`` in descending score order, id -1
    for a row below ``threshold`` or suppressed by a higher one of its
    class (any class with ``force_suppress``). ``nms_topk`` is taken and
    ignored, as in the JAX package."""
    anchors = anchor.reshape(-1, 4)
    a = anchors.shape[0]
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    acx = (anchors[:, 0] + anchors[:, 2]) / 2
    acy = (anchors[:, 1] + anchors[:, 3]) / 2
    loc = loc_pred.reshape(loc_pred.shape[0], a, 4)
    cx = loc[..., 0] * variances[0] * aw + acx
    cy = loc[..., 1] * variances[1] * ah + acy
    w = torch.exp(loc[..., 2] * variances[2]) * aw / 2
    h = torch.exp(loc[..., 3] * variances[3]) * ah / 2
    boxes = torch.stack([cx - w, cy - h, cx + w, cy + h], dim=-1)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    scores = cls_prob[:, 1:] if background_id == 0 else cls_prob
    cls_id = torch.argmax(scores, dim=1).to(torch.float32)       # (B, A)
    score = torch.amax(scores, dim=1)
    order = _descending(score)
    boxes_o = _take_rows(boxes, order)
    ids_o = _take_rows(cls_id, order)
    score_o = _take_rows(score, order)
    keep_o = score_o > threshold
    alive = _greedy_nms(boxes_o, keep_o, nms_threshold,
                        None if force_suppress else ids_o)
    out_id = torch.where(alive & keep_o, ids_o, torch.full_like(ids_o, -1.0))
    return torch.cat([out_id[..., None], score_o[..., None], boxes_o],
                     dim=-1)


@register("_contrib_box_nms", aliases=("box_nms",))
def box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
            coord_start=2, score_index=1, id_index=-1, background_id=-1,
            force_suppress=False, in_format="corner", out_format="corner"):
    """Static-shape NMS over (..., n, K) rows (reference: bounding_box.cc):
    the rows in descending score order, a suppressed or invalid row's
    score set to -1. ``topk``, ``background_id`` and ``out_format`` are
    taken and ignored, as in the JAX package."""
    shape = data.shape
    d = data.reshape((-1,) + tuple(shape[-2:]))
    score = d[:, :, score_index]
    boxes = d[:, :, coord_start:coord_start + 4]
    if in_format == "center":
        cx, cy, w, h = boxes.unbind(-1)
        boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                            dim=-1)
    order = _descending(score)
    d_o = _take_rows(d, order)
    b_o = _take_rows(boxes, order)
    v_o = _take_rows(score > valid_thresh, order)
    ids = d_o[:, :, id_index] if id_index >= 0 and not force_suppress \
        else None
    alive = _greedy_nms(b_o, v_o, overlap_thresh, ids)
    col = torch.arange(d.shape[-1], device=d.device) \
        == score_index % d.shape[-1]
    kept = torch.where(alive, d_o[:, :, score_index],
                       torch.full_like(d_o[:, :, score_index], -1.0))
    out = torch.where(col, kept[..., None], d_o)
    return out.reshape(shape)


@register("_contrib_count_sketch", aliases=("count_sketch",))
def count_sketch(data, h, s, out_dim=0, processing_batch_size=32):
    """Count sketch: ``out[..., h[i]] += s[i] * data[..., i]``."""
    out = torch.zeros(data.shape[:-1] + (int(out_dim),), dtype=data.dtype,
                      device=data.device)
    return out.index_add(-1, h.reshape(-1).long(), data * s.reshape(-1))


class _SVMOutput(torch.autograd.Function):
    """Identity forward; the backward is the hinge loss's gradient,
    whatever the output's cotangent (the JAX package's ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, data, label, margin, reg, use_linear):
        ctx.save_for_backward(data, label)
        ctx.cfg = (margin, reg, use_linear)
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        d, lab = ctx.saved_tensors
        margin, reg, use_linear = ctx.cfg
        onehot = F.one_hot(lab.long(), d.shape[-1]).to(d.dtype)
        score_gt = (d * onehot).sum(dim=-1, keepdim=True)
        if use_linear:
            viol = ((margin - (score_gt - d)) > 0).to(d.dtype) * (1 - onehot)
            grad = viol - onehot * viol.sum(dim=-1, keepdim=True)
        else:
            m = torch.clamp(margin - (score_gt - d), min=0.0) * (1 - onehot)
            grad = 2 * m - 2 * onehot * m.sum(dim=-1, keepdim=True)
        return grad * reg, torch.zeros_like(lab), None, None, None


@register("SVMOutput")
def svm_output(data, label, margin=1.0, regularization_coefficient=1.0,
               use_linear=False):
    """Support-vector output layer: the data forward, the (squared or
    linear) hinge loss's gradient backward (reference: svm_output.cc)."""
    return _SVMOutput.apply(data, label, float(margin),
                            float(regularization_coefficient),
                            bool(use_linear))


@register("_contrib_flash_attention", aliases=("flash_attention",))
def flash_attention(q, k, v, causal=False, sm_scale=None):
    """Flash attention over (..., L, D) inputs (`_contrib_flash_attention`):
    `pallas_kernels.flash_attention`, whose three CUDA kernels run for CUDA
    tensors."""
    return pallas_kernels.flash_attention(q, k, v, causal=causal,
                                          sm_scale=sm_scale)


# ---------------------------------------------------------------------------
# RPN Proposal (reference: proposal-inl.h:93): anchors + deltas -> clip ->
# min-size filter -> top-k -> NMS -> a fixed count of ROIs
# ---------------------------------------------------------------------------

def _rpn_anchors(h, w, stride, scales, ratios):
    """The RPN anchors of an (h, w) feature map, (h w A, 4) float32 image
    corners, A = len(ratios) len(scales), ratio-major."""
    base = float(stride)
    anchors = []
    for r in ratios:
        for s in scales:
            size = base * base * s * s
            w_a = _np.sqrt(size / r)
            h_a = w_a * r
            anchors.append([-(w_a - 1) / 2, -(h_a - 1) / 2,
                            (w_a - 1) / 2, (h_a - 1) / 2])
    base_a = _np.asarray(anchors, _np.float32)
    cy, cx = _np.meshgrid(_np.arange(h) * stride, _np.arange(w) * stride,
                          indexing="ij")
    shift = _np.stack([cx, cy, cx, cy], axis=-1).reshape(-1, 1, 4)
    return (shift + base_a[None]).reshape(-1, 4)


@register("_contrib_Proposal", num_outputs=-1,
          num_outputs_fn=lambda attrs: 2 if attrs.get("output_score") else 1,
          aliases=("Proposal", "_contrib_MultiProposal", "MultiProposal"))
def proposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
             rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
             scales=(4, 8, 16, 32), ratios=(0.5, 1, 2), feature_stride=16,
             output_score=False, iou_loss=False):
    """``cls_prob`` (B, 2A, H, W), ``bbox_pred`` (B, 4A, H, W), ``im_info``
    (B, 3) ``[height, width, scale]`` -> ROIs (B post_n, 5) ``[batch, x1,
    y1, x2, y2]`` (and their scores (B post_n, 1) with ``output_score``):
    the top ``pre_n`` boxes by foreground score after the min-size filter,
    greedy NMS at ``threshold``, the survivors in score order, the rest
    filled with the best box."""
    b, c2a, h, w = cls_prob.shape
    na = c2a // 2
    dev = cls_prob.device
    anchors = torch.as_tensor(_rpn_anchors(h, w, feature_stride, scales,
                                           ratios), dtype=torch.float32,
                              device=dev)
    pre_n = min(int(rpn_pre_nms_top_n), anchors.shape[0])
    post_n = int(rpn_post_nms_top_n)
    fg = cls_prob[:, na:].permute(0, 2, 3, 1).reshape(b, -1)
    d = bbox_pred.reshape(b, na, 4, h, w).permute(0, 3, 4, 1, 2).reshape(
        b, -1, 4)
    ah = anchors[:, 3] - anchors[:, 1] + 1.0
    aw = anchors[:, 2] - anchors[:, 0] + 1.0
    acx = anchors[:, 0] + 0.5 * (aw - 1)
    acy = anchors[:, 1] + 0.5 * (ah - 1)
    cx = d[..., 0] * aw + acx
    cy = d[..., 1] * ah + acy
    pw = torch.exp(torch.clamp(d[..., 2], -10, 10)) * aw
    ph = torch.exp(torch.clamp(d[..., 3], -10, 10)) * ah
    zero = torch.zeros((), dtype=d.dtype, device=dev)
    hi_x = (im_info[:, 1] - 1.0)[:, None]
    hi_y = (im_info[:, 0] - 1.0)[:, None]
    x1 = torch.minimum(torch.maximum(cx - 0.5 * (pw - 1), zero), hi_x)
    y1 = torch.minimum(torch.maximum(cy - 0.5 * (ph - 1), zero), hi_y)
    x2 = torch.minimum(torch.maximum(cx + 0.5 * (pw - 1), zero), hi_x)
    y2 = torch.minimum(torch.maximum(cy + 0.5 * (ph - 1), zero), hi_y)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1)
    min_size = (rpn_min_size * im_info[:, 2])[:, None]
    keep = ((x2 - x1 + 1.0) >= min_size) & ((y2 - y1 + 1.0) >= min_size)
    score = torch.where(keep, fg, torch.full_like(fg, -math.inf))
    top_i = _descending(score)[:, :pre_n]
    top_s = torch.gather(score, 1, top_i)
    top_b = _take_rows(boxes, top_i)
    alive = _greedy_nms(top_b, torch.isfinite(top_s), threshold)
    rank = torch.sort((~alive).to(torch.uint8), dim=1, stable=True).indices
    if post_n <= pre_n:
        sel = rank[:, :post_n]
    else:
        sel = torch.cat([rank, rank.new_zeros(b, post_n - pre_n)], dim=1)
    out_alive = torch.gather(alive, 1, sel)
    out_boxes = torch.where(out_alive[..., None], _take_rows(top_b, sel),
                            top_b[:, :1])
    out_score = torch.where(out_alive, torch.gather(top_s, 1, sel),
                            top_s[:, :1])
    batch_ids = torch.arange(b, dtype=out_boxes.dtype,
                             device=dev).repeat_interleave(post_n)
    rois = torch.cat([batch_ids[:, None], out_boxes.reshape(-1, 4)], dim=-1)
    if output_score:
        return rois, out_score.reshape(-1, 1)
    return rois


# ---------------------------------------------------------------------------
# DeformableConvolution (reference: deformable_convolution-inl.h:99):
# bilinear samples at learned offsets, then a grouped contraction
# ---------------------------------------------------------------------------

@register("_contrib_DeformableConvolution",
          aliases=("DeformableConvolution",))
def deformable_convolution(data, offset, weight, bias=None, kernel=(),
                           stride=(), dilate=(), pad=(), num_filter=0,
                           num_group=1, num_deformable_group=1,
                           no_bias=False, workspace=0, layout=None):
    """Deformable convolution over (N, C, H, W): each tap samples the input
    bilinearly at its grid point plus its learned ``offset`` (N, dg 2 kh
    kw, OH, OW; y before x a tap; zero outside the image), then the taps
    contract with ``weight`` (num_filter, C / g, kh, kw) in f32."""
    n, c, h, w = data.shape
    kh, kw = kernel
    sh, sw = stride if stride else (1, 1)
    dh, dw = dilate if dilate else (1, 1)
    ph, pw = pad if pad else (0, 0)
    g = int(num_group)
    dg = int(num_deformable_group)
    oh = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    ow = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    dev = data.device
    oy = torch.arange(oh, device=dev) * sh - ph
    ox = torch.arange(ow, device=dev) * sw - pw
    ky = torch.arange(kh, device=dev) * dh
    kx = torch.arange(kw, device=dev) * dw
    base_y = (oy[None, None, :, None] + ky[:, None, None, None]).to(
        data.dtype).expand(kh, kw, oh, ow)
    base_x = (ox[None, None, None, :] + kx[None, :, None, None]).to(
        data.dtype).expand(kh, kw, oh, ow)
    off = offset.reshape(n, dg, kh, kw, 2, oh, ow)
    sy = base_y + off[:, :, :, :, 0]                 # (N, dg, kh, kw, oh, ow)
    sx = base_x + off[:, :, :, :, 1]
    y0 = torch.floor(sy)
    x0 = torch.floor(sx)
    wy = sy - y0
    wx = sx - x0
    imgs = data.reshape(n, dg, c // dg, h * w)
    k = kh * kw * oh * ow

    def at(yy, xx):
        inb = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
        yc = yy.clamp(0, h - 1).to(torch.int32).long()
        xc = xx.clamp(0, w - 1).to(torch.int32).long()
        idx = (yc * w + xc).reshape(n, dg, 1, k).expand(n, dg, c // dg, k)
        v = torch.gather(imgs, 3, idx).reshape(n, dg, c // dg, kh, kw, oh,
                                               ow)
        return torch.where(inb[:, :, None], v, torch.zeros_like(v))

    cols = (at(y0, x0) * ((1 - wy) * (1 - wx))[:, :, None]
            + at(y0, x0 + 1) * ((1 - wy) * wx)[:, :, None]
            + at(y0 + 1, x0) * (wy * (1 - wx))[:, :, None]
            + at(y0 + 1, x0 + 1) * (wy * wx)[:, :, None])
    cols = cols.reshape(n, g, c // g, kh, kw, oh, ow)
    wgt = weight.reshape(g, num_filter // g, c // g, kh, kw)
    out = torch.einsum("ngcijyx,gocij->ngoyx", cols.float(), wgt.float())
    out = out.reshape(n, num_filter, oh, ow).to(data.dtype)
    if bias is not None and not no_bias:
        out = out + bias.reshape(1, -1, 1, 1)
    return out



# --------------------------------------------------------------------------
# Mixture of experts (not in the reference; the JAX package's expert-
# parallel extension). Top-k routing with capacity, dense dispatch /
# combine einsums. The products are plain torch.einsum: the JAX package
# computes them outside any Pallas kernel.
# --------------------------------------------------------------------------

def _moe_axes():
    """(dp, ep) axes of the enclosing `DistributedTrainer` step, or (None,
    None) outside one."""
    from ..parallel.mesh import DP, EP, step_mesh

    mesh = step_mesh()
    if mesh is None:
        return None, None
    return mesh.axis(DP), mesh.axis(EP)


@register("_contrib_switch_moe", num_outputs=2, num_visible_outputs=2,
          aliases=("switch_moe",))
def switch_moe(data, gate_weight, expert_w_in, expert_w_out,
               capacity_factor=1.25):
    """data (..., d); gate_weight (E, d); expert tables (E, d, h)/(E, h, d).
    Returns (output (..., d), aux_loss ()): `topk_moe` at k=1 with
    unnormalized gates, its z-loss dropped (reference:
    mxnet_tpu/ops/contrib.py:switch_moe)."""
    out, lb, _z = topk_moe(data, gate_weight, expert_w_in, expert_w_out,
                           k=1, capacity_factor=capacity_factor,
                           normalize_gates=False)
    return out, lb


@register("_contrib_topk_moe", num_outputs=3, num_visible_outputs=3,
          aliases=("topk_moe",))
def topk_moe(data, gate_weight, expert_w_in, expert_w_out, k=2,
             capacity_factor=1.25, normalize_gates=True):
    """Top-k MoE routing (GShard / Mixtral; k=1 is Switch). data (..., d);
    gate_weight (E, d); expert tables (E, d, h) / (E, h, d). Returns
    (output (..., d), lb_loss (), z_loss ()), as the JAX package's:

    - the router in f32: logits, softmax, and the top k of each token by a
      stable sort of the negated probabilities (``lax.top_k``'s order: the
      lower expert first among ties; never `torch.topk`), gates
      renormalized over the k choices when ``normalize_gates`` and k > 1;
    - capacity ``int(capacity_factor * k * T / E)`` slots an expert, shared
      across choices in priority order (choice j queues after every
      earlier choice's claims); a choice past the capacity is dropped;
    - lb = E * sum_e(frac_tokens_e * frac_probs_e), frac_tokens counting
      every choice (1/k each); z = mean_t(logsumexp(logits_t)^2).

    Inside a `DistributedTrainer` step over a mesh (`mesh.step_scope`)
    each rank holds its ``dp`` shard of the tokens, and T, the capacity,
    the queue positions and the means are the global batch's: each
    choice's positions start after every earlier choice's global count
    and the same choice's counts on earlier ``dp`` ranks (an all-gather of
    each rank's (k, E) counts), and the means are summed over ``dp``
    (`psum` then `pbroadcast`: the per-rank losses' gradients reach every
    rank's router). Expert tables of E/ep rows are this ``ep`` rank's
    experts: the expert products run on them and the combine's partial
    sums are summed over ``ep`` (`psum`, whose gradient passes through),
    while the tokens and gates feeding them pass `pbroadcast`, whose
    backward sums the experts' gradients over ``ep``."""
    from ..parallel import collectives as coll

    k = int(k)
    if k < 1:
        raise ValueError("topk_moe: k must be >= 1")
    lead = tuple(data.shape[:-1])
    d = data.shape[-1]
    tokens = data.reshape(-1, d)
    t_local = tokens.shape[0]
    e = gate_weight.shape[0]
    if k > e:
        raise ValueError("topk_moe: k=%d > num_experts=%d" % (k, e))
    dp_ax, ep_ax = _moe_axes()
    ndp = dp_ax.size if dp_ax is not None else 1
    t = t_local * ndp
    cap = max(1, int(capacity_factor * k * t / e))
    e_loc = expert_w_in.shape[0]
    sharded = e_loc != e
    if sharded:
        nep = ep_ax.size if ep_ax is not None else 1
        if e_loc * nep != e:
            raise ValueError("topk_moe: expert tables of %d rows for %d "
                             "experts over ep=%d" % (e_loc, e, nep))
        e0 = ep_ax.index * e_loc
    else:
        e0 = 0

    logits = tokens.float() @ gate_weight.float().t()          # (T, E)
    probs = torch.softmax(logits, dim=-1)
    order = torch.sort(-probs.detach(), dim=-1, stable=True).indices[:, :k]
    gate_vals = probs.gather(1, order)                         # (T, k)
    if normalize_gates and k > 1:
        gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(
            1e-9)

    with torch.no_grad():
        # a comparison, not F.one_hot: its range check syncs the host
        experts = torch.arange(e, device=data.device)
        onehots = [(order[:, j, None] == experts).float() for j in range(k)]
        local = torch.stack([oh.sum(0) for oh in onehots])     # (k, E)
        if ndp > 1:
            every = coll._gather(local, dp_ax)                 # rank order
            before = torch.zeros_like(local)
            for c in every[:dp_ax.index]:
                before = before + c
            total = before
            for c in every[dp_ax.index:]:
                total = total + c
        else:
            before, total = torch.zeros_like(local), local
        counts = torch.zeros(e, device=data.device)
        slots = torch.arange(cap, device=data.device, dtype=torch.float32)
        dispatches = []
        for j, oh in enumerate(onehots):
            pos = (torch.cumsum(oh, 0) - 1.0 + counts + before[j]) * oh
            keep = (pos < cap) & (oh > 0)
            slot = (pos.sum(-1)[:, None] == slots).float()     # (T, C)
            dispatches.append(keep[:, e0:e0 + e_loc].float()[:, :, None]
                              * slot[:, None, :])
            counts = counts + total[j]
        dispatch = dispatches[0]
        for dj in dispatches[1:]:
            dispatch = dispatch + dj
        onehot_sum = onehots[0]
        for oh in onehots[1:]:
            onehot_sum = onehot_sum + oh

    expert_in, gates = tokens, gate_vals
    if sharded and ep_ax.size > 1:
        expert_in = coll.pbroadcast(tokens, "ep")
        gates = coll.pbroadcast(gate_vals, "ep")
    combine = dispatches[0] * gates[:, 0, None, None].float()
    for j in range(1, k):
        combine = combine + dispatches[j] * gates[:, j, None, None].float()

    dt = data.dtype
    xe = torch.einsum("tec,td->ecd", dispatch, expert_in.float()).to(dt)
    ct = torch.promote_types(dt, expert_w_in.dtype)
    he = torch.relu(torch.einsum("ecd,edh->ech", xe.to(ct),
                                 expert_w_in.to(ct)).to(dt))
    ct = torch.promote_types(dt, expert_w_out.dtype)
    ye = torch.einsum("ech,ehd->ecd", he.to(ct), expert_w_out.to(ct)).to(dt)
    out = torch.einsum("tec,ecd->td", combine, ye.float())
    if sharded and ep_ax.size > 1:
        out = coll.psum(out, "ep")
    out = out.to(dt)

    tok_sum, prob_sum = onehot_sum.sum(0), probs.sum(0)
    z_sum = (torch.logsumexp(logits, dim=-1) ** 2).sum()
    if ndp > 1:
        tok_sum = coll._sum(tok_sum, dp_ax)
        prob_sum = coll.pbroadcast(coll.psum(prob_sum, "dp"), "dp")
        z_sum = coll.pbroadcast(coll.psum(z_sum, "dp"), "dp")
    frac_tokens = tok_sum / t / k
    frac_probs = prob_sum / t
    lb = (frac_tokens * frac_probs).sum() * e
    z = z_sum / t
    return out.reshape(lead + (d,)), lb.float(), z.float()
