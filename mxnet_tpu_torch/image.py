"""Image decode and augmentation, and the augmenting image iterators
(counterpart of `mxnet_tpu/image.py`; reference: python/mxnet/image/image.py
and the C++ pipeline src/io/iter_image_recordio_2.cc +
image_aug_default.cc).

Decode and augmentation run on the host, on numpy arrays, as the
reference keeps them on the CPU:

* PNG is decoded and encoded here, with numpy and `zlib`: every filter
  type is undone, so a file from any encoder (Pillow picks filters per
  row) decodes; the encoder writes the Sub filter on every row. Non-PNG
  images (JPEG) go through Pillow where it is installed; without it they
  raise `MXNetError` naming it.
* `imresize` is `torch.nn.functional.interpolate` on host tensors
  (antialiased bilinear), within one uint8 level of Pillow's
  ``BILINEAR``, which the JAX package calls; ``interp=0`` picks Pillow's
  ``NEAREST`` pixels exactly.
* Every random draw comes from an optional ``rng`` (`np.random.RandomState`),
  numpy's global generator by default, as in the JAX package: with one
  decode thread and the same ``np.random.seed`` the crops, flips and
  shuffles equal the JAX package's.

The iterators yield batches of host (CPU) NDArrays, NCHW float32;
`data.DevicePrefetcher` or ``as_in_context`` moves them to the card. The
detection pipeline (``ImageDetIter``, the ``Det*`` augmenters,
``CreateDetAugmenter``) draws from the same ``rng`` or numpy's global
generator, the same numbers in the same order as the JAX package's.
"""
from __future__ import annotations

import io as _io
import json
import os
import struct
import zlib

import numpy as _np
import torch

from .base import MXNetError
from .io import DataBatch, DataDesc, DataIter
from .ndarray import NDArray, array

__all__ = ["imdecode", "imencode", "imread", "imresize", "resize_short",
           "center_crop", "random_crop", "fixed_crop", "color_normalize",
           "Augmenter", "ResizeAug", "RandomCropAug", "CenterCropAug",
           "HorizontalFlipAug", "ColorNormalizeAug", "CastAug",
           "BrightnessJitterAug", "ContrastJitterAug",
           "SaturationJitterAug", "HueJitterAug", "LightingAug",
           "RandomGrayAug", "CreateAugmenter", "ImageIter",
           "ImageRecordIterPy", "DetAugmenter", "DetBorrowAug",
           "DetRandomSelectAug", "DetHorizontalFlipAug", "DetRandomCropAug",
           "DetRandomPadAug", "DetResizeAug", "CreateMultiRandCropAugmenter",
           "CreateDetAugmenter", "ImageDetIter"]

# ---------------------------------------------------------------------------
# PNG, with numpy and zlib
# ---------------------------------------------------------------------------

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# color type -> samples a pixel (8-bit depth)
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _png_chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xffffffff))


def _png_encode(img, level=6):
    """HW, HW1, HW3 or HW4 uint8 -> PNG bytes: 8-bit gray, RGB or RGBA, the
    Sub filter on every row, zlib at ``level``."""
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    ctype = {1: 0, 3: 2, 4: 6}.get(c)
    if ctype is None:
        raise MXNetError("imencode: PNG takes 1, 3 or 4 channels, not %d" % c)
    rows = _np.ascontiguousarray(img, dtype=_np.uint8).reshape(h, w * c)
    filt = _np.empty((h, w * c + 1), _np.uint8)
    filt[:, 0] = 1   # Sub: each byte less the byte one pixel to its left
    filt[:, 1:c + 1] = rows[:, :c]
    _np.subtract(rows[:, c:], rows[:, :-c], out=filt[:, c + 1:])
    ihdr = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    return (_PNG_SIG + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", zlib.compress(filt.tobytes(), level))
            + _png_chunk(b"IEND", b""))


def _unfilter_slow(kind, cur, prev, bpp):
    """Average (3) and Paeth (4) filters, byte by byte (each byte depends
    on the decoded one to its left)."""
    out = bytearray(cur)
    n = len(out)
    if kind == 3:
        for i in range(n):
            left = out[i - bpp] if i >= bpp else 0
            out[i] = (out[i] + ((left + prev[i]) >> 1)) & 0xff
        return out
    for i in range(n):
        a = out[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        if pa <= pb and pa <= pc:
            pred = a
        elif pb <= pc:
            pred = b
        else:
            pred = c
        out[i] = (out[i] + pred) & 0xff
    return out


def _png_unfilter(raw, h, stride, bpp):
    """Undo the per-row filters of the inflated image data -> (h, stride)
    uint8. Rows of filter 0, 1 and 2 are undone with numpy, all at once
    when every row has the same one of them."""
    data = _np.frombuffer(raw, _np.uint8)
    if data.size < h * (stride + 1):
        raise MXNetError("imdecode: truncated PNG image data")
    data = data[:h * (stride + 1)].reshape(h, stride + 1)
    kinds = data[:, 0]
    filt = data[:, 1:]
    if (kinds == kinds[0]).all() and kinds[0] in (0, 1, 2):
        k = int(kinds[0])
        if k == 0:
            return filt.copy()
        if k == 1:
            return _np.cumsum(filt.reshape(h, stride // bpp, bpp), axis=1,
                              dtype=_np.uint8).reshape(h, stride)
        return _np.cumsum(filt, axis=0, dtype=_np.uint8)
    out = _np.empty((h, stride), _np.uint8)
    prev = _np.zeros(stride, _np.uint8)
    for y in range(h):
        k, cur = int(kinds[y]), filt[y]
        if k == 0:
            out[y] = cur
        elif k == 1:
            out[y] = _np.cumsum(cur.reshape(-1, bpp), axis=0,
                                dtype=_np.uint8).reshape(-1)
        elif k == 2:
            _np.add(cur, prev, out=out[y])
        elif k in (3, 4):
            out[y] = _np.frombuffer(bytes(_unfilter_slow(
                k, cur.tobytes(), prev.tobytes(), bpp)), _np.uint8)
        else:
            raise MXNetError("imdecode: bad PNG filter type %d" % k)
        prev = out[y]
    return out


def _luma(rgb):
    """RGB -> L as Pillow converts (ITU-R 601-2, 16-bit fixed point)."""
    r, g, b = (rgb[..., i].astype(_np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16) \
        .astype(_np.uint8)


def _png_decode(buf, flag):
    """PNG bytes -> HW3 (``flag`` != 0) or HW1 uint8, converted as Pillow's
    ``convert("RGB")`` / ``convert("L")`` do: alpha dropped, palettes looked
    up, gray replicated, RGB to luma. Non-interlaced images of 8 bits a
    sample, or 1, 2 or 4 bits of gray or palette index."""
    pos, ihdr, plte, idat = 8, None, None, []
    n = len(buf)
    while pos + 8 <= n:
        length, kind = struct.unpack(">I4s", buf[pos:pos + 8])
        body = buf[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = _np.frombuffer(body, _np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None or not idat:
        raise MXNetError("imdecode: PNG without IHDR or IDAT")
    w, h, depth, ctype, _, _, interlace = ihdr
    low = depth in (1, 2, 4) and ctype in (0, 3)
    if not (depth == 8 or low) or interlace or ctype not in _PNG_CHANNELS:
        raise MXNetError("imdecode: PNG of bit depth %d, color type %d, "
                         "interlace %d is not supported (8-bit, or 1-4 bit "
                         "gray or palette; non-interlaced)"
                         % (depth, ctype, interlace))
    c = _PNG_CHANNELS[ctype]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise MXNetError("imdecode: corrupt PNG data: %s" % e) from None
    if low:
        rows = _png_unfilter(raw, h, (w * depth + 7) // 8, 1)
        bits = _np.unpackbits(rows, axis=1)[:, :w * depth]
        weights = (1 << _np.arange(depth - 1, -1, -1)).astype(_np.uint8)
        px = (bits.reshape(h, w, depth) * weights).sum(axis=2,
                                                       dtype=_np.uint8)
        if ctype == 0:   # scaled to 8 bits, as Pillow reads it
            px = px * _np.uint8(255 // ((1 << depth) - 1))
        px = px[:, :, None]
    else:
        px = _png_unfilter(raw, h, w * c, c).reshape(h, w, c)
    if ctype == 3:
        if plte is None:
            raise MXNetError("imdecode: palette PNG without PLTE")
        px = plte[px[:, :, 0]]
    elif ctype in (4, 6):
        px = px[:, :, :-1]
    if flag:
        return _np.repeat(px, 3, axis=2) if px.shape[2] == 1 else px
    return px if px.shape[2] == 1 else _luma(px)[:, :, None]


def _pil():
    try:
        from PIL import Image
    except ImportError:
        raise MXNetError("decoding or encoding a JPEG (any image but PNG) "
                         "needs Pillow, which is not installed; PNG needs "
                         "nothing beyond numpy") from None
    return Image


# ---------------------------------------------------------------------------
# codec (reference: image.py imdecode / imencode / imread / imresize)
# ---------------------------------------------------------------------------

def imdecode(buf, flag=1, to_rgb=True, to_ndarray=True):
    """Encoded image bytes -> HWC uint8: 3 channels when ``flag`` is set,
    else 1; BGR when ``to_rgb`` is False. An NDArray on `current_context`
    when ``to_ndarray``, else a numpy array (reference: image.py
    imdecode)."""
    buf = bytes(buf)
    if buf[:8] == _PNG_SIG:
        arr = _png_decode(buf, flag)
    else:
        img = _pil().open(_io.BytesIO(buf)).convert("RGB" if flag else "L")
        arr = _np.asarray(img, dtype=_np.uint8)
        if not flag:
            arr = arr[:, :, None]
    if not to_rgb:
        arr = arr[:, :, ::-1]
    if to_ndarray:
        return array(arr, dtype="uint8")
    return arr


def imencode(img, quality=95, fmt=".jpg"):
    """HWC (or HW) uint8 -> encoded bytes: PNG for ``fmt=".png"`` (zlib
    level 6, Pillow's default; ``quality`` does not apply), else JPEG at
    ``quality`` through Pillow."""
    if isinstance(img, NDArray):
        img = img.asnumpy()
    img = _np.asarray(img, dtype=_np.uint8)
    if fmt.lower() == ".png":
        return _png_encode(img)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    out = _io.BytesIO()
    _pil().fromarray(img).save(out, format="JPEG", quality=quality)
    return out.getvalue()


def imread(filename, flag=1, to_rgb=True):
    try:
        with open(filename, "rb") as f:
            buf = f.read()
    except FileNotFoundError:
        raise MXNetError("image file %s not found" % filename) from None
    return imdecode(buf, flag, to_rgb)


def _nearest_index(n_in, n_out):
    """Source index of each output pixel as Pillow's NEAREST picks it: the
    pixel centre, stepped by repeated addition in double precision."""
    step = n_in / n_out
    pos = _np.cumsum(_np.r_[0.5 * step, _np.full(n_out - 1, step)])
    return _np.minimum(pos.astype(_np.int64), n_in - 1)


def imresize(src, w, h, interp=1):
    """Resize an HWC image to ``w`` x ``h`` (reference: image.py imresize):
    for ``interp=0`` the pixels Pillow's NEAREST picks, else antialiased
    bilinear (`torch.nn.functional.interpolate`), within one level of
    Pillow's BILINEAR. Numpy in, uint8 numpy out; NDArray in, uint8 NDArray
    out on the same device."""
    was_nd = isinstance(src, NDArray)
    arr = src.asnumpy() if was_nd else _np.asarray(src)
    squeeze = arr.ndim == 2
    if squeeze:
        arr = arr[:, :, None]
    arr = _np.ascontiguousarray(arr, dtype=_np.uint8)
    if interp == 0:
        out = arr[_nearest_index(arr.shape[0], h)][
            :, _nearest_index(arr.shape[1], w)]
    else:
        t = torch.from_numpy(arr).permute(2, 0, 1)[None]
        out = torch.nn.functional.interpolate(t, size=(h, w),
                                              mode="bilinear",
                                              align_corners=False,
                                              antialias=True)
        out = out[0].permute(1, 2, 0).contiguous().numpy()
    if squeeze:
        out = out[:, :, 0]
    if was_nd:
        return array(out, ctx=src.context, dtype="uint8")
    return out


# ---------------------------------------------------------------------------
# crops (reference: image.py resize_short ... color_normalize)
# ---------------------------------------------------------------------------

def _rng(rng):
    return _np.random if rng is None else rng


def resize_short(src, size, interp=2):
    h, w = src.shape[0], src.shape[1]
    if h > w:
        new_h, new_w = size * h // w, size
    else:
        new_h, new_w = size, size * w // h
    return imresize(src, new_w, new_h, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    out = src[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        out = imresize(out, size[0], size[1], interp)
    return out


def random_crop(src, size, interp=2, rng=None):
    h, w = src.shape[0], src.shape[1]
    new_w, new_h = size
    r = _rng(rng)
    x0 = r.randint(0, max(w - new_w, 0) + 1)
    y0 = r.randint(0, max(h - new_h, 0) + 1)
    out = fixed_crop(src, x0, y0, min(new_w, w), min(new_h, h), size, interp)
    return out, (x0, y0, new_w, new_h)


def center_crop(src, size, interp=2):
    h, w = src.shape[0], src.shape[1]
    new_w, new_h = size
    x0 = max((w - new_w) // 2, 0)
    y0 = max((h - new_h) // 2, 0)
    out = fixed_crop(src, x0, y0, min(new_w, w), min(new_h, h), size, interp)
    return out, (x0, y0, new_w, new_h)


def color_normalize(src, mean, std=None):
    if mean is not None:
        src = src - mean
    if std is not None:
        src = src / std
    return src


# ---------------------------------------------------------------------------
# augmenters (reference: image.py Augmenter ... CreateAugmenter)
# ---------------------------------------------------------------------------

def _apply_np(src, fn):
    """``fn`` on ``src`` in float32, on the host; a uint8 source is clipped
    to [0, 255] and cast back. The result has ``src``'s container (an
    NDArray on its device, or numpy)."""
    arr = src.asnumpy() if isinstance(src, NDArray) else _np.asarray(src)
    out = fn(arr.astype(_np.float32))
    if arr.dtype == _np.uint8:
        out = out.clip(0, 255).astype(_np.uint8)
    if isinstance(src, NDArray):
        return array(out, ctx=src.context, dtype=str(out.dtype))
    return out


class Augmenter:
    """Base augmenter (reference: image.py Augmenter)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, src):
        raise NotImplementedError


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2, rng=None):
        super().__init__(size=size, interp=interp)
        self.size = size if isinstance(size, tuple) else (size, size)
        self.interp = interp
        self.rng = rng

    def __call__(self, src):
        return random_crop(src, self.size, self.interp, self.rng)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size if isinstance(size, tuple) else (size, size)
        self.interp = interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p, rng=None):
        super().__init__(p=p)
        self.p = p
        self.rng = rng

    def __call__(self, src):
        if _rng(self.rng).rand() < self.p:
            if isinstance(src, NDArray):
                return src.flip(axis=1)
            return src[:, ::-1]
        return src


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        return src.astype(self.typ)


class ColorNormalizeAug(Augmenter):
    """``(src - mean) / std`` in float32; mean and std broadcast over the
    channels of an HWC image."""

    def __init__(self, mean, std):
        super().__init__(mean=mean, std=std)
        self.mean = None if mean is None else _np.asarray(mean, _np.float32)
        self.std = None if std is None else _np.asarray(std, _np.float32)

    def __call__(self, src):
        if isinstance(src, NDArray):
            dev = src.context
            mean = None if self.mean is None else array(self.mean, ctx=dev)
            std = None if self.std is None else array(self.std, ctx=dev)
            return color_normalize(src, mean, std)
        return color_normalize(src, self.mean, self.std)


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness, rng=None):
        super().__init__(brightness=brightness)
        self.brightness = brightness
        self.rng = rng

    def __call__(self, src):
        alpha = 1.0 + _rng(self.rng).uniform(-self.brightness,
                                             self.brightness)
        return (src * alpha).clip(0, 255)


class ContrastJitterAug(Augmenter):
    def __init__(self, contrast, rng=None):
        super().__init__(contrast=contrast)
        self.contrast = contrast
        self.rng = rng

    def __call__(self, src):
        alpha = 1.0 + _rng(self.rng).uniform(-self.contrast, self.contrast)
        gray = float(src.mean())
        return (src * alpha + gray * (1 - alpha)).clip(0, 255)


_GRAY_COEF = _np.array([0.299, 0.587, 0.114], _np.float32)


class SaturationJitterAug(Augmenter):
    """Blend with the per-pixel gray (reference: image.py
    SaturationJitterAug)."""

    def __init__(self, saturation, rng=None):
        super().__init__(saturation=saturation)
        self.saturation = saturation
        self.rng = rng

    def __call__(self, src):
        alpha = 1.0 + _rng(self.rng).uniform(-self.saturation,
                                             self.saturation)

        def fn(a):
            gray = (a * _GRAY_COEF).sum(axis=2, keepdims=True)
            return a * alpha + gray * (1.0 - alpha)

        return _apply_np(src, fn)


class HueJitterAug(Augmenter):
    """Hue rotation in YIQ space (reference: image.py HueJitterAug)."""

    _TYIQ = _np.array([[0.299, 0.587, 0.114],
                       [0.596, -0.274, -0.321],
                       [0.211, -0.523, 0.311]], _np.float32)
    _ITYIQ = _np.array([[1.0, 0.956, 0.621],
                        [1.0, -0.272, -0.647],
                        [1.0, -1.107, 1.705]], _np.float32)

    def __init__(self, hue, rng=None):
        super().__init__(hue=hue)
        self.hue = hue
        self.rng = rng

    def __call__(self, src):
        alpha = _rng(self.rng).uniform(-self.hue, self.hue)
        u = _np.cos(alpha * _np.pi)
        w = _np.sin(alpha * _np.pi)
        bt = _np.array([[1.0, 0.0, 0.0], [0.0, u, -w], [0.0, w, u]],
                       _np.float32)
        t = self._ITYIQ.dot(bt).dot(self._TYIQ).T
        return _apply_np(src, lambda a: a.dot(t))


class LightingAug(Augmenter):
    """AlexNet-style PCA lighting noise (reference: image.py
    LightingAug)."""

    def __init__(self, alphastd, eigval=None, eigvec=None, rng=None):
        super().__init__(alphastd=alphastd)
        self.alphastd = alphastd
        self.eigval = _np.asarray(eigval, _np.float32) if eigval is not None \
            else _np.array([55.46, 4.794, 1.148], _np.float32)
        self.eigvec = _np.asarray(eigvec, _np.float32) if eigvec is not None \
            else _np.array([[-0.5675, 0.7192, 0.4009],
                            [-0.5808, -0.0045, -0.8140],
                            [-0.5836, -0.6948, 0.4203]], _np.float32)
        self.rng = rng

    def __call__(self, src):
        alpha = _rng(self.rng).normal(0, self.alphastd, size=(3,))
        rgb = self.eigvec.dot(alpha * self.eigval).astype(_np.float32)
        return _apply_np(src, lambda a: a + rgb)


class RandomGrayAug(Augmenter):
    """Grayscale with probability ``p`` (reference: image.py
    RandomGrayAug)."""

    def __init__(self, p, rng=None):
        super().__init__(p=p)
        self.p = p
        self.rng = rng

    def __call__(self, src):
        if _rng(self.rng).rand() >= self.p:
            return src

        def fn(a):
            gray = (a * _GRAY_COEF).sum(axis=2, keepdims=True)
            return _np.broadcast_to(gray, a.shape).copy()

        return _apply_np(src, fn)


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0, rand_gray=0,
                    inter_method=2, rng=None):
    """The standard augmentation chain, in image_aug_default.cc's order
    (reference: image.py CreateAugmenter); the random ones draw from
    ``rng``."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method, rng=rng))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5, rng=rng))
    auglist.append(CastAug())
    if brightness:
        auglist.append(BrightnessJitterAug(brightness, rng=rng))
    if contrast:
        auglist.append(ContrastJitterAug(contrast, rng=rng))
    if saturation:
        auglist.append(SaturationJitterAug(saturation, rng=rng))
    if hue:
        auglist.append(HueJitterAug(hue, rng=rng))
    if pca_noise:
        auglist.append(LightingAug(pca_noise, rng=rng))
    if rand_gray:
        auglist.append(RandomGrayAug(rand_gray, rng=rng))
    if mean is True:
        mean = _np.array([123.68, 116.28, 103.53])
    if std is True:
        std = _np.array([58.395, 57.12, 57.375])
    if mean is not None and (isinstance(mean, _np.ndarray) or mean):
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


# ---------------------------------------------------------------------------
# iterators (reference: image.py ImageIter; iter_image_recordio_2.cc)
# ---------------------------------------------------------------------------

class ImageIter(DataIter):
    """Augmenting image iterator over a ``.rec`` file (``path_imgrec``,
    random access when its ``.idx`` sibling exists) or an image list
    (``path_imglist`` / ``imglist`` under ``path_root``) (reference:
    image.py ImageIter). Batches are host NDArrays: data (N, C, H, W)
    float32, label (N,) or (N, label_width); the last batch is filled by
    cycling its samples and carries ``pad``."""

    def __init__(self, batch_size, data_shape, label_width=1, path_imgrec=None,
                 path_imglist=None, path_root="", shuffle=False, aug_list=None,
                 imglist=None, data_name="data", label_name="softmax_label",
                 rng=None, **kwargs):
        super().__init__(batch_size)
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.data_name = data_name
        self.label_name = label_name
        self.rng = rng
        self.auglist = aug_list if aug_list is not None else \
            CreateAugmenter(data_shape, rng=rng,
                            **{k: v for k, v in kwargs.items()
                               if k in ("resize", "rand_crop", "rand_mirror",
                                        "mean", "std")})
        self.record = None
        self.imglist = None
        if path_imgrec is not None:
            from . import recordio

            if not os.path.exists(path_imgrec):
                raise MXNetError("record file %s not found" % path_imgrec)
            idx = os.path.splitext(path_imgrec)[0] + ".idx"
            if os.path.exists(idx):
                self.record = recordio.MXIndexedRecordIO(idx, path_imgrec,
                                                         "r")
                self.seq = list(self.record.keys)
            else:
                # no index: a sequential stream (shuffle needs the index)
                if shuffle:
                    raise MXNetError(
                        "ImageIter: shuffle requires an index file (%s)"
                        % idx)
                self.record = recordio.MXRecordIO(path_imgrec, "r")
                self.seq = None
        elif path_imglist is not None or imglist is not None:
            items = []
            if path_imglist is not None:
                with open(path_imglist) as f:
                    for line in f:
                        parts = line.strip().split("\t")
                        label = [float(x) for x in parts[1:-1]]
                        items.append((parts[-1], label))
            else:
                for entry in imglist:
                    items.append((entry[-1], [float(x) for x in entry[:-1]]))
            self.imglist = items
            self.path_root = path_root
            self.seq = list(range(len(items)))
        else:
            raise MXNetError("ImageIter needs path_imgrec, path_imglist or "
                             "imglist")
        self.shuffle = shuffle
        self.cur = 0
        if shuffle and self.seq is not None:
            _rng(rng).shuffle(self.seq)

    @property
    def provide_data(self):
        return [DataDesc(self.data_name, (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self.label_width == 1 \
            else (self.batch_size, self.label_width)
        return [DataDesc(self.label_name, shape)]

    def reset(self):
        self.cur = 0
        if self.seq is None:
            self.record.reset()   # sequential: rewind the stream
        elif self.shuffle:
            _rng(self.rng).shuffle(self.seq)

    def _next_raw(self):
        """The next sample undecoded: ("rec", record bytes) or ("img",
        (file name, label)). Record readers are not thread-safe, so this
        stage runs on one thread."""
        if self.seq is None:
            s = self.record.read()
            if s is None:
                raise StopIteration
            return ("rec", s)
        if self.cur >= len(self.seq):
            raise StopIteration
        idx = self.seq[self.cur]
        self.cur += 1
        if self.record is not None:
            return ("rec", self.record.read_idx(idx))
        return ("img", self.imglist[idx])

    def _decode_raw(self, raw):
        """Decode and augment one raw sample -> (CHW float32, label)."""
        kind, payload = raw
        if kind == "rec":
            from . import recordio

            header, buf = recordio.unpack(payload)
            label, img = header.label, imdecode(buf, to_ndarray=False)
        else:
            fname, label = payload
            with open(os.path.join(self.path_root, fname), "rb") as f:
                img = imdecode(f.read(), to_ndarray=False)
        for aug in self.auglist:
            img = aug(img)
        arr = img.asnumpy() if isinstance(img, NDArray) else img
        data = _np.transpose(arr.astype(_np.float32), (2, 0, 1))
        lab = _np.asarray(label, dtype=_np.float32).reshape(-1)
        return data, (lab[0] if self.label_width == 1 else
                      lab[: self.label_width])

    def next_sample(self):
        """The next sample's (label, decoded HWC uint8 NDArray)."""
        kind, payload = self._next_raw()
        if kind == "rec":
            from . import recordio

            header, buf = recordio.unpack(payload)
            return header.label, imdecode(buf)
        fname, label = payload
        return _np.asarray(label), imread(os.path.join(self.path_root, fname))

    def _assemble(self, get):
        """One batch from ``get()`` (decoded samples in source order; a
        StopIteration ends the stream), the tail filled by cycling."""
        batch_data = []
        batch_label = []
        pad = 0
        for _ in range(self.batch_size):
            try:
                data, lab = get()
            except StopIteration:
                if not batch_data:
                    raise
                pad = self.batch_size - len(batch_data)
                k = 0
                while len(batch_data) < self.batch_size:
                    # cycle: pad may exceed the collected count
                    batch_data.append(batch_data[k])
                    batch_label.append(batch_label[k])
                    k += 1
                break
            batch_data.append(data)
            batch_label.append(lab)
        # stacked once, straight into the host tensors of the batch
        return DataBatch(data=[NDArray(torch.from_numpy(
                             _np.stack(batch_data)))],
                         label=[NDArray(torch.from_numpy(
                             _np.stack(batch_label)))],
                         pad=pad)

    def next(self):
        return self._assemble(lambda: self._decode_raw(self._next_raw()))


class ImageRecordIterPy(ImageIter):
    """The threaded augmenting RecordIO iterator behind `io.ImageRecordIter`
    (reference: iter_image_recordio_2.cc:766 + iter_prefetcher.h): the
    reader on one thread, ``preprocess_threads`` `data.DecodePool` workers
    decoding and augmenting, batches assembled ``prefetch_buffer`` ahead
    by a `data.PrefetchBuffer`. Delivery keeps the source order, so with
    one thread the batches equal `ImageIter`'s."""

    def __init__(self, path_imgrec, data_shape, batch_size, shuffle=False,
                 rand_crop=False, rand_mirror=False, mean=(0, 0, 0),
                 std=(1, 1, 1), resize=-1, label_width=1, preprocess_threads=4,
                 prefetch_buffer=4, rng=None, **kwargs):
        mean_arr = _np.asarray(mean, _np.float32).reshape(1, 1, 3) \
            if any(m != 0 for m in mean) else None
        std_arr = _np.asarray(std, _np.float32).reshape(1, 1, 3) \
            if any(s != 1 for s in std) else None
        aug_list = CreateAugmenter(data_shape, resize=max(resize, 0),
                                   rand_crop=rand_crop, rand_mirror=rand_mirror,
                                   mean=mean_arr, std=std_arr, rng=rng)
        super().__init__(batch_size, data_shape, label_width=label_width,
                         path_imgrec=path_imgrec, shuffle=shuffle,
                         aug_list=aug_list, rng=rng)
        self._threads = max(1, preprocess_threads)
        self._buffer = max(1, prefetch_buffer)
        self._pool = None
        self._buf = None

    def _start(self):
        from .data.core import DecodePool, PrefetchBuffer

        pool = DecodePool(self._next_raw, self._decode_raw,
                          workers=self._threads,
                          depth=max(2, 2 * self._threads),
                          owner="ImageRecordIter.reset")
        self._pool = pool
        self._buf = PrefetchBuffer(lambda: self._assemble(pool.get),
                                   depth=self._buffer,
                                   name="mxtpu-image-prefetch",
                                   owner="ImageRecordIter.reset",
                                   src="image")

    def close(self):
        """Stop and join the reader, decode workers and batch producer."""
        if self._buf is not None:
            self._buf.close()
            self._pool.close()
            self._buf = None
            self._pool = None

    def reset(self):
        # stop and join the whole pipeline BEFORE touching the reader: a
        # live worker would race the rewind and feed stale samples into
        # the next epoch
        self.close()
        super().reset()

    def next(self):
        if self._buf is None:
            self._start()
        return self._buf.get()


# ---------------------------------------------------------------------------
# the detection pipeline (reference: python/mxnet/image/detection.py and
# src/io/iter_image_det_recordio.cc). A label is (N, 5+) rows [cls, x1, y1,
# x2, y2, ...] of normalized corners.
# ---------------------------------------------------------------------------

class DetAugmenter:
    """Detection augmenter base (reference: detection.py:39): called with
    (image HWC numpy, label (N, 5+)), returns both."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        return json.dumps([self.__class__.__name__, self._kwargs])

    def __call__(self, src, label):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """An image-only `Augmenter` that keeps the geometry (color, cast,
    normalize) applied to the image; the label passes through (reference:
    detection.py:65)."""

    def __init__(self, augmenter):
        super().__init__(augmenter=augmenter.__class__.__name__)
        self.augmenter = augmenter

    def __call__(self, src, label):
        return self.augmenter(src), label


class DetRandomSelectAug(DetAugmenter):
    """One augmenter of ``aug_list`` picked at random, or none with
    probability ``skip_prob`` (reference: detection.py:90)."""

    def __init__(self, aug_list, skip_prob=0.0, rng=None):
        super().__init__(skip_prob=skip_prob)
        self.aug_list = list(aug_list)
        self.skip_prob = skip_prob
        self.rng = rng

    def __call__(self, src, label):
        r = _rng(self.rng)
        if not self.aug_list or r.random_sample() < self.skip_prob:
            return src, label
        return self.aug_list[r.randint(len(self.aug_list))](src, label)


class DetHorizontalFlipAug(DetAugmenter):
    """Mirror the image and its boxes with probability ``p`` (reference:
    detection.py:126)."""

    def __init__(self, p=0.5, rng=None):
        super().__init__(p=p)
        self.p = p
        self.rng = rng

    def __call__(self, src, label):
        if _rng(self.rng).random_sample() < self.p:
            src = _np.asarray(src)[:, ::-1]
            label = label.copy()
            label[:, 1], label[:, 3] = 1.0 - label[:, 3], \
                1.0 - label[:, 1].copy()
        return src, label


def _box_coverage(boxes, crop):
    """The share of each box's area (N, 4 normalized corners) inside
    ``crop`` (x1, y1, x2, y2)."""
    ix1 = _np.maximum(boxes[:, 0], crop[0])
    iy1 = _np.maximum(boxes[:, 1], crop[1])
    ix2 = _np.minimum(boxes[:, 2], crop[2])
    iy2 = _np.minimum(boxes[:, 3], crop[3])
    inter = _np.maximum(ix2 - ix1, 0) * _np.maximum(iy2 - iy1, 0)
    area = _np.maximum((boxes[:, 2] - boxes[:, 0])
                       * (boxes[:, 3] - boxes[:, 1]), 1e-12)
    return inter / area


class DetRandomCropAug(DetAugmenter):
    """SSD's constrained random crop (reference: detection.py:152): up to
    ``max_attempts`` crops drawn in the area and aspect ranges; the first
    whose kept objects are each covered at least ``min_object_covered``
    wins. An object whose centre falls outside, or whose coverage is below
    ``min_eject_coverage``, leaves the label."""

    def __init__(self, min_object_covered=0.1, aspect_ratio_range=(0.75, 1.33),
                 area_range=(0.05, 1.0), min_eject_coverage=0.3,
                 max_attempts=50, rng=None):
        super().__init__(min_object_covered=min_object_covered,
                         aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range,
                         min_eject_coverage=min_eject_coverage,
                         max_attempts=max_attempts)
        self.min_object_covered = min_object_covered
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.min_eject_coverage = min_eject_coverage
        self.max_attempts = max_attempts
        self.rng = rng

    def _try_crop(self, label):
        r = _rng(self.rng)
        area = r.uniform(*self.area_range)
        ratio = r.uniform(*self.aspect_ratio_range)
        w = min(_np.sqrt(area * ratio), 1.0)
        h = min(_np.sqrt(area / ratio), 1.0)
        x0 = r.uniform(0, 1 - w)
        y0 = r.uniform(0, 1 - h)
        crop = (x0, y0, x0 + w, y0 + h)
        boxes = label[:, 1:5]
        cov = _box_coverage(boxes, crop)
        cx = (boxes[:, 0] + boxes[:, 2]) / 2
        cy = (boxes[:, 1] + boxes[:, 3]) / 2
        keep = ((cx >= crop[0]) & (cx <= crop[2]) & (cy >= crop[1])
                & (cy <= crop[3]) & (cov >= self.min_eject_coverage))
        if not keep.any() or cov[keep].min() < self.min_object_covered:
            return None
        new = label[keep].copy()
        b = new[:, 1:5]
        b[:, (0, 2)] = (b[:, (0, 2)] - crop[0]) / max(crop[2] - crop[0],
                                                     1e-12)
        b[:, (1, 3)] = (b[:, (1, 3)] - crop[1]) / max(crop[3] - crop[1],
                                                     1e-12)
        new[:, 1:5] = _np.clip(b, 0.0, 1.0)
        return crop, new

    def __call__(self, src, label):
        for _ in range(self.max_attempts):
            got = self._try_crop(label)
            if got is None:
                continue
            crop, new_label = got
            src = _np.asarray(src)
            h, w = src.shape[:2]
            x1 = int(round(crop[0] * w))
            y1 = int(round(crop[1] * h))
            x2 = max(int(round(crop[2] * w)), x1 + 1)
            y2 = max(int(round(crop[3] * h)), y1 + 1)
            return src[y1:y2, x1:x2], new_label
        return src, label


class DetRandomPadAug(DetAugmenter):
    """Zoom out: the image placed at random on a canvas of ``pad_val``
    whose area is drawn from ``area_range`` (reference: detection.py:323);
    the boxes shrink with it."""

    def __init__(self, aspect_ratio_range=(0.75, 1.33), area_range=(1.0, 3.0),
                 max_attempts=50, pad_val=(127, 127, 127), rng=None):
        super().__init__(aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range, max_attempts=max_attempts,
                         pad_val=pad_val)
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts
        self.pad_val = pad_val
        self.rng = rng

    def __call__(self, src, label):
        r = _rng(self.rng)
        src = _np.asarray(src)
        h, w = src.shape[:2]
        for _ in range(self.max_attempts):
            area = r.uniform(*self.area_range)
            ratio = r.uniform(*self.aspect_ratio_range)
            nw = _np.sqrt(area * ratio)
            nh = _np.sqrt(area / ratio)
            if nw < 1 or nh < 1:
                continue
            pw = int(round(w * nw))
            ph = int(round(h * nh))
            x0 = r.randint(0, pw - w + 1)
            y0 = r.randint(0, ph - h + 1)
            canvas = _np.empty((ph, pw, src.shape[2]), dtype=src.dtype)
            canvas[:] = _np.asarray(self.pad_val, dtype=src.dtype)
            canvas[y0:y0 + h, x0:x0 + w] = src
            label = label.copy()
            b = label[:, 1:5]
            b[:, (0, 2)] = (b[:, (0, 2)] * w + x0) / pw
            b[:, (1, 3)] = (b[:, (1, 3)] * h + y0) / ph
            label[:, 1:5] = b
            return canvas, label
        return src, label


class DetResizeAug(DetAugmenter):
    """Resize to ``size`` (w, h); normalized boxes are unchanged."""

    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src, label):
        return imresize(src, self.size[0], self.size[1], self.interp), label


def CreateMultiRandCropAugmenter(min_object_covered=0.1,
                                 aspect_ratio_range=(0.75, 1.33),
                                 area_range=(0.05, 1.0),
                                 min_eject_coverage=0.3, max_attempts=50,
                                 skip_prob=0.0, rng=None):
    """One `DetRandomCropAug` a constraint set (lists cycle to the longest),
    one picked at random a call (reference: detection.py:417)."""
    def _as_list(v):
        return v if isinstance(v, (list, tuple)) and v and \
            isinstance(v[0], (list, tuple)) else [v]

    def _listed(v):
        return v if isinstance(v, (list, tuple)) else [v]

    covered = _listed(min_object_covered)
    aspects = _as_list(aspect_ratio_range)
    areas = _as_list(area_range)
    ejects = _listed(min_eject_coverage)
    n = max(len(covered), len(aspects), len(areas), len(ejects))

    def _at(seq, i):
        return seq[i % len(seq)]

    augs = [DetRandomCropAug(_at(covered, i), _at(aspects, i), _at(areas, i),
                             _at(ejects, i), max_attempts, rng=rng)
            for i in range(n)]
    return DetRandomSelectAug(augs, skip_prob=skip_prob, rng=rng)


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_pad=0,
                       rand_gray=0, rand_mirror=False, mean=None, std=None,
                       brightness=0, contrast=0, saturation=0, pca_noise=0,
                       hue=0, inter_method=2, min_object_covered=0.1,
                       aspect_ratio_range=(0.75, 1.33), area_range=(0.05, 3.0),
                       min_eject_coverage=0.3, max_attempts=50,
                       pad_val=(127, 127, 127), rng=None):
    """The detection augmentation chain (reference: detection.py:482): color
    jitter, random crop (probability ``rand_crop``), random pad
    (``rand_pad``), mirror, resize to ``data_shape``, cast and normalize."""
    auglist = []
    if resize > 0:
        auglist.append(DetBorrowAug(ResizeAug(resize, inter_method)))
    if brightness:
        auglist.append(DetBorrowAug(BrightnessJitterAug(brightness, rng)))
    if contrast:
        auglist.append(DetBorrowAug(ContrastJitterAug(contrast, rng)))
    if saturation:
        auglist.append(DetBorrowAug(SaturationJitterAug(saturation, rng)))
    if hue:
        auglist.append(DetBorrowAug(HueJitterAug(hue, rng)))
    if pca_noise:
        auglist.append(DetBorrowAug(LightingAug(pca_noise, rng=rng)))
    if rand_gray:
        auglist.append(DetBorrowAug(RandomGrayAug(rand_gray, rng)))
    if rand_crop > 0:
        auglist.append(CreateMultiRandCropAugmenter(
            min_object_covered, aspect_ratio_range,
            (area_range[0], min(area_range[1], 1.0)), min_eject_coverage,
            max_attempts, skip_prob=1 - rand_crop, rng=rng))
    if rand_pad > 0:
        pad = DetRandomPadAug(aspect_ratio_range,
                              (1.0, max(area_range[1], 1.0)), max_attempts,
                              pad_val, rng=rng)
        auglist.append(DetRandomSelectAug([pad], skip_prob=1 - rand_pad,
                                          rng=rng))
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5, rng=rng))
    auglist.append(DetResizeAug((data_shape[2], data_shape[1]), inter_method))
    auglist.append(DetBorrowAug(CastAug()))
    if mean is True:
        mean = _np.array([123.68, 116.28, 103.53])
    if std is True:
        std = _np.array([58.395, 57.12, 57.375])
    if mean is not None and (isinstance(mean, _np.ndarray) or mean):
        auglist.append(DetBorrowAug(ColorNormalizeAug(mean, std)))
    return auglist


class ImageDetIter(ImageIter):
    """Detection iterator over a ``.rec`` or an image list (reference:
    detection.py:624, iter_image_det_recordio.cc). A label is in im2rec's
    detection format, ``[header_width, obj_width, (extras...), obj0...,
    obj1...]``, each object ``[cls, x1, y1, x2, y2, ...]`` normalized;
    degenerate boxes are dropped, and a sample with none is skipped. The
    batch's label is (N, max objects, width), padded with -1 rows to the
    most objects of any sample, found at construction from the labels
    alone (record headers; no image is decoded). Batches are host
    NDArrays, as `ImageIter`'s."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imglist=None, path_root="", shuffle=False,
                 aug_list=None, imglist=None, data_name="data",
                 label_name="label", rng=None, **kwargs):
        super().__init__(batch_size, data_shape, label_width=1,
                         path_imgrec=path_imgrec, path_imglist=path_imglist,
                         path_root=path_root, shuffle=shuffle, aug_list=[],
                         imglist=imglist, data_name=data_name,
                         label_name=label_name, rng=rng)
        self.auglist = aug_list if aug_list is not None else \
            CreateDetAugmenter(data_shape, rng=rng, **kwargs)
        self.label_shape = self._estimate_label_shape()

    @staticmethod
    def _parse_label(label):
        """Strip the header, reshape to (N, obj_width), drop degenerate
        boxes (reference: detection.py _parse_label)."""
        raw = _np.asarray(label, dtype=_np.float32).ravel()
        if raw.size < 7:
            raise MXNetError("detection label too short: %d" % raw.size)
        header_width = int(raw[0])
        obj_width = int(raw[1])
        if obj_width < 5 or (raw.size - header_width) % obj_width != 0:
            raise MXNetError("label shape %s inconsistent with obj width %d"
                             % (raw.shape, obj_width))
        out = raw[header_width:].reshape(-1, obj_width)
        valid = (out[:, 3] > out[:, 1]) & (out[:, 4] > out[:, 2])
        if not valid.any():
            raise MXNetError("sample with no valid box")
        return out[valid]

    def _raw_labels(self):
        """Every sample's raw label, from the record headers or the list,
        decoding no image; a sequential record is rewound after."""
        from . import recordio

        if self.seq is None:
            try:
                while True:
                    s = self.record.read()
                    if s is None:
                        break
                    yield recordio.unpack(s)[0].label
            finally:
                self.record.reset()
            return
        for idx in self.seq:
            if self.record is not None:
                yield recordio.unpack(self.record.read_idx(idx))[0].label
            else:
                yield _np.asarray(self.imglist[idx][1], dtype=_np.float32)

    def _estimate_label_shape(self):
        max_count, width = 0, 5
        for label in self._raw_labels():
            try:
                lab = self._parse_label(label)
            except MXNetError:
                continue   # next() skips it too
            max_count = max(max_count, lab.shape[0])
            width = lab.shape[1]
        return (max_count, width)

    @property
    def provide_label(self):
        return [DataDesc(self.label_name,
                         (self.batch_size,) + self.label_shape)]

    def reshape(self, data_shape=None, label_shape=None):
        if data_shape is not None:
            self.data_shape = tuple(data_shape)
        if label_shape is not None:
            self.label_shape = tuple(label_shape)

    def _next_det(self):
        """The next sample with a valid box: (label (N, 5+), HWC uint8
        numpy), decoded on the host."""
        while True:
            kind, payload = self._next_raw()
            if kind == "rec":
                from . import recordio

                header, buf = recordio.unpack(payload)
                label = header.label
            else:
                fname, label = payload
                with open(os.path.join(self.path_root, fname), "rb") as f:
                    buf = f.read()
            try:
                lab = self._parse_label(label)
            except MXNetError:
                continue
            return lab, imdecode(buf, to_ndarray=False)

    def next(self):
        batch_data, batch_label = [], []
        pad = 0
        while len(batch_data) < self.batch_size:
            try:
                lab, img = self._next_det()
            except StopIteration:
                if not batch_data:
                    raise
                pad = self.batch_size - len(batch_data)
                k = 0
                while len(batch_data) < self.batch_size:
                    batch_data.append(batch_data[k])
                    batch_label.append(batch_label[k])
                    k += 1
                break
            for aug in self.auglist:
                img, lab = aug(img, lab)
            arr = img.asnumpy() if isinstance(img, NDArray) else \
                _np.asarray(img)
            batch_data.append(_np.transpose(arr.astype(_np.float32),
                                            (2, 0, 1)))
            padded = _np.full(self.label_shape, -1.0, _np.float32)
            n = min(lab.shape[0], self.label_shape[0])
            padded[:n, :lab.shape[1]] = lab[:n]
            batch_label.append(padded)
        return DataBatch(data=[NDArray(torch.from_numpy(
                             _np.stack(batch_data)))],
                         label=[NDArray(torch.from_numpy(
                             _np.stack(batch_label)))],
                         pad=pad)
