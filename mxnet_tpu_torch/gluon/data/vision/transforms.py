"""Vision transforms (counterpart of
`mxnet_tpu/gluon/data/vision/transforms.py`; reference:
python/mxnet/gluon/data/vision/transforms.py).

Each transform takes an HWC image (or a batch, where the reference allows
one) as an NDArray, computing where it lies, or as numpy, computing on the
host and giving numpy back. Random draws come from numpy's global
generator, as in the JAX package. ``ToTensor`` and ``Normalize`` are the
``mx.nd.image`` ops, which divide by tensors, so a card and a host call
round alike.
"""
from __future__ import annotations

import numpy as _np

from ....base import MXNetError
from ....context import cpu
from .... import ndarray as nd
from ....ndarray import NDArray, array
from ...block import Block, HybridBlock
from ...nn import Sequential

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize", "CenterCrop",
           "CropResize", "RandomResizedCrop", "RandomFlipLeftRight",
           "RandomFlipTopBottom", "RandomBrightness", "RandomContrast",
           "RandomSaturation", "RandomHue", "RandomColorJitter",
           "RandomLighting"]


class _NumpyIn:
    """Numpy in: the transform on a host NDArray, numpy out."""

    def __call__(self, x, *args):
        if isinstance(x, _np.ndarray):
            out = super().__call__(array(x, ctx=cpu(), dtype=str(x.dtype)),
                                   *args)
            return out.asnumpy() if isinstance(out, NDArray) else out
        return super().__call__(x, *args)


class Compose(Sequential):
    """Chain transforms (reference: transforms.py Compose)."""

    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.add(t)


class Cast(_NumpyIn, HybridBlock):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def hybrid_forward(self, F, x):
        return F.Cast(x, dtype=self._dtype)


class ToTensor(_NumpyIn, HybridBlock):
    """HWC uint8 in [0, 255] -> CHW float32 in [0, 1] (reference:
    transforms.py ToTensor)."""

    def hybrid_forward(self, F, x):
        return F.image.to_tensor(x)


class Normalize(_NumpyIn, HybridBlock):
    """Per-channel ``(x - mean) / std`` of a CHW or NCHW float image."""

    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = mean
        self._std = std

    def hybrid_forward(self, F, x):
        return F.image.normalize(x, mean=self._mean, std=self._std)


class Resize(_NumpyIn, Block):
    """Resize to ``size`` (an int: a square; or (w, h)), bilinear, as the
    JAX package does whatever ``keep_ratio`` and ``interpolation`` say."""

    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size

    def forward(self, x):
        from .... import image

        return image.imresize(x, self._size[0], self._size[1])


class CenterCrop(_NumpyIn, Block):
    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size

    def forward(self, x):
        h, w = x.shape[0], x.shape[1]
        cw, ch = self._size
        x0 = max((w - cw) // 2, 0)
        y0 = max((h - ch) // 2, 0)
        return x[y0:y0 + ch, x0:x0 + cw]


class RandomResizedCrop(_NumpyIn, Block):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size
        self._scale = scale
        self._ratio = ratio

    def forward(self, x):
        from .... import image

        h, w = x.shape[0], x.shape[1]
        area = h * w
        for _ in range(10):
            target_area = _np.random.uniform(*self._scale) * area
            aspect = _np.random.uniform(*self._ratio)
            cw = int(round(_np.sqrt(target_area * aspect)))
            ch = int(round(_np.sqrt(target_area / aspect)))
            if cw <= w and ch <= h:
                x0 = _np.random.randint(0, w - cw + 1)
                y0 = _np.random.randint(0, h - ch + 1)
                crop = x[y0:y0 + ch, x0:x0 + cw]
                return image.imresize(crop, self._size[0], self._size[1])
        return image.imresize(x, self._size[0], self._size[1])


class RandomFlipLeftRight(_NumpyIn, Block):
    def forward(self, x):
        if _np.random.rand() < 0.5:
            return x.flip(axis=1)
        return x


class RandomFlipTopBottom(_NumpyIn, Block):
    def forward(self, x):
        if _np.random.rand() < 0.5:
            return x.flip(axis=0)
        return x


class RandomBrightness(_NumpyIn, Block):
    def __init__(self, brightness):
        super().__init__()
        self._delta = brightness

    def forward(self, x):
        alpha = 1.0 + _np.random.uniform(-self._delta, self._delta)
        return (x.astype("float32") * alpha).clip(0, 255)


class RandomContrast(_NumpyIn, Block):
    def __init__(self, contrast):
        super().__init__()
        self._delta = contrast

    def forward(self, x):
        alpha = 1.0 + _np.random.uniform(-self._delta, self._delta)
        xf = x.astype("float32")
        gray = xf.mean()
        return ((xf - gray) * alpha + gray).clip(0, 255)


class RandomSaturation(_NumpyIn, Block):
    def __init__(self, saturation):
        super().__init__()
        self._delta = saturation

    def forward(self, x):
        alpha = 1.0 + _np.random.uniform(-self._delta, self._delta)
        xf = x.astype("float32")
        coef = array(_np.array([0.299, 0.587, 0.114],
                               _np.float32).reshape(1, 1, 3), ctx=x.context)
        gray = (xf * coef).sum(axis=2, keepdims=True)
        return (xf * alpha + gray * (1.0 - alpha)).clip(0, 255)


class CropResize(_NumpyIn, Block):
    """The crop at (x, y, width, height), then an optional resize
    (reference: transforms.py:231); a crop outside the image raises, as
    the reference's image.crop does."""

    def __init__(self, x, y, width, height, size=None, interpolation=1):
        super().__init__()
        self._x, self._y = int(x), int(y)
        self._w, self._h = int(width), int(height)
        self._size = ((size, size) if isinstance(size, int) else size) \
            if size is not None else None
        self._interp = interpolation

    def forward(self, data):
        batched = data.ndim == 4   # (N, H, W, C)
        hax = 1 if batched else 0
        h, w = data.shape[hax], data.shape[hax + 1]
        if self._x < 0 or self._y < 0 or self._x + self._w > w \
                or self._y + self._h > h:
            raise MXNetError(
                "CropResize: crop (x=%d, y=%d, w=%d, h=%d) exceeds image "
                "(%dx%d)" % (self._x, self._y, self._w, self._h, w, h))
        ys = slice(self._y, self._y + self._h)
        xs = slice(self._x, self._x + self._w)
        crop = data[:, ys, xs] if batched else data[ys, xs]
        if self._size is None:
            return crop
        from .... import image

        if batched:
            return nd.stack(*[image.imresize(crop[i], self._size[0],
                                             self._size[1],
                                             interp=self._interp)
                              for i in range(crop.shape[0])], axis=0)
        return image.imresize(crop, self._size[0], self._size[1],
                              interp=self._interp)


class RandomHue(_NumpyIn, Block):
    """Rotate hue by a random angle in [-hue, hue] x pi through the YIQ
    approximation of the reference's image.random_hue
    (transforms.py:483)."""

    _T_YIQ = _np.array([[0.299, 0.587, 0.114],
                        [0.596, -0.274, -0.321],
                        [0.211, -0.523, 0.311]], _np.float32)
    _T_RGB = _np.array([[1.0, 0.956, 0.621],
                        [1.0, -0.272, -0.647],
                        [1.0, -1.107, 1.705]], _np.float32)

    def __init__(self, hue):
        super().__init__()
        self._delta = hue

    def forward(self, x):
        alpha = _np.random.uniform(-self._delta, self._delta)
        theta = alpha * _np.pi
        u, w = _np.cos(theta), _np.sin(theta)
        rot = _np.array([[1.0, 0.0, 0.0],
                         [0.0, u, -w],
                         [0.0, w, u]], _np.float32)
        m = self._T_RGB @ rot @ self._T_YIQ   # rgb -> rgb
        out = nd.dot(x.astype("float32"), array(m.T.copy(), ctx=x.context))
        return out.clip(0, 255)


class RandomColorJitter(_NumpyIn, Block):
    """Brightness, contrast, saturation and hue jitter in a random order
    (reference: transforms.py:508)."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        super().__init__()
        self._ts = []
        if brightness:
            self._ts.append(RandomBrightness(brightness))
        if contrast:
            self._ts.append(RandomContrast(contrast))
        if saturation:
            self._ts.append(RandomSaturation(saturation))
        if hue:
            self._ts.append(RandomHue(hue))

    def forward(self, x):
        for i in _np.random.permutation(len(self._ts)):
            x = self._ts[i](x)
        return x


class RandomLighting(_NumpyIn, Block):
    """AlexNet-style PCA lighting noise (reference: transforms.py:542)."""

    _EIGVAL = _np.array([55.46, 4.794, 1.148], _np.float32)
    _EIGVEC = _np.array([[-0.5675, 0.7192, 0.4009],
                         [-0.5808, -0.0045, -0.8140],
                         [-0.5836, -0.6948, 0.4203]], _np.float32)

    def __init__(self, alpha):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        draws = _np.random.normal(0, self._alpha, 3).astype(_np.float32)
        rgb = self._EIGVEC @ (self._EIGVAL * draws)
        return (x.astype("float32")
                + array(rgb.reshape(1, 1, 3), ctx=x.context)).clip(0, 255)
