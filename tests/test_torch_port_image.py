"""The port's `image` (codec, crops, augmenters, `ImageIter`,
`ImageRecordIterPy` / `io.ImageRecordIter`) against the JAX package's, on
the CPU.

Tolerances, and why:

* PNG both ways, JPEG through Pillow, nearest resizes, crops, flips,
  casts and every augmenter whose arithmetic is elementwise or numpy's in
  both packages: exact.
* Bilinear resizes: one uint8 level. The JAX package calls Pillow's
  BILINEAR, the port `torch.nn.functional.interpolate(antialias=True)`:
  the same triangle filter with its own fixed-point rounding.
* ContrastJitterAug after BrightnessJitterAug: the image mean of
  non-integer float32 values depends on the summation order (XLA's
  reduction in the JAX package, numpy's pairwise sum in the port), so the
  chain holding both is held to rtol 1e-6; on integer-valued input every
  sum is exact and so is the augmenter.
* Random augmenters are compared at one decode thread with numpy's global
  generator seeded alike (the port's explicit ``rng`` too); with more
  threads the draws follow the scheduling in both packages, so four
  threads are compared with deterministic augmenters only.
"""
import importlib.util
import io
import os
import sys
import threading
import time

import numpy as np
import pytest
from PIL import Image

import mxnet_tpu as jmx
from mxnet_tpu import image as jimage

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import image as timage
from mxnet_tpu_torch.base import MXNetError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _leftover(before, timeout=5.0):
    """Names of the ``mxtpu-`` threads started since ``before`` (a
    `threading.enumerate()` snapshot) still alive after up to ``timeout``
    s of joining: a thread that delivered its end takes a moment to
    return; one left blocked does not."""
    deadline = time.monotonic() + timeout
    left = []
    for t in threading.enumerate():
        if t in before or not t.name.startswith("mxtpu-"):
            continue
        t.join(max(0.0, deadline - time.monotonic()))
        if t.is_alive():
            left.append(t.name)
    return left


def _rgb(seed, shape=(23, 31, 3)):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(
        np.uint8)


def _pil_png(img, mode=None, **kw):
    pil = Image.fromarray(img)
    if mode == "P16":
        pil = pil.quantize(16)
    elif mode == "P256":
        pil = pil.quantize(200)
    elif mode is not None:
        pil = pil.convert(mode)
    out = io.BytesIO()
    pil.save(out, format="PNG", **kw)
    return out.getvalue()


@pytest.mark.parametrize("mode", [None, "L", "RGBA", "LA", "P16", "P256",
                                  "1"])
@pytest.mark.parametrize("flag", [1, 0])
def test_png_from_pillow_decodes_exactly(mode, flag):
    """Pillow picks each row's filter (all five types appear), and the
    port converts as Pillow's convert("RGB") / convert("L")."""
    buf = _pil_png(_rgb(1), mode)
    got = timage.imdecode(buf, flag=flag, to_ndarray=False)
    want = jimage.imdecode(buf, flag=flag, to_ndarray=False)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert timage.imdecode(buf, flag=flag, to_rgb=False,
                           to_ndarray=False).shape == want.shape


@pytest.mark.parametrize("shape", [(19, 27, 3), (8, 13), (8, 13, 1),
                                   (9, 11, 4), (1, 1, 3)])
def test_png_from_the_port_decodes_exactly_in_pillow(shape):
    img = _rgb(2, shape)
    buf = timage.imencode(img, fmt=".png")
    got = np.asarray(Image.open(io.BytesIO(buf)))
    np.testing.assert_array_equal(got.reshape(img.shape), img)
    back = timage.imdecode(buf, flag=1 if img.ndim == 3 and
                           img.shape[2] != 1 else 0, to_ndarray=False)
    np.testing.assert_array_equal(back[..., :img.shape[-1]]
                                  if img.ndim == 3 else back[..., 0],
                                  img[..., :3] if img.ndim == 3 else img)


def test_jpeg_goes_through_pillow_exactly():
    img = _rgb(3)
    buf = jimage.imencode(img, quality=90, fmt=".jpg")
    assert timage.imencode(img, quality=90, fmt=".jpg") == buf
    for flag in (1, 0):
        np.testing.assert_array_equal(
            timage.imdecode(buf, flag=flag, to_ndarray=False),
            jimage.imdecode(buf, flag=flag, to_ndarray=False))


def test_jpeg_without_pillow_raises_naming_it(monkeypatch):
    buf = jimage.imencode(_rgb(4), fmt=".jpg")
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(MXNetError, match="Pillow"):
        timage.imdecode(buf)
    with pytest.raises(MXNetError, match="Pillow"):
        timage.imencode(_rgb(4), fmt=".jpg")
    png = timage.imencode(_rgb(4), fmt=".png")   # PNG needs no Pillow
    np.testing.assert_array_equal(timage.imdecode(png, to_ndarray=False),
                                  _rgb(4))


def test_imdecode_gives_an_ndarray_on_the_current_context():
    buf = timage.imencode(_rgb(5), fmt=".png")
    with tmx.context.scope(tmx.cpu()):
        a = timage.imdecode(buf)
    assert isinstance(a, tmx.nd.NDArray) and a.dtype == np.uint8
    np.testing.assert_array_equal(a.asnumpy(), _rgb(5))
    with pytest.raises(MXNetError, match="no CUDA device"):
        timage.imdecode(buf)
    with pytest.raises(MXNetError, match="truncated|corrupt"):
        timage.imdecode(buf[:60] + buf[-12:], to_ndarray=False)


@pytest.mark.parametrize("interp", [0, 1, 2])
@pytest.mark.parametrize("size", [(12, 9), (57, 40), (31, 5)])
@pytest.mark.parametrize("channels", [3, 1])
def test_imresize_matches_pillow(interp, size, channels):
    img = _rgb(6, (23, 31, channels))
    got = timage.imresize(img, size[0], size[1], interp)
    want = jimage.imresize(img, size[0], size[1], interp)
    assert got.shape == want.shape == (size[1], size[0], channels)
    diff = np.abs(got.astype(int) - want.astype(int)).max()
    assert diff <= (0 if interp == 0 else 1)
    with tmx.context.scope(tmx.cpu()):
        nd_out = timage.imresize(tmx.nd.array(img, dtype="uint8"), *size,
                                 interp=interp)
    np.testing.assert_array_equal(nd_out.asnumpy(), got)


def test_crops_match_jax():
    img = _rgb(7, (30, 41, 3))
    np.random.seed(11)
    jr = [jimage.random_crop(img, (20, 13)) for _ in range(4)]
    np.random.seed(11)
    tr = [timage.random_crop(img, (20, 13)) for _ in range(4)]
    rng = np.random.RandomState(11)
    tr_rng = [timage.random_crop(img, (20, 13), rng=rng) for _ in range(4)]
    for (ja, jb), (ta, tb), (ra, rb) in zip(jr, tr, tr_rng):
        assert jb == tb == rb
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_array_equal(ra, ja)
    for fn, args in ((jimage.center_crop, ((20, 13),)),
                     (jimage.fixed_crop, (3, 4, 10, 8)),
                     (jimage.resize_short, (17, 0))):
        want = fn(img, *args)
        got = getattr(timage, fn.__name__)(img, *args)
        if isinstance(want, tuple):
            assert got[1] == want[1]
            want, got = want[0], got[0]
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        timage.color_normalize(img.astype(np.float32), 3.0, 2.0),
        jimage.color_normalize(img.astype(np.float32), 3.0, 2.0))


def _aug_pairs():
    mean = np.array([123.68, 116.28, 103.53], np.float32)
    std = np.array([58.395, 57.12, 57.375], np.float32)
    return [
        ("ResizeAug", (15, 1)), ("ResizeAug", (15, 0)),
        ("RandomCropAug", ((16, 12),)), ("CenterCropAug", ((16, 12),)),
        ("HorizontalFlipAug", (0.5,)), ("CastAug", ()),
        ("ColorNormalizeAug", (mean, std)),
        ("BrightnessJitterAug", (0.4,)), ("ContrastJitterAug", (0.4,)),
        ("SaturationJitterAug", (0.4,)), ("HueJitterAug", (0.3,)),
        ("LightingAug", (0.1,)), ("RandomGrayAug", (0.5,)),
    ]


@pytest.mark.parametrize("name,args", _aug_pairs(),
                         ids=[p[0] + str(i) for i, p in
                              enumerate(_aug_pairs())])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_every_augmenter_matches_jax_at_the_same_seed(name, args, dtype):
    """Each augmenter on an NDArray (a JAX one, a port host one), as the
    JAX iterator feeds them, and on numpy in both packages; the port's
    also with an explicit RandomState."""
    img = _rgb(8).astype(dtype)
    if name == "ResizeAug" and dtype == "float32":
        img = img.astype(np.uint8)   # Pillow resizes uint8 images
    tol = 1 if name == "ResizeAug" and args[1] else 0
    rand = "rng" in getattr(timage, name).__init__.__code__.co_varnames

    def run(mod, src, seed, **kw):
        np.random.seed(seed)
        out = getattr(mod, name)(*args, **kw)(src)
        return out.asnumpy() if hasattr(out, "asnumpy") else np.asarray(out)

    for seed in range(3):
        pairs = [(run(jimage, img, seed), run(timage, img, seed))]
        if not (name == "ContrastJitterAug" and dtype == "uint8"):
            # (the JAX package's uint8 NDArray overflows in its contrast)
            pairs.append((run(jimage, jmx.nd.array(img, dtype=dtype), seed),
                          run(timage, tmx.nd.array(img, ctx=tmx.cpu(),
                                                   dtype=dtype), seed)))
        if rand:
            pairs.append((pairs[0][0], run(
                timage, img, seed + 100, rng=np.random.RandomState(seed))))
        for want, got in pairs:
            assert got.shape == want.shape and got.dtype == want.dtype
            np.testing.assert_allclose(got.astype(np.float64),
                                       want.astype(np.float64), rtol=0,
                                       atol=tol)


@pytest.mark.parametrize("contrast", [0, 0.3])
def test_create_augmenter_chain_matches_jax(contrast):
    kw = dict(rand_crop=True, rand_mirror=True, mean=True, std=True,
              brightness=0.3, contrast=contrast, saturation=0.3, hue=0.2,
              pca_noise=0.1, rand_gray=0.3)
    jaugs = jimage.CreateAugmenter((3, 16, 20), **kw)
    taugs = timage.CreateAugmenter((3, 16, 20), **kw)
    assert [type(a).__name__ for a in taugs] == \
        [type(a).__name__ for a in jaugs]
    assert [a.dumps() for a in taugs[:3]] == [a.dumps() for a in jaugs[:3]]
    for seed in range(4):
        img = _rgb(20 + seed)
        np.random.seed(seed)
        want = jmx.nd.array(img, dtype="uint8")
        for a in jaugs:
            want = a(want)
        np.random.seed(seed)
        got = img
        for a in taugs:
            got = a(got)
        if contrast:
            np.testing.assert_allclose(got, want.asnumpy(), rtol=1e-6,
                                       atol=1e-5)
        else:
            np.testing.assert_array_equal(got, want.asnumpy())


def _im2rec(tmp_path, n=18):
    """A .rec written by the JAX package's tools/im2rec.py: PNGs from
    Pillow in class folders, listed in its shuffled order, packed as they
    are on disk."""
    root = tmp_path / "imgs"
    rng = np.random.RandomState(30)
    for i in range(n):
        d = root / ("c%d" % (i % 3))
        d.mkdir(parents=True, exist_ok=True)
        h, w = rng.randint(24, 40), rng.randint(24, 40)
        Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(
            np.uint8)).save(str(d / ("%02d.png" % i)))
    spec = importlib.util.spec_from_file_location(
        "im2rec", os.path.join(REPO, "tools", "im2rec.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    prefix = str(tmp_path / "data")
    mod.main([prefix, str(root)])
    return prefix + ".rec"


def _batches(it, n=None):
    out = []
    for b in it:
        out.append((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad))
    return out


def _assert_same(got, want):
    assert len(got) == len(want)
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gp == wp
        assert gd.dtype == np.float32 and gd.shape == wd.shape
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gl, wl)


def test_image_record_iter_matches_jax(tmp_path):
    """Over an im2rec-written file: at one thread with random crops,
    mirrors, shuffle and mean/std, two epochs (reset reshuffles); at four
    threads with the deterministic augmenters; the same pads; and the
    plain `ImageIter`."""
    before = set(threading.enumerate())
    rec = _im2rec(tmp_path)
    kw = dict(path_imgrec=rec, data_shape=(3, 20, 22), batch_size=5,
              mean_r=123.0, mean_g=117.0, mean_b=104.0, std_r=58.0,
              std_g=57.0, std_b=57.5)
    rand = dict(kw, shuffle=True, rand_crop=True, rand_mirror=True)
    np.random.seed(3)
    jit = jmx.io.ImageRecordIter(preprocess_threads=1, **rand)
    want = _batches(jit)
    jit.reset()
    want += _batches(jit)
    np.random.seed(3)
    tit = tmx.io.ImageRecordIter(preprocess_threads=1, **rand)
    got = _batches(tit)
    tit.reset()
    got += _batches(tit)
    _assert_same(got, want)
    assert [b[2] for b in got] == [0, 0, 0, 2] * 2
    tit = tmx.io.ImageRecordIter(preprocess_threads=1,
                                 rng=np.random.RandomState(3), **rand)
    got = _batches(tit)
    tit.reset()
    _assert_same(got + _batches(tit), want)

    jit = jmx.io.ImageRecordIter(preprocess_threads=4, **kw)
    tit = tmx.io.ImageRecordIter(preprocess_threads=4, **kw)
    _assert_same(_batches(tit), _batches(jit))
    tit.close()
    np.random.seed(5)   # each iterator draws its shuffle, then its crops
    want = _batches(jimage.ImageIter(4, (3, 18, 18), path_imgrec=rec,
                                     shuffle=True, rand_crop=True))
    np.random.seed(5)
    _assert_same(_batches(timage.ImageIter(4, (3, 18, 18), path_imgrec=rec,
                                           shuffle=True, rand_crop=True)),
                 want)
    assert _leftover(before) == []


def test_image_iter_sequential_and_list_sources(tmp_path):
    """Without an .idx the record is read as a stream (shuffle refused);
    an image list reads files under path_root."""
    rec = _im2rec(tmp_path, n=7)
    os.remove(rec[:-4] + ".idx")
    tit = timage.ImageIter(3, (3, 16, 16), path_imgrec=rec)
    jit = jimage.ImageIter(3, (3, 16, 16), path_imgrec=rec)
    _assert_same(_batches(tit), _batches(jit))
    tit.reset()
    jit.reset()
    _assert_same(_batches(tit), _batches(jit))
    with pytest.raises(MXNetError, match="index"):
        timage.ImageIter(3, (3, 16, 16), path_imgrec=rec, shuffle=True)
    root = tmp_path / "imgs"
    items = [[float(i % 3), "c%d/%02d.png" % (i % 3, i)] for i in range(7)]
    tit = timage.ImageIter(2, (3, 16, 16), imglist=items,
                           path_root=str(root))
    jit = jimage.ImageIter(2, (3, 16, 16), imglist=items,
                           path_root=str(root))
    _assert_same(_batches(tit), _batches(jit))
    with tmx.context.scope(tmx.cpu()):
        label, img = timage.ImageIter(2, (3, 16, 16), imglist=items,
                                      path_root=str(root)).next_sample()
    jlabel, jimg = jimage.ImageIter(2, (3, 16, 16), imglist=items,
                                    path_root=str(root)).next_sample()
    np.testing.assert_array_equal(np.asarray(label), np.asarray(jlabel))
    np.testing.assert_array_equal(img.asnumpy(), jimg.asnumpy())


def test_detection_pipeline_is_not_ported():
    for name in ("ImageDetIter", "CreateDetAugmenter", "DetRandomCropAug"):
        with pytest.raises(MXNetError, match="item 9"):
            getattr(timage, name)()
