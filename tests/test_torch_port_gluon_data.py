"""The port's `gluon.data` (datasets, samplers, `DataLoader`, vision
datasets and transforms) and the ``mx.nd.image`` ops against the JAX
package's, on the CPU.

Tolerances, and why:

* Datasets, samplers, crops, flips, casts and uint8 transforms: exact;
  the port's DataLoader batches equal each other exactly in every mode
  (in-thread, on a thread, in forked workers).
* Float transforms, the float image ops, and so the DataLoader's
  normalized batches against the JAX package's: rtol 1e-6 with an
  absolute floor of 1e-6 x the largest magnitude. XLA rounds ``x /
  255.0`` as a multiplication by the reciprocal (up to 7.2e-7 apart on
  these batches); a mean (RandomContrast) or a dot over the channels
  (RandomHue) sums in another order in each package.
* Resizes: one uint8 level (Pillow's BILINEAR in the JAX transforms,
  `jax.image.resize` in its op; antialiased `interpolate` in the port) and
  1e-4 relative in float.

The forked DataLoader runs are bounded by the loader's own ``timeout``
(a dead or stuck worker raises instead of hanging the suite), and each
ends with no worker process left.
"""
import gzip
import multiprocessing
import os
import pickle
import struct

import numpy as np
import pytest
from PIL import Image

import mxnet_tpu as jmx
from mxnet_tpu.gluon import data as jdata
from mxnet_tpu.gluon.data.vision import transforms as JT

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import recordio as trec
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import data as tdata
from mxnet_tpu_torch.gluon.data.vision import transforms as TT


@pytest.fixture
def cpu():
    with tmx.context.scope(tmx.cpu()):
        yield


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(i) for i in x]
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _close(got, want, tol=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1.0))


def _rgb(seed, shape=(21, 26, 3)):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(
        np.uint8)


# ---------------------------------------------------------------------------
# datasets and samplers
# ---------------------------------------------------------------------------

def test_datasets_match_jax(tmp_path, cpu):
    x = np.arange(24, dtype=np.float32).reshape(8, 3)
    y = np.arange(8, dtype=np.float32)
    t = tdata.ArrayDataset(x, tmx.nd.array(y))
    j = jdata.ArrayDataset(x, jmx.nd.array(y))
    assert len(t) == len(j) == 8
    for i in range(8):
        for a, b in zip(t[i], j[i]):
            np.testing.assert_array_equal(_np(a), _np(b))
    tt = t.transform(lambda a, b: (a * 2, b + 1))
    jt = j.transform(lambda a, b: (a * 2, b + 1))
    tf = t.transform_first(lambda a: a - 1, lazy=False)
    jf = j.transform_first(lambda a: a - 1, lazy=False)
    for i in range(8):
        for a, b in zip(tt[i] + tf[i], jt[i] + jf[i]):
            np.testing.assert_array_equal(_np(a), _np(b))
    keep = lambda s: float(s[1]) % 3 == 0   # noqa: E731
    assert [_np(s[1]) for s in t.filter(keep)] == \
        [_np(s[1]) for s in j.filter(keep)]
    simple = tdata.SimpleDataset(list("abc"))
    assert [simple[i] for i in range(len(simple))] == list("abc")
    prefix = str(tmp_path / "raw")
    w = trec.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i in range(4):
        w.write_idx(i, b"record %d" % i)
    w.close()
    tr, jr = tdata.RecordFileDataset(prefix + ".rec"), \
        jdata.RecordFileDataset(prefix + ".rec")
    assert [tr[i] for i in range(4)] == [jr[i] for i in range(4)]


@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
def test_samplers_match_jax(last_batch):
    np.random.seed(3)
    want = list(jdata.RandomSampler(11))
    np.random.seed(3)
    assert list(tdata.RandomSampler(11)) == want
    assert list(tdata.SequentialSampler(5)) == list(range(5))
    tb = tdata.BatchSampler(tdata.SequentialSampler(11), 4, last_batch)
    jb = jdata.BatchSampler(jdata.SequentialSampler(11), 4, last_batch)
    for _ in range(2):   # rollover carries into the second epoch
        assert list(tb) == list(jb)
        assert len(tb) == len(jb)


# ---------------------------------------------------------------------------
# the DataLoader
# ---------------------------------------------------------------------------

def _image_records(tmp_path, n=10):
    prefix = str(tmp_path / "imgs")
    w = trec.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    rng = np.random.RandomState(9)
    for i in range(n):
        img = rng.randint(0, 256, (rng.randint(20, 30), rng.randint(20, 30),
                                   3)).astype(np.uint8)
        w.write_idx(i, trec.pack_img(trec.IRHeader(0, float(i % 4), i, 0),
                                     img, img_fmt=".png"))
    w.close()
    return prefix + ".rec"


def _chain(T):
    return T.Compose([T.CenterCrop(16), T.ToTensor(),
                      T.Normalize((0.485, 0.456, 0.406),
                                  (0.229, 0.224, 0.225))])


def _stack(batch):
    return [np.stack([np.asarray(a) for a in f]) for f in zip(*batch)]


def test_dataloader_at_0_and_2_workers_matches_jax(tmp_path, cpu):
    """ImageRecordDataset + transforms through the port's loader in the
    calling thread, on a thread and in two forked workers (with the
    default and a custom batchify), against the JAX loader's batches."""
    rec = _image_records(tmp_path)
    jds = jmx.gluon.data.vision.ImageRecordDataset(rec).transform_first(
        _chain(JT))
    want = [_np(b) for b in jdata.DataLoader(jds, batch_size=4)]
    tds = tmx.gluon.data.vision.ImageRecordDataset(rec).transform_first(
        _chain(TT))
    for kw in (dict(num_workers=0), dict(num_workers=2, thread_pool=True),
               dict(num_workers=2), dict(num_workers=2, batchify_fn=_stack)):
        loader = tdata.DataLoader(tds, batch_size=4, timeout=60, **kw)
        try:
            got = [_np(b) for b in loader]
            again = [_np(b) for b in loader]   # the pool serves epochs
        finally:
            loader.close()
        assert len(got) == len(want) == 3 and len(loader) == 3
        for g, a, w in zip(got, again, want):
            for gi, ai, wi in zip(g, a, w):
                _close(gi, wi)
                np.testing.assert_array_equal(gi, ai)
        if kw.get("num_workers") == 2 and "batchify_fn" not in kw:
            for g, first in zip(got, [_np(b) for b in tdata.DataLoader(
                    tds, batch_size=4)]):
                for gi, fi in zip(g, first):   # workers == in-thread
                    np.testing.assert_array_equal(gi, fi)
    assert multiprocessing.active_children() == []


class _CardTensorBox:
    """Pickles fine; unpickling it (in a worker) initializes CUDA, which a
    forked worker cannot (nor a CPU build)."""

    def __reduce__(self):
        import torch

        return (torch.cuda.init, ())


def test_dataloader_falls_back_to_a_thread_for_a_non_host_dataset(cpu,
                                                                  caplog):
    """A dataset that cannot be loaded in a worker (unpickling it there
    initializes CUDA) is probed, warned about and loaded on a thread."""
    ds = tdata.ArrayDataset(np.arange(6.0), np.arange(6.0))
    ds.box = _CardTensorBox()
    loader = tdata.DataLoader(ds, batch_size=3, num_workers=2, timeout=60)
    try:
        got = [_np(b) for b in loader]
    finally:
        loader.close()
    assert "loading on a thread" in caplog.text
    np.testing.assert_array_equal(got[1][0], [3.0, 4.0, 5.0])
    assert multiprocessing.active_children() == []


def test_dataloader_argument_checks_and_sampling(cpu):
    ds = tdata.ArrayDataset(np.arange(10.0))
    with pytest.raises(MXNetError, match="batch_size"):
        tdata.DataLoader(ds)
    with pytest.raises(MXNetError, match="shuffle"):
        tdata.DataLoader(ds, batch_size=2, shuffle=True,
                         sampler=tdata.SequentialSampler(10))
    np.random.seed(1)
    want = [_np(b) for b in jdata.DataLoader(jdata.ArrayDataset(
        np.arange(10.0)), batch_size=3, shuffle=True, last_batch="discard")]
    np.random.seed(1)
    got = [_np(b) for b in tdata.DataLoader(ds, batch_size=3, shuffle=True,
                                            last_batch="discard")]
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == np.float32


# ---------------------------------------------------------------------------
# transforms and image ops
# ---------------------------------------------------------------------------

def _transform_cases():
    return [
        ("ToTensor", (), {}), ("Cast", ("float16",), {}),
        ("Normalize", ((0.5, 0.4, 0.3), (0.2, 0.25, 0.3)), {"chw": True}),
        ("Resize", ((17, 11),), {"tol": 1}), ("CenterCrop", (12,), {}),
        ("CropResize", (2, 3, 10, 8), {}),
        ("CropResize", (2, 3, 10, 8, (6, 5)), {"tol": 1}),
        ("RandomResizedCrop", (9,), {"tol": 1}),
        ("RandomFlipLeftRight", (), {}), ("RandomFlipTopBottom", (), {}),
        ("RandomBrightness", (0.4,), {}), ("RandomContrast", (0.4,), {}),
        ("RandomSaturation", (0.4,), {}), ("RandomHue", (0.3,), {}),
        ("RandomColorJitter", (0.3, 0.3, 0.3, 0.2), {}),
        ("RandomLighting", (0.1,), {}),
    ]


@pytest.mark.parametrize("name,args,opt", _transform_cases(),
                         ids=[c[0] + str(i) for i, c in
                              enumerate(_transform_cases())])
def test_transforms_match_jax(name, args, opt, cpu):
    img = _rgb(4)
    for seed in range(3):
        x = img
        if opt.get("chw"):
            x = (img.transpose(2, 0, 1) / 255.0).astype(np.float32)
        np.random.seed(seed)
        want = _np(getattr(JT, name)(*args)(jmx.nd.array(x, dtype=x.dtype)))
        outs = []
        for src in (tmx.nd.array(x, dtype=str(x.dtype)), x):
            np.random.seed(seed)
            outs.append(_np(getattr(TT, name)(*args)(src)))
        for got in outs:
            assert got.shape == want.shape
            if "tol" in opt:
                np.testing.assert_allclose(got.astype(np.float64),
                                           want.astype(np.float64),
                                           atol=opt["tol"])
            elif got.dtype == np.uint8:
                np.testing.assert_array_equal(got, want)
            else:
                _close(got, want)
    batch = np.stack([img, _rgb(5)])
    _close(_np(TT.ToTensor()(tmx.nd.array(batch, dtype="uint8"))),
           _np(JT.ToTensor()(jmx.nd.array(batch, dtype="uint8"))))
    with pytest.raises(MXNetError, match="exceeds"):
        TT.CropResize(20, 0, 10, 10)(img)


def test_image_ops_match_jax(cpu):
    img = _rgb(6)
    xf = img.astype(np.float32)
    ops = [("to_tensor", img, {}),
           ("normalize", (img.transpose(2, 0, 1) / 255.0).astype(np.float32),
            dict(mean=(0.1, 0.2, 0.3), std=(0.3, 0.2, 0.1))),
           ("normalize", np.stack([xf.transpose(2, 0, 1)] * 2),
            dict(mean=0.5, std=2.0)),
           ("crop", img, dict(x=3, y=2, width=9, height=7)),
           ("crop", np.stack([img] * 2), dict(x=1, y=0, width=5, height=4)),
           ("resize", xf, dict(size=(13, 9))),
           ("resize", xf, dict(size=40)),
           ("resize", xf, dict(size=10, keep_ratio=True)),
           ("resize", xf, dict(size=(13, 9), interp=0)),
           ("resize", np.stack([xf] * 2), dict(size=(30, 17))),
           ("resize", img, dict(size=(13, 9)))]
    for name, x, kw in ops:
        want = _np(getattr(jmx.nd.image, name)(jmx.nd.array(
            x, dtype=str(x.dtype)), **kw))
        got = _np(getattr(tmx.nd.image, name)(tmx.nd.array(
            x, dtype=str(x.dtype)), **kw))
        assert got.dtype == want.dtype and got.shape == want.shape, name
        if name == "resize" and x.dtype == np.uint8:
            np.testing.assert_allclose(got.astype(int), want.astype(int),
                                       atol=1)
        elif name == "resize":
            _close(got, want, tol=1e-4)
        else:
            _close(got, want)
    with pytest.raises(MXNetError, match="float"):
        tmx.nd.image.normalize(tmx.nd.array(img, dtype="uint8"))
    with pytest.raises(MXNetError, match="size"):
        tmx.nd.image.resize(tmx.nd.array(xf), size=(1, 2, 3))


# ---------------------------------------------------------------------------
# vision datasets
# ---------------------------------------------------------------------------

def _mnist_files(root, prefix="train", n=6):
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(7)
    img = rng.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    lab = rng.randint(0, 10, n).astype(np.uint8)
    names = {"train": ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
             "t10k": ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")}
    im, lb = names[prefix]
    with gzip.open(os.path.join(root, im + ".gz"), "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + img.tobytes())
    with open(os.path.join(root, lb), "wb") as f:
        f.write(struct.pack(">II", 2049, n) + lab.tobytes())


def _cifar_files(root, n=5):
    d = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(d, exist_ok=True)
    rng = np.random.RandomState(8)
    for name in ["data_batch_%d" % i for i in range(1, 6)] + ["test_batch"]:
        with open(os.path.join(d, name), "wb") as f:
            pickle.dump({"data": rng.randint(0, 256, (n, 3072)).astype(
                np.uint8), "labels": list(rng.randint(0, 10, n))}, f)
    for name in ("train", "test"):
        with open(os.path.join(root, name), "wb") as f:
            pickle.dump({"data": rng.randint(0, 256, (n, 3072)).astype(
                np.uint8), "fine_labels": list(rng.randint(0, 100, n))}, f)


def _same_dataset(t, j):
    assert len(t) == len(j) > 0
    for i in range(len(t)):
        for a, b in zip(t[i], j[i]):
            np.testing.assert_array_equal(_np(a), _np(b))


def test_vision_datasets_read_local_files_as_jax(tmp_path, cpu):
    tv, jv = tmx.gluon.data.vision, jmx.gluon.data.vision
    _mnist_files(str(tmp_path / "m"))
    _mnist_files(str(tmp_path / "m"), "t10k", n=3)
    for cls in ("MNIST", "FashionMNIST"):
        for train in (True, False):
            _same_dataset(getattr(tv, cls)(str(tmp_path / "m"), train=train),
                          getattr(jv, cls)(str(tmp_path / "m"), train=train))
    _cifar_files(str(tmp_path / "c"))
    _same_dataset(tv.CIFAR10(str(tmp_path / "c")),
                  jv.CIFAR10(str(tmp_path / "c")))
    _same_dataset(tv.CIFAR100(str(tmp_path / "c"), train=False),
                  jv.CIFAR100(str(tmp_path / "c"), train=False))
    rec = _image_records(tmp_path, n=4)
    _same_dataset(tv.ImageRecordDataset(rec, flag=0),
                  jv.ImageRecordDataset(rec, flag=0))
    rng = np.random.RandomState(2)
    for k in range(5):
        d = tmp_path / "folder" / ("cls%d" % (k % 2))
        d.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.randint(0, 256, (9, 7, 3)).astype(
            np.uint8)).save(str(d / ("%d.png" % k)))
    t = tv.ImageFolderDataset(str(tmp_path / "folder"),
                              transform=lambda x, y: (x, y + 10))
    j = jv.ImageFolderDataset(str(tmp_path / "folder"),
                              transform=lambda x, y: (x, y + 10))
    assert t.synsets == j.synsets == ["cls0", "cls1"]
    _same_dataset(t, j)


def test_missing_dataset_files_raise_naming_them(tmp_path):
    tv = tmx.gluon.data.vision
    with pytest.raises(MXNetError, match="train-labels-idx1-ubyte"):
        tv.MNIST(str(tmp_path / "none"))
    with pytest.raises(MXNetError, match="data_batch_1"):
        tv.CIFAR10(str(tmp_path / "none"))
    with pytest.raises(MXNetError, match="nope.rec"):
        tv.ImageRecordDataset(str(tmp_path / "nope.rec"))
    with pytest.raises(MXNetError, match="nowhere"):
        tv.ImageFolderDataset(str(tmp_path / "nowhere"))
    assert not (tmp_path / "none").exists()   # nothing made, nothing fetched
