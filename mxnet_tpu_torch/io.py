"""Data iterators (counterpart of `mxnet_tpu/io.py`; reference:
python/mxnet/io/io.py — DataDesc, DataBatch, DataIter :178, NDArrayIter
:489, PrefetchingIter :345, ResizeIter — and the C++ iterators
src/io/iter_mnist.cc:80 MNISTIter, iter_csv.cc:164 CSVIter,
iter_libsvm.cc:67 LibSVMIter, iter_image_recordio_2.cc:766
ImageRecordIter).

Iterators are host-side producers. `NDArrayIter` and the file iterators
built on it (``MNISTIter``, ``CSVIter``, ``LibSVMIter``) give NDArrays on
`current_context` (the card unless a ``scope`` chose the CPU);
``ImageRecordIter`` decodes and augments on host threads and gives host
NDArrays, which `data.DevicePrefetcher` copies to the card ahead of the
step. ``PrefetchingIter`` runs its iterators on a background thread.
"""
from __future__ import annotations

import collections

import numpy as _np
import torch

from .base import MXNetError
from .ndarray import NDArray, array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "MNISTIter", "CSVIter", "ImageRecordIter",
           "LibSVMIter"]


class DataDesc(collections.namedtuple("DataDesc",
                                      ["name", "shape", "dtype", "layout"])):
    """Name, shape, dtype and layout of one input (reference: io.py
    DataDesc)."""

    def __new__(cls, name, shape, dtype=_np.float32, layout="NCHW"):
        return super().__new__(cls, name, tuple(shape), dtype, layout)

    @staticmethod
    def get_batch_axis(layout):
        if layout is None:
            return 0
        return layout.find("N")


class DataBatch:
    """One batch: lists of data and label NDArrays (reference: io.py
    DataBatch)."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter:
    """Base iterator (reference: io.py:178)."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError


def _init_data(data, allow_empty, default_name):
    """Inputs as an ordered {name: NDArray} (reference: io.py _init_data)."""
    if data is None:
        data = []
    if isinstance(data, (_np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty:
            assert len(data) > 0
        if len(data) == 1:
            data = collections.OrderedDict([(default_name, data[0])])
        else:
            data = collections.OrderedDict(
                [("_%d_%s" % (i, default_name), d)
                 for i, d in enumerate(data)])
    if not isinstance(data, dict):
        raise TypeError("Input must be NDArray, numpy.ndarray, list or dict")
    return collections.OrderedDict(
        (k, v if isinstance(v, NDArray) else array(v))
        for k, v in data.items())


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays (reference: io.py:489). ``shuffle``
    permutes with numpy's global generator, as the JAX package does; the
    last batch is padded by wrapping around ("pad") or dropped
    ("discard")."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False,
                               default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        self.idx = _np.arange(len(next(iter(self.data.values()))))
        if shuffle:
            _np.random.shuffle(self.idx)
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.num_data = len(self.idx)
        if last_batch_handle == "discard":
            self.num_data = (self.num_data // batch_size) * batch_size
        assert self.num_data >= batch_size, "batch_size larger than data size"
        self.cursor = -batch_size

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + tuple(v.shape[1:]), v.dtype)
                for k, v in self.data.items()]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + tuple(v.shape[1:]), v.dtype)
                for k, v in self.label.items()]

    def reset(self):
        if self.shuffle:
            _np.random.shuffle(self.idx)
        self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def _take(self, arrs):
        end = self.cursor + self.batch_size
        if end <= self.num_data:
            sel = self.idx[self.cursor:end]
        else:  # pad: wrap around (the reference pads from the beginning)
            sel = _np.concatenate([self.idx[self.cursor:self.num_data],
                                   self.idx[:end - self.num_data]])
        out = []
        for v in arrs.values():
            pos = torch.from_numpy(sel).to(v.context)
            out.append(NDArray(v._data.index_select(0, pos)))
        return out

    def getdata(self):
        return self._take(self.data)

    def getlabel(self):
        return self._take(self.label)

    def getpad(self):
        end = self.cursor + self.batch_size
        if self.last_batch_handle == "pad" and end > self.num_data:
            return end - self.num_data
        return 0


class ResizeIter(DataIter):
    """Resize an iterator to ``size`` batches an epoch, restarting it as
    needed (reference: io.py ResizeIter)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None

    @property
    def provide_data(self):
        return self.data_iter.provide_data

    @property
    def provide_label(self):
        return self.data_iter.provide_label

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class PrefetchingIter(DataIter):
    """Double-buffered prefetch (reference: io.py:345 +
    src/io/iter_prefetcher.h): a `data.PrefetchBuffer` thread keeps the
    next batch of every wrapped iterator ready."""

    def __init__(self, iters, rename_data=None, rename_label=None):
        super().__init__()
        if not isinstance(iters, list):
            iters = [iters]
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self.batch_size = getattr(iters[0], "batch_size", 0)
        self._start()

    def _renamed(self, which, rename):
        out = []
        for i, it in enumerate(self.iters):
            descs = getattr(it, which)
            if rename:
                descs = [DataDesc(rename[i].get(d.name, d.name), d.shape,
                                  d.dtype, d.layout) for d in descs]
            out.extend(descs)
        return out

    @property
    def provide_data(self):
        return self._renamed("provide_data", self.rename_data)

    @property
    def provide_label(self):
        return self._renamed("provide_label", self.rename_label)

    def _produce(self):
        batches = [it.next() for it in self.iters]
        data = sum([b.data for b in batches], [])
        label = sum([(b.label or []) for b in batches], [])
        return DataBatch(data=data, label=label, pad=batches[0].pad,
                         index=batches[0].index)

    def _start(self):
        from .context import in_scope_of
        from .data.core import PrefetchBuffer

        self._buf = PrefetchBuffer(in_scope_of(self._produce), depth=2,
                                   name="mxtpu-io-prefetch",
                                   owner="PrefetchingIter.reset", src="io")

    def reset(self):
        # stop and join the producer BEFORE rewinding: resetting the
        # wrapped iterators under a live reader corrupts the next epoch
        self._buf.close()
        for it in self.iters:
            it.reset()
        self._start()

    def close(self):
        """Stop and join the producer."""
        self._buf.close()

    def next(self):
        return self._buf.get()

    def iter_next(self):
        raise MXNetError("use next() with PrefetchingIter")


def _read_file(path):
    import gzip
    import os

    if os.path.exists(path):
        with open(path, "rb") as f:
            return f.read()
    if os.path.exists(path + ".gz"):
        with gzip.open(path + ".gz", "rb") as f:
            return f.read()
    raise MXNetError("file %s not found" % path)


class MNISTIter(NDArrayIter):
    """MNIST from the standard idx files, optionally gzipped (reference:
    src/io/iter_mnist.cc:80): images scaled to [0, 1], flat or (1, rows,
    cols)."""

    def __init__(self, image="train-images-idx3-ubyte",
                 label="train-labels-idx1-ubyte", batch_size=128,
                 shuffle=True, flat=False, silent=False, seed=None, **kwargs):
        import struct

        raw = _read_file(label)
        lab = _np.frombuffer(raw[8:], dtype=_np.uint8).astype(_np.float32)
        raw = _read_file(image)
        _, num, rows, cols = struct.unpack(">IIII", raw[:16])
        img = _np.frombuffer(raw[16:], dtype=_np.uint8) \
            .astype(_np.float32) / 255.0
        img = img.reshape(num, rows * cols) if flat \
            else img.reshape(num, 1, rows, cols)
        super().__init__(img, lab, batch_size=batch_size, shuffle=shuffle,
                         data_name="data", label_name="label")


def _loadtxt(path):
    try:
        return _np.loadtxt(path, delimiter=",", dtype=_np.float32, ndmin=2)
    except FileNotFoundError:
        raise MXNetError("file %s not found" % path) from None


class _WrappedIter(DataIter):
    """A file iterator over an inner `NDArrayIter`."""

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()


class CSVIter(_WrappedIter):
    """CSV rows as data (and labels) (reference: src/io/iter_csv.cc:164);
    the last batch pads (``round_batch``) or is dropped."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, round_batch=True, **kwargs):
        super().__init__(batch_size)
        self._data = _loadtxt(data_csv).reshape((-1,) + tuple(data_shape))
        if label_csv is not None:
            self._label = _loadtxt(label_csv).reshape(
                (-1,) + tuple(label_shape))
        else:
            self._label = _np.zeros((len(self._data), 1), _np.float32)
        self._inner = NDArrayIter(
            self._data, self._label, batch_size=batch_size,
            last_batch_handle="pad" if round_batch else "discard",
            data_name="data", label_name="label")


class LibSVMIter(_WrappedIter):
    """LibSVM rows (``label index:value ...``) as dense arrays, as in the
    JAX package (reference: src/io/iter_libsvm.cc:67, which keeps them
    sparse)."""

    def __init__(self, data_libsvm, data_shape, label_libsvm=None,
                 batch_size=1, **kwargs):
        super().__init__(batch_size)
        num_col = int(_np.prod(data_shape))
        rows = []
        labels = []
        try:
            f = open(data_libsvm)
        except FileNotFoundError:
            raise MXNetError("file %s not found" % data_libsvm) from None
        with f:
            for line in f:
                parts = line.strip().split()
                if not parts:
                    continue
                labels.append(float(parts[0]))
                row = _np.zeros(num_col, _np.float32)
                for tok in parts[1:]:
                    k, v = tok.split(":")
                    row[int(k)] = float(v)
                rows.append(row)
        data = _np.stack(rows).reshape((-1,) + tuple(data_shape))
        self._inner = NDArrayIter(data, _np.asarray(labels, _np.float32),
                                  batch_size=batch_size, data_name="data",
                                  label_name="label")


def ImageRecordIter(path_imgrec=None, data_shape=(3, 224, 224), batch_size=1,
                    shuffle=False, rand_crop=False, rand_mirror=False,
                    mean_r=0.0, mean_g=0.0, mean_b=0.0, std_r=1.0, std_g=1.0,
                    std_b=1.0, resize=-1, label_width=1, preprocess_threads=4,
                    prefetch_buffer=4, rng=None, **kwargs):
    """Augmenting RecordIO image iterator (reference:
    src/io/iter_image_recordio_2.cc:766 + image_aug_default.cc): the
    threaded `image.ImageRecordIterPy`. ``rng``: the
    `np.random.RandomState` of the shuffle and the random augmenters
    (numpy's global generator by default)."""
    from . import image

    return image.ImageRecordIterPy(
        path_imgrec=path_imgrec, data_shape=data_shape, batch_size=batch_size,
        shuffle=shuffle, rand_crop=rand_crop, rand_mirror=rand_mirror,
        mean=(mean_r, mean_g, mean_b), std=(std_r, std_g, std_b), resize=resize,
        label_width=label_width, preprocess_threads=preprocess_threads,
        prefetch_buffer=prefetch_buffer, rng=rng)
