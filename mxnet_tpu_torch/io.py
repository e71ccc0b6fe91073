"""Data iterators (counterpart of `mxnet_tpu/io.py`; reference:
python/mxnet/io/io.py — DataDesc, DataBatch, DataIter :178, NDArrayIter
:489, ResizeIter).

Iterators are host-side producers of NDArray batches on `current_context`
(the card unless a ``scope`` chose the CPU). The file-backed iterators
(``ImageRecordIter``, ``MNISTIter``, ``CSVIter``, ``LibSVMIter``) and the
threaded ``PrefetchingIter`` are not ported yet (ROADMAP queue 1 item 7):
calling one raises and says so.
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


def _not_ported(name):
    def make(*args, **kwargs):
        raise MXNetError("io.%s is not ported yet (ROADMAP queue 1 item 7, "
                         "input)" % name)

    make.__name__ = name
    make.__doc__ = "Not ported yet: raises (ROADMAP queue 1 item 7)."
    return make


PrefetchingIter = _not_ported("PrefetchingIter")
MNISTIter = _not_ported("MNISTIter")
CSVIter = _not_ported("CSVIter")
LibSVMIter = _not_ported("LibSVMIter")
ImageRecordIter = _not_ported("ImageRecordIter")
