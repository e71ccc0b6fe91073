"""Contrib IO (counterpart of `mxnet_tpu/contrib/io.py`; reference:
python/mxnet/contrib/io.py DataLoaderIter — wraps a gluon DataLoader as a
module-style DataIter)."""
from __future__ import annotations

from ..io import DataBatch, DataDesc, DataIter

__all__ = ["DataLoaderIter"]


class DataLoaderIter(DataIter):
    """reference: contrib/io.py DataLoaderIter."""

    def __init__(self, loader, data_name="data", label_name="softmax_label"):
        super().__init__()
        self._loader = loader
        self._iter = iter(loader)
        self._data_name = data_name
        self._label_name = label_name
        self._current = None

    @property
    def provide_data(self):
        batch = self._peek()
        if batch is None:
            return []
        data = batch[0] if isinstance(batch, (list, tuple)) else batch
        return [DataDesc(self._data_name, data.shape, data.dtype)]

    @property
    def provide_label(self):
        batch = self._peek()
        if batch is None or not isinstance(batch, (list, tuple)) \
                or len(batch) < 2:
            return []
        label = batch[1]
        return [DataDesc(self._label_name, label.shape, label.dtype)]

    def _peek(self):
        if self._current is None:
            try:
                self._current = next(self._iter)
            except StopIteration:
                return None
        return self._current

    def reset(self):
        self._iter = iter(self._loader)
        self._current = None

    def next(self):
        batch = self._peek()
        if batch is None:
            raise StopIteration
        self._current = None
        if isinstance(batch, (list, tuple)):
            data, label = [batch[0]], [batch[1]] if len(batch) > 1 else None
        else:
            data, label = [batch], None
        return DataBatch(data=data, label=label)
