"""The legacy data-parallel executor manager (counterpart of
`mxnet_tpu/executor_manager.py`; reference:
python/mxnet/executor_manager.py, the helper of the pre-Module
``FeedForward``): the batch is cut into one slice a context, each slice
runs on an `Executor` of its own, bound on that context, and the
gradients stay per executor, one list a parameter (`grad_arrays`), for
the caller to sum in context order and apply. Each slice's executor takes
its own statistics (a training BatchNorm normalises over its slice), as
in the JAX package. New code uses `Module` or `gluon.Trainer`.
"""
from __future__ import annotations

import logging

import numpy as _np
import torch

from .base import MXNetError
from .executor import Executor
from .ndarray import NDArray, zeros as _nd_zeros

__all__ = ["DataParallelExecutorManager", "_split_input_slice",
           "_check_arguments"]


def _split_input_slice(batch_size, work_load_list):
    """The batch's row ranges, one a context, in proportion to
    ``work_load_list`` (reference: executor_manager.py:31)."""
    total = sum(work_load_list)
    if batch_size < len(work_load_list):
        raise MXNetError("batch size %d smaller than device count %d"
                         % (batch_size, len(work_load_list)))
    slices = []
    start = 0
    for i, w in enumerate(work_load_list):
        if i == len(work_load_list) - 1:
            end = batch_size
        else:
            end = start + int(round(batch_size * w / total))
        if end <= start:
            raise MXNetError("Too many slices. Some splits are empty.")
        slices.append(slice(start, end))
        start = end
    return slices


def _check_arguments(symbol):
    """Refuse a graph that names an argument or aux state twice
    (reference: executor_manager.py:68)."""
    names = symbol.list_arguments() + symbol.list_auxiliary_states()
    seen = set()
    for n in names:
        if n in seen:
            raise MXNetError("Find duplicated argument name \"%s\"" % n)
        seen.add(n)


class DataParallelExecutorManager:
    """One executor a context over its slice of each batch (reference:
    executor_manager.py:298); `param_arrays` / `grad_arrays` /
    `aux_arrays` are a list a name of the executors' arrays."""

    def __init__(self, symbol, ctx, train_data, arg_params=None,
                 aux_params=None, param_names=None, arg_names=None,
                 aux_names=None, work_load_list=None, logger=logging,
                 sym_gen=None):
        if sym_gen is not None:
            raise MXNetError("sym_gen (bucketing) is not supported by this "
                             "manager; use BucketingModule "
                             "(module/bucketing_module.py)")
        self.symbol = symbol
        self.ctx = list(ctx)
        if work_load_list is None:
            work_load_list = [1] * len(self.ctx)
        self.slices = _split_input_slice(train_data.batch_size,
                                         work_load_list)
        _check_arguments(symbol)
        self.arg_names = arg_names or symbol.list_arguments()
        self.aux_names = aux_names or symbol.list_auxiliary_states()
        data_shapes = {d[0]: tuple(d[1]) for d in train_data.provide_data}
        label_shapes = {d[0]: tuple(d[1])
                        for d in (train_data.provide_label or [])}
        self._data_names = list(data_shapes)
        self._label_names = list(label_shapes)
        self.param_names = param_names or [
            n for n in self.arg_names
            if n not in data_shapes and n not in label_shapes]
        arg_shapes, _, aux_shapes = symbol.infer_shape(**data_shapes,
                                                       **label_shapes)
        # infer_shape answers in the symbol's argument order
        shape_of = dict(zip(symbol.list_arguments(), arg_shapes))
        aux_shape_of = dict(zip(symbol.list_auxiliary_states(), aux_shapes))

        self.execs = []
        for dev, sl in zip(self.ctx, self.slices):
            n = sl.stop - sl.start
            args, grads = {}, {}
            for name in self.arg_names:
                if name in data_shapes:
                    shp = (n,) + data_shapes[name][1:]
                elif name in label_shapes:
                    shp = (n,) + label_shapes[name][1:]
                else:
                    shp = shape_of[name]
                args[name] = _nd_zeros(shp, ctx=dev)
                if name in self.param_names:
                    grads[name] = _nd_zeros(shp, ctx=dev)
            aux = {name: _nd_zeros(aux_shape_of[name], ctx=dev)
                   for name in self.aux_names}
            # gradients of the parameters only (labels are often integers)
            req = {name: ("write" if name in self.param_names else "null")
                   for name in self.arg_names}
            self.execs.append(Executor(symbol, dev, args, args_grad=grads,
                                       grad_req=req, aux_states=aux))
        if arg_params is not None:
            self.set_params(arg_params, aux_params or {})

    @property
    def param_arrays(self):
        return [[e.arg_dict[name] for e in self.execs]
                for name in self.param_names]

    @property
    def grad_arrays(self):
        return [[e.grad_dict[name] for e in self.execs]
                for name in self.param_names]

    @property
    def aux_arrays(self):
        return [[e.aux_dict[name] for e in self.execs]
                for name in self.aux_names]

    def install_monitor(self, monitor):
        for e in self.execs:
            monitor.install(e)

    def set_params(self, arg_params, aux_params):
        for e in self.execs:
            e.copy_params_from(arg_params, aux_params,
                               allow_extra_params=True)

    def copy_to(self, arg_params, aux_params):
        """The parameters and aux states averaged over the executors into
        the dicts, as host arrays (reference: executor_manager.py
        copy_to)."""
        for names, arrays, out in ((self.param_names, "arg_dict",
                                    arg_params),
                                   (self.aux_names, "aux_dict", aux_params)):
            for name in names:
                vals = [getattr(e, arrays)[name].asnumpy()
                        for e in self.execs]
                out[name] = NDArray(torch.from_numpy(_np.mean(
                    vals, axis=0).astype(vals[0].dtype)))

    def load_data_batch(self, data_batch):
        """Each executor's slice of the batch's data and labels."""
        for names, arrays in ((self._data_names, data_batch.data),
                              (self._label_names, data_batch.label or [])):
            for name, arr in zip(names, arrays):
                full = arr._data if isinstance(arr, NDArray) \
                    else torch.from_numpy(_np.asarray(arr))
                for e, sl in zip(self.execs, self.slices):
                    e.arg_dict[name]._set_data(full[sl])

    def forward(self, is_train=False):
        for e in self.execs:
            e.forward(is_train=is_train)

    def backward(self):
        for e in self.execs:
            e.backward()

    def update_metric(self, metric, labels, pre_sliced=False):
        for i, (e, sl) in enumerate(zip(self.execs, self.slices)):
            lab = labels[i] if pre_sliced else \
                [lbl[sl.start:sl.stop] for lbl in labels]
            metric.update(lab, e.outputs)
