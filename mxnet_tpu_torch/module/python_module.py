"""Modules written in Python, to put into module pipelines (counterpart
of `mxnet_tpu/module/python_module.py`; reference:
python/mxnet/module/python_module.py): `PythonModule` implements the
module interface as mostly empty hooks, and `PythonLossModule` turns a
scores -> gradient function into a loss head for `SequentialModule`."""
from __future__ import annotations

import logging

import numpy as _np

from .base_module import BaseModule

__all__ = ["PythonModule", "PythonLossModule"]


def _names(descs):
    return [d[0] if isinstance(d, (tuple, list)) else d.name for d in descs]


class PythonModule(BaseModule):
    """A module without parameters (reference: python_module.py:28).
    Subclasses implement `forward` and `_compute_output_shapes`."""

    def __init__(self, data_names, label_names, output_names,
                 logger=logging):
        super().__init__(logger=logger)
        self._data_names = list(data_names)
        self._label_names = None if label_names is None else list(label_names)
        self._output_names = list(output_names)
        self._data_shapes = None
        self._label_shapes = None
        self._output_shapes = None

    # -- names and shapes --------------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return self._output_shapes

    # -- parameters (none) -------------------------------------------------
    def get_params(self):
        return ({}, {})

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        self.params_initialized = True

    def update(self):
        pass

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        if self._label_shapes is None:
            return
        if pre_sliced:
            raise RuntimeError("PythonModule does not support presliced "
                               "labels")
        eval_metric.update(labels, self.get_outputs())

    # -- setup -------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        assert grad_req == "write", "Python module only support write " \
                                    "gradient"
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        assert _names(data_shapes) == self._data_names, \
            (_names(data_shapes), self._data_names)
        self._data_shapes = data_shapes
        self._label_shapes = label_shapes
        if label_shapes is not None:
            assert self._label_names is not None
            assert _names(label_shapes) == self._label_names
        self._output_shapes = self._compute_output_shapes()
        self.binded = True

    def _compute_output_shapes(self):
        raise NotImplementedError()

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self.optimizer_initialized = True


class PythonLossModule(PythonModule):
    """A loss head: scores in, their gradient out (reference:
    python_module.py:245). ``grad_func(scores, labels) -> grad`` gives the
    backward (an `NDArray`, or anything numpy takes, placed on the scores'
    context); without it, subclass `_backward_impl`."""

    def __init__(self, name="pyloss", data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 grad_func=None):
        super().__init__(data_names, label_names, [name + "_output"],
                         logger=logger)
        self._name = name
        assert len(data_names) == 1
        assert len(label_names) == 1
        self._scores = None
        self._labels = None
        self._scores_grad = None
        if grad_func is not None:
            assert callable(grad_func)
        self._grad_func = grad_func

    def _compute_output_shapes(self):
        d = self._data_shapes[0]
        shape = d[1] if isinstance(d, (tuple, list)) else d.shape
        return [(self._name + "_output", shape)]

    def forward(self, data_batch, is_train=None):
        self._scores = data_batch.data[0]
        if is_train is None:
            is_train = self.for_training
        if is_train:
            self._labels = data_batch.label[0]

    def get_outputs(self, merge_multi_context=True):
        assert merge_multi_context is True
        return [self._scores]

    def backward(self, out_grads=None):
        assert out_grads is None, "For a loss module, out_grads should " \
                                  "be None"
        assert self.for_training
        self._backward_impl()

    def _backward_impl(self):
        if self._grad_func is None:
            raise NotImplementedError()
        from .. import ndarray as nd

        grad = self._grad_func(self._scores, self._labels)
        if not isinstance(grad, nd.NDArray):
            grad = nd.array(_np.asarray(grad), ctx=self._scores.context)
        self._scores_grad = grad

    def get_input_grads(self, merge_multi_context=True):
        assert merge_multi_context is True
        return [self._scores_grad]

    def install_monitor(self, mon):
        raise NotImplementedError()
