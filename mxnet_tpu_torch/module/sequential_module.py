"""SequentialModule: modules in a chain, each one's outputs the next one's
data (counterpart of `mxnet_tpu/module/sequential_module.py`; reference:
python/mxnet/module/sequential_module.py).

`add(module, take_labels=False, auto_wiring=False)`: ``take_labels`` binds
the module with the chain's labels and feeds it the batch's labels (a
loss head); ``auto_wiring`` binds it with its own data names over the
previous module's output shapes. The backward runs the chain in reverse,
each module's input gradients the previous one's ``out_grads``.
"""
from __future__ import annotations

import logging

from ..io import DataBatch, DataDesc
from .base_module import BaseModule

__all__ = ["SequentialModule"]


class SequentialModule(BaseModule):
    META_TAKE_LABELS = "take_labels"
    META_AUTO_WIRING = "auto_wiring"

    def __init__(self, logger=logging):
        super().__init__(logger=logger)
        self._modules = []
        self._metas = []
        self._label_shapes = None

    def add(self, module, **kwargs):
        """Append ``module`` with its meta (``take_labels``,
        ``auto_wiring``); returns self, for chaining."""
        self._modules.append(module)
        self._metas.append(kwargs)
        return self

    @property
    def data_shapes(self):
        return self._modules[0].data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes or []

    @property
    def output_shapes(self):
        return self._modules[-1].output_shapes

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            return
        assert shared_module is None
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._label_shapes = label_shapes
        cur_shapes = data_shapes
        for i, (module, meta) in enumerate(zip(self._modules, self._metas)):
            mod_labels = label_shapes \
                if meta.get(self.META_TAKE_LABELS, False) else None
            # every module after the first passes a gradient back
            need_grad = inputs_need_grad if i == 0 else True
            if meta.get(self.META_AUTO_WIRING, False) and i > 0:
                prev = self._modules[i - 1].output_shapes
                cur_shapes = [(module.data_names[j], s)
                              for j, (_, s) in enumerate(prev)]
            module.bind(cur_shapes, mod_labels, for_training,
                        inputs_need_grad=need_grad,
                        force_rebind=force_rebind, grad_req=grad_req)
            cur_shapes = module.output_shapes
        self.binded = True

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        for module in self._modules:
            module.init_params(initializer, arg_params, aux_params,
                               allow_missing=True, force_init=force_init,
                               allow_extra=True)
        self.params_initialized = True

    def get_params(self):
        arg_params, aux_params = {}, {}
        for module in self._modules:
            a, x = module.get_params()
            arg_params.update(a)
            aux_params.update(x)
        return arg_params, aux_params

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        for module in self._modules:
            module.init_optimizer(kvstore, optimizer, optimizer_params,
                                  force_init)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        batch = data_batch
        for i, module in enumerate(self._modules):
            module.forward(batch, is_train=is_train)
            if i == len(self._modules) - 1:
                break
            outs = module.get_outputs()
            label = data_batch.label \
                if self._metas[i + 1].get(self.META_TAKE_LABELS, False) \
                else []
            batch = DataBatch(
                data=outs, label=label,
                provide_data=[DataDesc("data%d" % j, tuple(o.shape))
                              for j, o in enumerate(outs)])

    def backward(self, out_grads=None):
        for i, module in reversed(list(enumerate(self._modules))):
            module.backward(out_grads)
            if i == 0:
                break
            out_grads = module.get_input_grads()

    def update(self):
        for module in self._modules:
            module.update()

    def get_outputs(self, merge_multi_context=True):
        return self._modules[-1].get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.inputs_need_grad
        return self._modules[0].get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        for module, meta in zip(self._modules, self._metas):
            if meta.get(self.META_TAKE_LABELS, False):
                module.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        for module in self._modules:
            module.install_monitor(mon)
