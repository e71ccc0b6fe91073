"""BucketingModule: variable-length training with one executor a bucket
(counterpart of `mxnet_tpu/module/bucketing_module.py`; reference:
python/mxnet/module/bucketing_module.py, docs/faq/bucketing.md).

Each bucket key (a sequence length) gets a `Module` over ``sym_gen(key)``.
Every bucket's executor holds the default bucket's parameter, gradient and
aux-state arrays themselves (one storage: an update through any bucket is
seen by all), and every bucket shares the default bucket's optimizer and
updater, whose states are keyed by parameter index. Switching buckets
drops the autograd graph the previous bucket kept, so the saved tensors of
at most one bucket are alive at a time.
"""
from __future__ import annotations

import logging

from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None, compression_params=None):
        super().__init__(logger=logger)
        assert default_bucket_key is not None
        self._sym_gen = sym_gen
        self._default_bucket_key = default_bucket_key
        self._context = context
        self._fixed_param_names = fixed_param_names
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._opt_config = None

    @property
    def default_bucket_key(self):
        return self._default_bucket_key

    @property
    def symbol(self):
        return self._curr_module.symbol

    @property
    def data_shapes(self):
        return self._curr_module.data_shapes

    @property
    def label_shapes(self):
        return self._curr_module.label_shapes

    @property
    def output_shapes(self):
        return self._curr_module.output_shapes

    def _gen_module(self, bucket_key):
        sym, data_names, label_names = self._sym_gen(bucket_key)
        return Module(sym, data_names=data_names, label_names=label_names,
                      logger=self.logger, context=self._context,
                      fixed_param_names=self._fixed_param_names)

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind the default bucket's module (reference:
        bucketing_module.py:65)."""
        if self.binded and not force_rebind:
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        module = self._gen_module(self._default_bucket_key)
        module.bind(data_shapes, label_shapes, for_training, inputs_need_grad,
                    force_rebind=False, shared_module=None, grad_req=grad_req)
        self._buckets = {self._default_bucket_key: module}
        self._curr_module = module
        self._curr_bucket_key = self._default_bucket_key
        self.binded = True

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Make ``bucket_key``'s module current, binding it on first use
        over the default bucket's arrays (reference:
        bucketing_module.py:80)."""
        assert self.binded
        if self._curr_module is not None:
            self._curr_module._exec.drop_graph()
        default = self._buckets[self._default_bucket_key]
        if bucket_key not in self._buckets:
            module = self._gen_module(bucket_key)
            module.bind(data_shapes, label_shapes, self.for_training,
                        self.inputs_need_grad, force_rebind=False,
                        shared_module=default, grad_req=default._grad_req)
            ex, dex = module._exec, default._exec
            for name in module._param_names:
                if name in dex.arg_dict:
                    i, j = ex._arg_names.index(name), \
                        dex._arg_names.index(name)
                    ex.arg_arrays[i] = dex.arg_arrays[j]
                    if dex.grad_arrays[j] is not None:
                        ex.grad_arrays[i] = dex.grad_arrays[j]
            for name in module._aux_names:
                if name in dex.aux_dict:
                    ex.aux_arrays[ex._aux_names.index(name)] = \
                        dex.aux_dict[name]
            module.params_initialized = self.params_initialized
            if self._opt_config is not None:
                module._optimizer = default._optimizer
                module._updater = default._updater
                module.optimizer_initialized = True
            self._buckets[bucket_key] = module
        self._curr_module = self._buckets[bucket_key]
        self._curr_bucket_key = bucket_key

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        assert self.binded
        self._buckets[self._default_bucket_key].init_params(
            initializer, arg_params, aux_params, allow_missing, force_init,
            allow_extra)
        self.params_initialized = True
        for mod in self._buckets.values():
            mod.params_initialized = True

    def get_params(self):
        return self._buckets[self._default_bucket_key].get_params()

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        default = self._buckets[self._default_bucket_key]
        default.init_optimizer(kvstore, optimizer, optimizer_params,
                               force_init)
        self._opt_config = (kvstore, optimizer, optimizer_params)
        for mod in self._buckets.values():
            mod._optimizer = default._optimizer
            mod._updater = default._updater
            mod.optimizer_initialized = True
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        bucket_key = getattr(data_batch, "bucket_key", None)
        if bucket_key is None:
            bucket_key = self._default_bucket_key
        self.switch_bucket(bucket_key, data_batch.provide_data,
                           data_batch.provide_label)
        self._curr_module.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        self._curr_module.backward(out_grads)

    def update(self):
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        return self._curr_module.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        return self._curr_module.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        self._curr_module.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        """``mon`` on every bucket made so far (as the JAX package's
        BucketingModule installs it)."""
        for mod in self._buckets.values():
            mod.install_monitor(mon)

    # the checkpoint payloads of `fit(checkpoint_dir=)`: the buckets share
    # the default bucket's arrays and updater, so its files are the module's
    def save_params(self, fname):
        self._buckets[self._default_bucket_key].save_params(fname)

    def load_params(self, fname):
        self._buckets[self._default_bucket_key].load_params(fname)

    def save_optimizer_states(self, fname):
        self._buckets[self._default_bucket_key].save_optimizer_states(fname)

    def load_optimizer_states(self, fname):
        self._buckets[self._default_bucket_key].load_optimizer_states(fname)

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """The default bucket's symbol and the shared parameters (reference:
        bucketing_module.py save_checkpoint)."""
        self._buckets[self._default_bucket_key].save_checkpoint(
            prefix, epoch, save_optimizer_states)
