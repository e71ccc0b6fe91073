"""BaseModule: the symbolic training-loop interface (counterpart of
`mxnet_tpu/module/base_module.py`; reference:
python/mxnet/module/base_module.py — fit :409, forward_backward :193).

`fit` is the reference's epoch loop of `forward_backward`, `update`,
`update_metric` and the callbacks, with `score` on the evaluation data.
Not ported yet: ``checkpoint_dir=`` / ``resume=`` and the preemption
handler (they need ``parallel/resilience.py``, ROADMAP queue 1 item 13),
a ``monitor`` (``monitor.py``, item 8), and the fused one-step path (the
captured step, item 2): those arguments raise.
"""
from __future__ import annotations

import logging
import time

from .. import env as _env
from ..base import MXNetError, unpad_outputs
from .. import metric as metric_mod
from .. import ndarray as nd

__all__ = ["BaseModule", "BatchEndParam"]


def _as_metric(m):
    if isinstance(m, metric_mod.EvalMetric):
        return m
    return metric_mod.create(m)


class BaseModule(object):
    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self.inputs_need_grad = False
        self._symbol = None

    # -- abstract interface (Module implements) ----------------------------
    def forward(self, data_batch, is_train=None):
        raise NotImplementedError()

    def backward(self, out_grads=None):
        raise NotImplementedError()

    def update(self):
        raise NotImplementedError()

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError()

    def update_metric(self, eval_metric, labels):
        raise NotImplementedError()

    def bind(self, *args, **kwargs):
        raise NotImplementedError()

    def init_params(self, *args, **kwargs):
        raise NotImplementedError()

    # -- composite ops -----------------------------------------------------
    def forward_backward(self, data_batch):
        """reference: base_module.py:193."""
        self.forward(data_batch, is_train=True)
        self.backward()

    def supports_fused_step(self):
        """The fused one-step path is not ported (ROADMAP queue 1 item 2):
        `fit` always runs `forward_backward` and `update`."""
        return False

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0, sparse_row_id_fn=None):
        """Forward ``eval_data`` (``is_train=False``) into ``eval_metric``;
        its name-value pairs (reference: base_module.py score)."""
        assert self.binded and self.params_initialized
        eval_metric = _as_metric(eval_metric)
        eval_metric.reset()
        if reset:
            eval_data.reset()
        nbatch = 0
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            for cb in _as_list(batch_end_callback):
                cb(BatchEndParam(epoch=epoch, nbatch=nbatch,
                                 eval_metric=eval_metric, locals=locals()))
        for cb in _as_list(score_end_callback):
            cb(BatchEndParam(epoch=epoch, nbatch=nbatch,
                             eval_metric=eval_metric, locals=locals()))
        return eval_metric.get_name_value()

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False,
                sparse_row_id_fn=None):
        """The outputs over ``eval_data``, padding removed, concatenated over
        the batches (reference: base_module.py predict)."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        output_list = []
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = getattr(eval_batch, "pad", 0) or 0
            output_list.append(unpad_outputs(self.get_outputs(), pad,
                                             copy=True))
        if not output_list:
            return output_list
        if merge_batches:
            num_outputs = len(output_list[0])
            for o in output_list:
                if len(o) != num_outputs:
                    raise MXNetError("cannot merge batches with different "
                                     "numbers of outputs")
            merged = [nd.concat(*[o[i] for o in output_list], dim=0)
                      for i in range(num_outputs)]
            if num_outputs == 1 and not always_output_list:
                return merged[0]
            return merged
        return output_list

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        """Yield ``(outputs, nbatch, batch)`` over ``eval_data``."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = getattr(eval_batch, "pad", 0) or 0
            yield unpad_outputs(self.get_outputs(), pad), nbatch, eval_batch

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            optimizer="sgd", optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, sparse_row_id_fn=None,
            checkpoint_dir=None, checkpoint_period=1, resume=None):
        """The symbolic training loop (reference: base_module.py:409): bind,
        init_params (``initializer`` default `Uniform(0.01)`),
        init_optimizer, then each epoch every batch's `forward_backward`,
        `update`, `update_metric` and ``batch_end_callback``; at the
        epoch's end ``epoch_end_callback(epoch, symbol, arg_params,
        aux_params)`` and `score` on ``eval_data``. With
        ``MXTPU_DATA_PREFETCH`` set the batches come through a
        `data.DevicePrefetcher` onto the module's device."""
        assert num_epoch is not None, "please specify number of epochs"
        if checkpoint_dir is not None or resume is not None:
            raise MXNetError("fit(checkpoint_dir=, resume=) needs "
                             "parallel/resilience.py, which is not ported "
                             "yet (ROADMAP queue 1 item 13)")
        if monitor is not None:
            raise MXNetError("fit(monitor=) needs monitor.py, which is not "
                             "ported yet (ROADMAP queue 1 item 8)")
        from ..initializer import Uniform

        initializer = initializer or Uniform(0.01)
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        if validation_metric is None:
            validation_metric = eval_metric
        eval_metric = _as_metric(eval_metric)

        # MXTPU_DATA_PREFETCH: batch N+1's host work and its copy to this
        # module's device overlap batch N's compute
        use_prefetch = _env.get("MXTPU_DATA_PREFETCH")
        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            eval_metric.reset()
            train_data.reset()
            batches = iter(train_data)
            if use_prefetch:
                from ..data import DevicePrefetcher

                batches = DevicePrefetcher(
                    batches, mesh=getattr(self, "_context", None), src="fit")
            try:
                for nbatch, data_batch in enumerate(batches):
                    self.forward_backward(data_batch)
                    self.update()
                    self.update_metric(eval_metric, data_batch.label)
                    for cb in _as_list(batch_end_callback):
                        cb(BatchEndParam(epoch=epoch, nbatch=nbatch,
                                         eval_metric=eval_metric,
                                         locals=locals()))
            finally:
                if use_prefetch:
                    batches.close()
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.time() - tic)

            arg_p, aux_p = self.get_params()
            for cb in _as_list(epoch_end_callback):
                cb(epoch, self.symbol, arg_p, aux_p)

            if eval_data is not None:
                res = self.score(eval_data, validation_metric,
                                 score_end_callback=eval_end_callback,
                                 batch_end_callback=eval_batch_end_callback,
                                 epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)

    # -- misc --------------------------------------------------------------
    @property
    def symbol(self):
        return self._symbol

    def get_params(self):
        raise NotImplementedError()

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    def install_monitor(self, mon):
        raise MXNetError("monitor.py is not ported yet (ROADMAP queue 1 "
                         "item 8)")

    def get_input_grads(self, merge_multi_context=True):
        raise NotImplementedError()


class BatchEndParam(object):
    """What a batch-end callback gets (reference: callback BatchEndParam)."""

    def __init__(self, epoch, nbatch, eval_metric, locals=None):
        self.epoch = epoch
        self.nbatch = nbatch
        self.eval_metric = eval_metric
        self.locals = locals


def _as_list(obj):
    if obj is None:
        return []
    if isinstance(obj, (list, tuple)):
        return list(obj)
    return [obj]
