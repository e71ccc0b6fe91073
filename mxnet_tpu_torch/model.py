"""Checkpoint files (counterpart of `mxnet_tpu/model.py`; reference:
python/mxnet/model.py — save_checkpoint :394, load_checkpoint :424).

``prefix-symbol.json`` holds the graph (`Symbol.tojson`) and
``prefix-%04d.params`` the arrays in the ``nd.save`` container under
``arg:<name>`` / ``aux:<name>`` keys: the JAX package's files, so either
package loads the other's. ``FeedForward`` is the legacy estimator
(reference: model.py:462), a thin veneer over `Module`, as in the JAX
package.
"""
from __future__ import annotations

import logging

from . import ndarray as nd
from . import symbol as sym_mod
from .context import cpu

__all__ = ["save_checkpoint", "load_checkpoint", "load_params",
           "FeedForward", "BatchEndParam"]

from .module.base_module import BatchEndParam  # noqa: E402 (re-export)


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    remove_amp_cast=True):
    """Write ``prefix-symbol.json`` (when ``symbol`` is given) and
    ``prefix-%04d.params`` (reference: model.py:394)."""
    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
    nd.save("%s-%04d.params" % (prefix, epoch), save_dict)
    logging.info("Saved checkpoint to \"%s-%04d.params\"", prefix, epoch)


def load_params(fname):
    """``(arg_params, aux_params)`` of an ``arg:`` / ``aux:`` keyed params
    file (or its bytes), on the CPU (reference: model.py:424)."""
    arg_params, aux_params = {}, {}
    for k, v in nd.load(fname, ctx=cpu()).items():
        tp, _, name = k.partition(":")
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
        else:
            arg_params[k] = v
    return arg_params, aux_params


def load_checkpoint(prefix, epoch):
    """``(symbol, arg_params, aux_params)`` (reference: model.py:424)."""
    symbol = sym_mod.load("%s-symbol.json" % prefix)
    arg_params, aux_params = load_params("%s-%04d.params" % (prefix, epoch))
    return symbol, arg_params, aux_params


class FeedForward(object):
    """The legacy estimator over one `Module` (reference: model.py:462,
    deprecated there in favour of Module): `fit` trains it for
    ``num_epoch`` epochs with ``optimizer`` (``optimizer_params`` among the
    keyword arguments) from ``initializer`` (default `Uniform(0.01)`) or
    the given parameters; `predict` returns numpy outputs; `save` / `load`
    are the ``prefix-symbol.json`` / ``prefix-%04d.params`` files."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=None, numpy_batch_size=128,
                 arg_params=None, aux_params=None, allow_extra_params=False,
                 begin_epoch=0, **kwargs):
        from .initializer import Uniform

        self.symbol = symbol
        self.ctx = ctx
        self.num_epoch = num_epoch
        self.optimizer = optimizer
        self.initializer = initializer or Uniform(0.01)
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.begin_epoch = begin_epoch
        self.kwargs = kwargs
        self._module = None

    def _mod(self, label_names=("softmax_label",)):
        from .module import Module

        if self._module is None:
            self._module = Module(self.symbol, context=self.ctx,
                                  label_names=list(label_names))
        return self._module

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            logger=None, work_load_list=None, monitor=None,
            eval_end_callback=None, eval_batch_end_callback=None):
        """Train on the iterator ``X``; the trained parameters become this
        estimator's. Returns self."""
        mod = self._mod()
        mod.fit(X, eval_data=eval_data, eval_metric=eval_metric,
                epoch_end_callback=epoch_end_callback,
                batch_end_callback=batch_end_callback, kvstore=kvstore,
                optimizer=self.optimizer,
                optimizer_params=dict(self.kwargs.get(
                    "optimizer_params", {"learning_rate": 0.01})),
                initializer=self.initializer, arg_params=self.arg_params,
                aux_params=self.aux_params, begin_epoch=self.begin_epoch,
                num_epoch=self.num_epoch)
        self.arg_params, self.aux_params = mod.get_params()
        return self

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        """The outputs over the iterator ``X``, as numpy."""
        mod = self._mod()
        if not mod.binded:
            mod.bind(X.provide_data, X.provide_label, for_training=False)
            mod.init_params(self.initializer, self.arg_params,
                            self.aux_params, allow_missing=False)
        out = mod.predict(X, num_batch=num_batch, reset=reset)
        return out.asnumpy() if hasattr(out, "asnumpy") else out

    def save(self, prefix, epoch=None):
        save_checkpoint(prefix, epoch if epoch is not None else self.num_epoch,
                        self.symbol, self.arg_params or {},
                        self.aux_params or {})

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch, **kwargs)
