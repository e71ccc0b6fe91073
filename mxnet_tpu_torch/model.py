"""Checkpoint files (counterpart of `mxnet_tpu/model.py`; reference:
python/mxnet/model.py — save_checkpoint :394, load_checkpoint :424).

``prefix-symbol.json`` holds the graph (`Symbol.tojson`) and
``prefix-%04d.params`` the arrays in the ``nd.save`` container under
``arg:<name>`` / ``aux:<name>`` keys: the JAX package's files, so either
package loads the other's. The legacy ``FeedForward`` estimator is not
ported yet (ROADMAP queue 1 item 8).
"""
from __future__ import annotations

import logging

from . import ndarray as nd
from . import symbol as sym_mod
from .context import cpu

__all__ = ["save_checkpoint", "load_checkpoint", "load_params",
           "BatchEndParam"]

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
