"""Module: bind a Symbol to a device and train it (counterpart of
`mxnet_tpu/module/module.py`; reference: python/mxnet/module/module.py —
bind :364, init_params :259, init_optimizer :474, forward :575, backward
:629, update :646).

One `Executor` over the whole batch, on the first context, whatever
the number of contexts: the JAX package binds one executor over a ``dp``
mesh of the contexts (module.py:7-12), whose graph is the whole batch, so
a training BatchNorm takes the whole batch's moments and the loss heads
normalise over it; one executor on contexts that share a torch device
(``[cpu(0), cpu(1)]``, or one card) is exactly that computation.
``context`` defaults to `current_context` (the card unless a ``scope``
chose the CPU). Contexts on distinct cards raise: one process over
several cards is ROADMAP queue 1 item 11 (distinct cards in one process
are not run). `init_optimizer` takes every kvstore name the JAX `Module`
takes and, as it does, runs every one as the synchronous ``device`` store
of one process (no sum over ranks; ROADMAP "Not queued"). `update`
applies the optimizer to each parameter in place through its `Updater`,
one parameter at a time.
"""
from __future__ import annotations

import logging

from ..base import MXNetError
from .. import context as ctx_mod
from .. import ndarray as nd
from .. import optimizer as opt_mod
from ..initializer import InitDesc
from ..io import DataDesc
from ..ndarray import NDArray
from .base_module import BaseModule

__all__ = ["Module"]


def _normalize_shapes(shapes, default_names):
    """Accept [('name', shape)] / [DataDesc] / [shape]."""
    out = []
    for i, s in enumerate(shapes or []):
        if isinstance(s, DataDesc):
            out.append((s.name, tuple(s.shape)))
        elif isinstance(s, (list, tuple)) and len(s) == 2 \
                and isinstance(s[0], str):
            out.append((s[0], tuple(s[1])))
        else:
            name = default_names[i] if i < len(default_names) \
                else "data%d" % i
            out.append((name, tuple(s)))
    return out


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None, compression_params=None):
        super().__init__(logger=logger)
        if context is None:
            context = ctx_mod.current_context()
        if not isinstance(context, (list, tuple)):
            context = [context]
        self._context = [ctx_mod.as_context(c) for c in context]
        if not self._context:
            raise MXNetError("Module: an empty list of contexts")
        devices = {ctx_mod.resolve_device(c) for c in self._context}
        if len(devices) > 1:
            raise MXNetError(
                "Module: contexts %s lie on %d devices; one executor over the "
                "whole batch runs on one device, and one process over "
                "several cards is not ported yet (ROADMAP queue 1 item 11; "
                "run one process a card with kvstore='dist_sync' through "
                "gluon.Trainer)" % (self._context, len(devices)))
        self._symbol = symbol
        self._data_names = list(data_names or [])
        self._label_names = list(label_names or [])
        self._fixed_param_names = set(fixed_param_names or [])

        arg_names = symbol.list_arguments()
        input_names = set(self._data_names + self._label_names)
        self._param_names = [n for n in arg_names if n not in input_names]
        self._aux_names = symbol.list_auxiliary_states()
        self._output_names = symbol.list_outputs()

        self._exec = None
        self._updater = None
        self._optimizer = None
        self._kvstore = None
        self._data_shapes = None
        self._label_shapes = None
        self._grad_req = "write"
        self._params_cache = None   # (arg, aux) a `load` read from disk

    # -- properties --------------------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        return [DataDesc(n, s) for n, s in self._data_shapes or []]

    @property
    def label_shapes(self):
        return [DataDesc(n, s) for n, s in self._label_shapes or []]

    @property
    def output_shapes(self):
        """(name, shape) of each output: the last forward's, and before the
        first forward the shapes inferred from the bound inputs, as the
        reference's Module gives them after `bind` (`SequentialModule`
        wires a chain from them). The JAX package's list is empty until a
        forward."""
        assert self.binded
        shapes = [tuple(o.shape) for o in self._exec.outputs or []]
        if not shapes:
            args = set(self._symbol.list_arguments())
            known = {n: s for n, s in list(self._data_shapes or [])
                     + list(self._label_shapes or []) if n in args}
            shapes = [tuple(s) for s in self._symbol.infer_shape(**known)[1]]
        return list(zip(self._output_names, shapes))

    # -- bind --------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Allocate the arguments, gradients and aux states from the input
        shapes (reference: module.py:364). Parameters are written only by
        `update`; data and labels take no gradient unless
        ``inputs_need_grad``. With ``shared_module`` its arrays of the same
        name and shape are used as they are (one storage)."""
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._grad_req = grad_req

        data_shapes = _normalize_shapes(data_shapes, self._data_names)
        label_shapes = _normalize_shapes(label_shapes, self._label_names) \
            if label_shapes else []
        self._data_shapes = data_shapes
        self._label_shapes = label_shapes

        arg_names = self._symbol.list_arguments()
        # label arguments absent from the graph (predict-time binding) drop
        shape_kwargs = {k: v for k, v in dict(data_shapes
                                              + label_shapes).items()
                        if k in arg_names}
        req = {}
        for n in arg_names:
            if n in self._fixed_param_names:
                req[n] = "null"
            elif n in dict(data_shapes):
                req[n] = grad_req if (for_training and inputs_need_grad) \
                    else "null"
            elif n in dict(label_shapes):
                req[n] = "null"
            else:
                req[n] = grad_req if for_training else "null"
        shared = shared_module._exec if shared_module is not None else None
        self._exec = self._symbol.simple_bind(
            ctx=self._context[0], grad_req=req, shared_exec=shared,
            **shape_kwargs)
        self.binded = True

    # -- params ------------------------------------------------------------
    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        """Fill each parameter and aux state from ``arg_params`` /
        ``aux_params`` by name, else from ``initializer`` (reference:
        module.py:259); a `load` checkpoint's values are the default. An
        integer parameter (the int8 weights of
        `contrib.quantization.quantize_params`) is bound as it is: its
        argument is rebound to an array of that dtype, never cast to the
        bound float array's."""
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before init_params"
        if self._params_cache is not None:
            arg_params = self._params_cache[0] if arg_params is None \
                else arg_params
            aux_params = self._params_cache[1] if aux_params is None \
                else aux_params
        attr_dict = self._symbol.attr_dict()
        for names, arrays, params in (
                (self._param_names, self._exec.arg_dict, arg_params),
                (self._aux_names, self._exec.aux_dict, aux_params)):
            for name in names:
                arr = arrays[name]
                if params is not None and name in params:
                    src = params[name]
                    if isinstance(src, NDArray) and src.dtype != arr.dtype \
                            and not src._data.is_floating_point() \
                            and names is self._param_names:
                        self._exec._feed(name, src)
                        continue
                    arr._set_data(src._data if isinstance(src, NDArray)
                                  else nd.array(src, ctx=arr.context)._data)
                elif initializer is not None:
                    initializer(InitDesc(name, attrs=attr_dict.get(name, {})),
                                arr)
                elif not allow_missing and names is self._param_names:
                    raise MXNetError("no initializer and no value for '%s'"
                                     % name)
        self.params_initialized = True

    def get_params(self):
        """Host (CPU) copies of the parameters and aux states, by name
        (reference: module.py get_params)."""
        assert self.binded and self.params_initialized
        cpu = ctx_mod.cpu()
        return ({n: self._exec.arg_dict[n].copyto(cpu)
                 for n in self._param_names},
                {n: self._exec.aux_dict[n].copyto(cpu)
                 for n in self._aux_names})

    # -- optimizer ---------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """The optimizer and its updater (reference: module.py:474), with
        the default ``rescale_grad = 1 / data_shapes[0][1][0]`` (the loss
        heads' gradients are sums over the batch). Every kvstore is taken
        and runs as the synchronous ``device`` store: the one executor's
        gradients are already the whole batch's (the JAX package's
        divergence from the reference, kept)."""
        if self.optimizer_initialized and not force_init:
            return
        assert self.binded and self.params_initialized
        if isinstance(optimizer, opt_mod.Optimizer):
            opt = optimizer
        else:
            opt_params = dict(optimizer_params or {})
            opt_params.setdefault("param_idx2name", dict(
                enumerate(self._param_names)))
            if self._data_shapes:
                opt_params.setdefault("rescale_grad",
                                      1.0 / self._data_shapes[0][1][0])
            opt = opt_mod.create(optimizer, **opt_params)
        self._optimizer = opt
        self._updater = opt_mod.get_updater(opt)
        self._kvstore = kvstore
        self.optimizer_initialized = True

    # -- execution ---------------------------------------------------------
    def _feeds(self, data_batch):
        feeds = {}
        data = data_batch.data if hasattr(data_batch, "data") else data_batch
        for (name, _), arr in zip(self._data_shapes, data):
            feeds[name] = arr
        labels = getattr(data_batch, "label", None) or []
        for (name, _), arr in zip(self._label_shapes, labels):
            if name in self._exec._arg_names:
                feeds[name] = arr
        return feeds

    def forward(self, data_batch, is_train=None):
        """reference: module.py:575."""
        assert self.binded and self.params_initialized
        if is_train is None:
            is_train = self.for_training
        self._exec.forward(is_train=is_train, **self._feeds(data_batch))

    def backward(self, out_grads=None):
        """reference: module.py:629."""
        assert self.binded and self.params_initialized
        self._exec.backward(out_grads=out_grads)

    def update(self):
        """The optimizer on each parameter with its gradient (reference:
        module.py:646)."""
        assert self.optimizer_initialized
        for i, name in enumerate(self._param_names):
            if self._exec.grad_req.get(name, "null") == "null":
                continue
            grad = self._exec.grad_dict[name]
            if grad is not None:
                self._updater(i, grad, self._exec.arg_dict[name])

    def get_outputs(self, merge_multi_context=True):
        assert self.binded
        return list(self._exec.outputs)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.inputs_need_grad
        return [self._exec.grad_dict[n] for n, _ in self._data_shapes]

    def update_metric(self, eval_metric, labels):
        eval_metric.update(labels, self.get_outputs())

    def install_monitor(self, mon):
        """``mon`` (a `Monitor`) on this module's executor (reference:
        module.py install_monitor)."""
        mon.install(self._exec)

    # -- checkpointing -----------------------------------------------------
    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """``prefix-symbol.json`` and ``prefix-%04d.params`` (reference:
        module.py save_checkpoint, model.py:394), with ``prefix-%04d.states``
        too when asked."""
        from ..model import save_checkpoint

        arg_params, aux_params = self.get_params()
        save_checkpoint(prefix, epoch, self.symbol, arg_params, aux_params)
        if save_optimizer_states:
            self.save_optimizer_states("%s-%04d.states" % (prefix, epoch))

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module over a checkpoint's symbol whose `init_params` takes the
        checkpoint's values (reference: module.py load). The arrays are read
        onto the CPU and copied to the module's device by `init_params`."""
        from ..model import load_checkpoint

        sym, arg_params, aux_params = load_checkpoint(prefix, epoch)
        mod = Module(sym, **kwargs)
        mod._params_cache = (arg_params, aux_params)
        return mod

    def load_params(self, fname):
        from ..model import load_params as _load

        arg_params, aux_params = _load(fname)
        self.set_params(arg_params, aux_params)

    def save_params(self, fname):
        arg_params, aux_params = self.get_params()
        save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
        save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
        nd.save(fname, save_dict)

    def save_optimizer_states(self, fname):
        from ..base import atomic_writer

        assert self.optimizer_initialized
        with atomic_writer(fname, "wb") as f:
            f.write(self._updater.get_states())

    def load_optimizer_states(self, fname):
        assert self.optimizer_initialized
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())

    def reshape(self, data_shapes, label_shapes=None):
        """Re-bind at new input shapes (reference: module.py reshape); the
        arrays whose shapes stay (parameters, gradients, aux states) are
        the same arrays."""
        self.bind(data_shapes, label_shapes, for_training=self.for_training,
                  inputs_need_grad=self.inputs_need_grad, force_rebind=True,
                  shared_module=self, grad_req=self._grad_req)
