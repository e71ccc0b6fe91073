"""Module: bind a Symbol to a device and train it (counterpart of
`mxnet_tpu/module/module.py`; reference: python/mxnet/module/module.py —
bind :364, init_params :259, init_optimizer :474, forward :575, backward
:629, update :646).

One `Executor` on one device. ``context`` defaults to `current_context`
(the card unless a ``scope`` chose the CPU); a list of more than one
device, and the dist kvstores, raise (multi-card training is ROADMAP queue
1 item 11). `update` applies the optimizer to each parameter in place
through its `Updater`, one parameter at a time.
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
        if isinstance(context, (list, tuple)):
            if len(context) != 1:
                raise MXNetError("Module: one device only; %d devices need "
                                 "multi-card training, which is not ported "
                                 "yet (ROADMAP queue 1 item 11)"
                                 % len(context))
            context = context[0]
        self._context = ctx_mod.resolve_device(context) \
            if context is not None else ctx_mod.current_context()
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
        assert self.binded
        return list(zip(self._output_names,
                        [tuple(o.shape) for o in self._exec.outputs]))

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
            ctx=self._context, grad_req=req, shared_exec=shared,
            **shape_kwargs)
        self.binded = True

    # -- params ------------------------------------------------------------
    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        """Fill each parameter and aux state from ``arg_params`` /
        ``aux_params`` by name, else from ``initializer`` (reference:
        module.py:259); a `load` checkpoint's values are the default."""
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
        heads' gradients are sums over the batch). kvstore "local" and
        "device" are the same here: one device."""
        if self.optimizer_initialized and not force_init:
            return
        assert self.binded and self.params_initialized
        if kvstore not in (None, "local", "device") \
                and not (isinstance(kvstore, str)
                         and kvstore.startswith("local")):
            raise MXNetError("kvstore %r is not ported yet (ROADMAP queue 1 "
                             "item 11); use 'local' or 'device'" % (kvstore,))
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
