"""Executor: a bound symbolic graph (counterpart of `mxnet_tpu/executor.py`;
reference: include/mxnet/executor.h, src/executor/graph_executor.cc —
Bind :1726, SimpleBind :1694, Forward :65, Backward :78).

`forward` interprets the graph eagerly on the bound tensors. With
``is_train=True`` it runs under grad mode, each argument whose ``grad_req``
is not "null" entering as a fresh leaf that shares its array's storage,
and it keeps the autograd graph for `backward`, as the reference keeps its
forward graph (the JAX package recomputes the forward inside its backward
executable instead). The graph is dropped by `backward`, by the next
`forward` and by `drop_graph`, so the saved tensors of one batch never
outlive it. With ``is_train=False`` it runs under no_grad. So the LSTM of
the ``RNN`` op takes ``lstm_fwd`` / ``lstm_bwd`` in a training forward that
takes a gradient, and ``lstm_infer`` otherwise, including a training
forward whose every ``grad_req`` is "null" (nothing to differentiate, as
the JAX package's primal runs its residual-free kernel then).

`backward` writes (``grad_req`` "write") or adds ("add") each gradient into
`grad_arrays` in place. Loss heads ignore their head gradient; an output
given none gets ones. BatchNorm's moving statistics are written into
`aux_arrays` in place by a training forward. Random ops draw from this
thread's generator for the executor's device (`mx.random.seed`).
"""
from __future__ import annotations

import torch

from . import random as _random
from .base import MXNetError
from .context import resolve_device
from .ndarray import NDArray, array

__all__ = ["Executor"]


class Executor:
    def __init__(self, symbol, ctx, args, args_grad=None, grad_req="write",
                 aux_states=None):
        self._symbol = symbol
        self._ctx = resolve_device(ctx[0] if isinstance(ctx, (list, tuple))
                                   else ctx)
        self._arg_names = symbol.list_arguments()
        self._aux_names = symbol.list_auxiliary_states()
        self._output_names = symbol.list_outputs()

        self.arg_arrays = self._as_list(args, self._arg_names, "args")
        self.aux_arrays = self._as_list(aux_states or [], self._aux_names,
                                        "aux_states", allow_missing=True)
        self.grad_req = self._req_dict(grad_req)
        self.grad_arrays = self._grad_list(args_grad)

        self.outputs = []
        self._monitor_callback = None
        self._graph = None   # (output tensors, {arg index: leaf}) to backward

    # -- construction helpers ---------------------------------------------
    def _as_list(self, arrays, names, what, allow_missing=False):
        if isinstance(arrays, dict):
            missing = [n for n in names if n not in arrays]
            if missing and not allow_missing:
                raise MXNetError("%s missing arrays for %s" % (what, missing))
            return [arrays.get(n) for n in names]
        arrays = list(arrays)
        if len(arrays) != len(names):
            if allow_missing and not arrays:
                return [None] * len(names)
            raise MXNetError("%s: expected %d arrays (%s), got %d"
                             % (what, len(names), names, len(arrays)))
        return arrays

    def _req_dict(self, grad_req):
        if isinstance(grad_req, str):
            return {n: grad_req for n in self._arg_names}
        if isinstance(grad_req, (list, tuple)):
            return dict(zip(self._arg_names, grad_req))
        out = {n: "null" for n in self._arg_names}
        out.update(grad_req or {})
        return out

    def _grad_list(self, args_grad):
        if args_grad is None:
            return [None] * len(self._arg_names)
        if isinstance(args_grad, dict):
            return [args_grad.get(n) for n in self._arg_names]
        grads = list(args_grad)
        if len(grads) != len(self._arg_names):
            raise MXNetError("args_grad length mismatch")
        return grads

    # -- dict views --------------------------------------------------------
    @property
    def arg_dict(self):
        return dict(zip(self._arg_names, self.arg_arrays))

    @property
    def grad_dict(self):
        return dict(zip(self._arg_names, self.grad_arrays))

    @property
    def aux_dict(self):
        return dict(zip(self._aux_names, self.aux_arrays))

    @property
    def output_dict(self):
        return dict(zip(self._output_names, self.outputs))

    # -- execution ---------------------------------------------------------
    def _feed(self, name, val):
        """Write ``val`` into argument ``name``: in place where the shape
        and dtype match (the bound storage stays), else the argument is
        rebound to a new array on the executor's device."""
        if name not in self._arg_names:
            raise MXNetError("unknown argument '%s'" % name)
        i = self._arg_names.index(name)
        dst = self.arg_arrays[i]
        src = val if isinstance(val, NDArray) else array(val, ctx=self._ctx)
        if dst is None or dst.shape != src.shape \
                or dst._data.dtype != src._data.dtype:
            self.arg_arrays[i] = array(src, ctx=self._ctx)
        elif src._data.data_ptr() != dst._data.data_ptr():
            dst._data.copy_(src._data)

    def forward(self, is_train=False, **kwargs):
        """Run the graph (reference: executor.py forward); keyword NDArrays
        or array-likes are fed to the named arguments first. Returns
        `outputs`."""
        self._graph = None
        for name, val in kwargs.items():
            self._feed(name, val)
        values, leaves = {}, {}
        with torch.set_grad_enabled(bool(is_train)):
            for i, (name, arr) in enumerate(zip(self._arg_names,
                                                self.arg_arrays)):
                t = arr._data
                if is_train and self.grad_req.get(name, "null") != "null":
                    t = t.detach().requires_grad_(True)
                    leaves[i] = t
                values[name] = t
            values.update((n, a._data) for n, a in zip(self._aux_names,
                                                       self.aux_arrays))
            outs = self._symbol._interpret(
                values, is_train=bool(is_train),
                generator=_random.generator(self._ctx))
        self.outputs = [NDArray(o.detach().contiguous()) for o in outs]
        if leaves and any(o.requires_grad for o in outs):
            self._graph = (outs, leaves)
        if self._monitor_callback is not None:
            for name, o in zip(self._output_names, self.outputs):
                self._monitor_callback(name, o)
        return self.outputs

    def drop_graph(self):
        """Release the graph a training forward kept for `backward`."""
        self._graph = None

    def backward(self, out_grads=None, is_train=True):
        """Gradients of the last training forward into `grad_arrays`
        (reference: GraphExecutor::Backward graph_executor.cc:78), then the
        graph is released. ``out_grads`` are the head gradients (ones for an
        output given none; loss heads ignore theirs)."""
        wrt = [i for i, n in enumerate(self._arg_names)
               if self.grad_req.get(n, "null") != "null"]
        if not wrt:
            return
        if self._graph is None:
            raise MXNetError("backward called before forward(is_train=True)")
        outs, leaves = self._graph
        self._graph = None
        if out_grads is None:
            cots = [None] * len(outs)
        else:
            if isinstance(out_grads, NDArray):
                out_grads = [out_grads]
            cots = [(g if isinstance(g, NDArray) else array(g, ctx=self._ctx))
                    ._data for g in out_grads]
        heads, seeds = [], []
        for o, c in zip(outs, cots):
            if o.requires_grad:
                heads.append(o)
                seeds.append(torch.ones_like(o) if c is None else c)
        order = sorted(leaves)
        grads = torch.autograd.grad(heads, [leaves[i] for i in order],
                                    seeds, allow_unused=True)
        for i, g in zip(order, grads):
            dst = self.grad_arrays[i]
            if g is None:
                g = torch.zeros_like(leaves[i])
            if dst is None:
                self.grad_arrays[i] = NDArray(g.contiguous())
            elif self.grad_req[self._arg_names[i]] == "add":
                dst._data.add_(g)
            else:
                dst._data.copy_(g)

    # -- misc API parity ---------------------------------------------------
    def set_monitor_callback(self, callback, monitor_all=False):
        self._monitor_callback = callback

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """Copy values into the bound arrays by name (reference:
        executor.py copy_params_from)."""
        for names, arrays, params, what in (
                (self._arg_names, self.arg_arrays, arg_params, "parameter"),
                (self._aux_names, self.aux_arrays, aux_params, "aux state")):
            for name, arr in (params or {}).items():
                if name in names:
                    dst = arrays[names.index(name)]
                    if dst is not arr:
                        dst._set_data(arr._data if isinstance(arr, NDArray)
                                      else array(arr, ctx=self._ctx)._data)
                elif not allow_extra_params:
                    raise MXNetError("unknown %s '%s'" % (what, name))

    def reshape(self, partial_shaping=False, allow_up_sizing=False, **kwargs):
        """A new executor with the arguments in ``kwargs`` re-allocated at
        their new shapes; every other array (parameters, gradients, aux
        states) is shared with this one."""
        new_args = {n: (NDArray(torch.zeros(kwargs[n], device=self._ctx))
                        if n in kwargs else a)
                    for n, a in zip(self._arg_names, self.arg_arrays)}
        return Executor(self._symbol, self._ctx, new_args,
                        {n: g for n, g in zip(self._arg_names,
                                              self.grad_arrays)
                         if g is not None} or None,
                        dict(self.grad_req), list(self.aux_arrays))

    @property
    def symbol(self):
        return self._symbol

    def debug_str(self):
        return self._symbol.debug_str()
