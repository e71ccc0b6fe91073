"""Gluon Block and HybridBlock (counterpart of `mxnet_tpu/gluon/block.py`;
reference: python/mxnet/gluon/block.py).

A `Block` is a `torch.nn.Module` with Gluon's naming (prefixes from
per-thread counters and `name_scope`), its `Parameter`s
(`collect_params`, `initialize`, `save_parameters` / `load_parameters`
by structural name in the `nd.save` container, so a ``.params`` file moves
between this package and the JAX package both ways), `cast` and
`summary`. Called with NDArrays (a façade call) a Block runs under
`autograd`'s scope: grad mode on only while recording, and Dropout and
BatchNorm in training mode only while `autograd.is_training`. Called with
tensors it is a plain `torch.nn.Module` (the tensor-in, tensor-out calls
of the trainers and serving).

The port's layers compute on tensors (``_tensor_forward``): a façade call
unwraps the NDArrays, runs the module, and wraps what comes out. Such a
call of a layer with no child Block is one "imperative" `profiler` event
named by its class (``Dense``, ``Conv2D``), its backward one
``_backward_<class>`` event: the layer is the op here, where the JAX
package records the ops inside it. A user's
`Block` writes ``forward`` on NDArrays, and a user's `HybridBlock` writes
``hybrid_forward(F, x, *args, **params)`` with ``F`` the port's `nd` and
each Parameter passed by attribute name as its NDArray.

Called with `Symbol`s, a `HybridBlock` composes a graph instead: it runs
``hybrid_forward`` with ``F`` the port's `sym` and each Parameter as a
variable of its full name, and each ported layer gives its symbol form
(the JAX package's ops and attributes). `HybridBlock.export` writes that
graph as ``prefix-symbol.json`` and the parameters as ``arg:`` / ``aux:``
entries of ``prefix-NNNN.params``, which `SymbolBlock.imports`, the
`Predictor` and the serving repository of either package load. A block
without a symbol form (a plain `Block`, LayerNorm, GELU, the recurrent
layers) raises there, naming itself.

`HybridBlock.hybridize` takes the JAX package's arguments and records
them, and the forward stays eager: the captured graph (CUDA graphs or
torch.compile per input signature) is ROADMAP queue 1 item 2.
"""
from __future__ import annotations

import re
import threading
import weakref

import numpy as _np
import torch

from .. import autograd
from .. import ndarray as nd
from .. import profiler as _profiler
from ..base import MXNetError
from ..context import cpu
from ..ndarray import NDArray
from ..symbol import Symbol
from . import parameter as _param_mod
from .parameter import DeferredInitializationError, Parameter, ParameterDict

__all__ = ["Block", "HybridBlock", "SymbolBlock"]

_naming = threading.local()


def _name_counter():
    if not hasattr(_naming, "counts"):
        _naming.counts = {}
    return _naming.counts


class _BlockScope:
    """Name and prefix manager (reference: block.py:33 _BlockScope)."""

    _current = threading.local()

    def __init__(self, block):
        # weak: a strong one would put every block in a reference cycle,
        # freed only by the garbage collector (a model's card memory too)
        self._block_ref = weakref.ref(block)
        self._counter = {}
        self._old_scope = None

    @property
    def _block(self):
        return self._block_ref()

    def __getstate__(self):
        # a weakref does not pickle: the block rebinds it when unpickled
        # (`Block.__setstate__`), so a dataset's transforms reach a
        # DataLoader worker process
        d = dict(self.__dict__)
        d["_block_ref"] = None
        return d

    @staticmethod
    def create(prefix, params, hint):
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                counts = _name_counter()
                count = counts.get(hint, 0)
                counts[hint] = count + 1
                prefix = "%s%d_" % (hint, count)
            if params is None:
                params = ParameterDict(prefix)
            else:
                params = ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            count = current._counter.get(hint, 0)
            current._counter[hint] = count + 1
            prefix = "%s%d_" % (hint, count)
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        if self._block._empty_prefix:
            return self
        self._old_scope = getattr(_BlockScope._current, "value", None)
        _BlockScope._current.value = self
        return self

    def __exit__(self, *args):
        if self._block._empty_prefix:
            return
        _BlockScope._current.value = self._old_scope


def _has_nd(args, kwargs):
    for a in args:
        if isinstance(a, NDArray) or (isinstance(a, (list, tuple)) and any(
                isinstance(b, NDArray) for b in a)):
            return True
    return any(isinstance(v, NDArray) for v in kwargs.values())


def _has_sym(args, kwargs):
    return any(isinstance(a, Symbol) for a in list(args) + list(
        kwargs.values()))


def _first_nd(args, kwargs):
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, NDArray):
            return a
        if isinstance(a, (list, tuple)):
            for b in a:
                if isinstance(b, NDArray):
                    return b
    return None


def _tag(out, ctx):
    """``out``'s arrays placed on ``ctx`` (the arrays a façade call made
    from an input on that context)."""
    if isinstance(out, NDArray):
        if out._ctx is None:
            out._ctx = ctx
    elif isinstance(out, (list, tuple)):
        for o in out:
            _tag(o, ctx)
    return out


def _unwrap(x):
    if isinstance(x, NDArray):
        return x._data
    if isinstance(x, (list, tuple)):
        return type(x)(_unwrap(a) for a in x)
    return x


def _wrap(x):
    if torch.is_tensor(x):
        return NDArray(x if x.is_contiguous() else x.contiguous())
    if isinstance(x, (list, tuple)):
        return type(x)(_wrap(a) for a in x)
    return x


class Block(torch.nn.Module):
    """Base building block (reference: block.py:127)."""

    # True for the port's layers, whose forward computes on tensors
    _tensor_forward = False

    def __init__(self, prefix=None, params=None):
        super().__init__()
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(prefix, params,
                                                        self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._reg_params = {}

    def __setstate__(self, state):
        super().__setstate__(state)
        self._scope._block_ref = weakref.ref(self)

    def _alias(self):
        return self.__class__.__name__.lower()

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    @property
    def params(self):
        return self._params

    def name_scope(self):
        return self._scope

    def __getattr__(self, name):
        # a parameter registered by `_param` is the gluon Parameter here,
        # as in the JAX package (``dense.weight.lr_mult = 0.1``); the
        # module holds its tensor (`_held`), which state_dict and
        # torch.func.functional_call see
        reg = self.__dict__.get("_reg_params")
        if reg is not None and name in reg:
            return reg[name]
        return super().__getattr__(name)

    def _held(self, name):
        """The tensor the module holds under ``name``, a parameter or a
        buffer (None while a deferred shape is unknown)."""
        if name in self._parameters:
            return self._parameters[name]
        return self._buffers.get(name)

    def __setattr__(self, name, value):
        if isinstance(value, Parameter):
            # the attribute is the Parameter; the module holds its tensor
            self.__dict__.setdefault("_reg_params", {})[name] = value
            object.__setattr__(self, name, value)
            value._bind(self, name, "parameter")
            return
        super().__setattr__(name, value)

    def _param(self, attr, kind="parameter", device=None, **kwargs):
        """A layer's parameter ``attr`` (made by ``self.params.get(attr,
        **kwargs)``), registered with the module under ``attr`` as a
        parameter or a buffer: the module's attribute is the Parameter, and
        `_held` its tensor."""
        if kind == "buffer":
            self.register_buffer(attr, None)
        else:
            self.register_parameter(attr, None)
        p = self.params.get(attr, **kwargs)
        self._reg_params[attr] = p
        p._bind(self, attr, kind, device=device)
        return p

    def register_child(self, block, name=None):
        self.add_module(str(len(self._modules)) if name is None else name,
                        block)

    @property
    def _children(self):
        return {k: v for k, v in self._modules.items()
                if isinstance(v, Block)}

    def collect_params(self, select=None):
        """Every Parameter of this block and its Block children, by full name
        (reference: block.py collect_params); ``select`` is a regular
        expression on the names."""
        ret = ParameterDict(self._params.prefix)
        if select is None:
            ret.update(self.params)
        else:
            pattern = re.compile(select)
            ret.update({n: p for n, p in self.params.items()
                        if pattern.match(n)})
        for child in self._children.values():
            ret.update(child.collect_params(select=select))
        return ret

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False, seed=None):
        """Initialize every parameter (see `Parameter.initialize`); random
        initializers draw from a CPU generator seeded with ``seed``, or from
        this thread's. Returns self."""
        gen = None if seed is None \
            else torch.Generator().manual_seed(int(seed))
        self.collect_params().initialize(init, ctx, verbose, force_reinit,
                                         generator=gen)
        return self

    def cast(self, dtype):
        for child in self._children.values():
            child.cast(dtype)
        for p in self._reg_params.values():
            p.cast(dtype)
        return self

    # -- persistence ------------------------------------------------------
    def _collect_params_with_prefix(self, prefix=""):
        if prefix:
            prefix += "."
        ret = {prefix + k: p for k, p in self._reg_params.items()}
        for name, child in self._children.items():
            ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def save_parameters(self, filename):
        """Save the parameters by structural name (``embedding.weight``,
        ``rnn.l0_i2h_weight``) in the `nd.save` container (reference:
        block.py:315)."""
        params = self._collect_params_with_prefix()
        nd.save(filename, {k: p._reduce() for k, p in params.items()})

    save_params = save_parameters

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False):
        """Load a file of `save_parameters` (either package's); a parameter
        not made yet takes the file's shape (reference: block.py:356)."""
        loaded = nd.load(filename, ctx=cpu())
        params = self._collect_params_with_prefix()
        if not allow_missing:
            for name in params:
                if name not in loaded:
                    raise MXNetError("Parameter %s missing in %s"
                                     % (name, filename))
        for name, val in loaded.items():
            if name not in params:
                if not ignore_extra:
                    raise MXNetError("Parameter %s in %s is not in the block"
                                     % (name, filename))
                continue
            p = params[name]
            if ctx is not None and p._nd is None:
                p.initialize(ctx=ctx)
            p.set_data(val)

    load_params = load_parameters

    # -- execution --------------------------------------------------------
    def __call__(self, *args, **kwargs):
        if _has_sym(args, kwargs):
            return self._symbol_forward(*args, **kwargs)
        if not _has_nd(args, kwargs):
            return super().__call__(*args, **kwargs)
        if _param_mod._MULTI and not autograd._st().facade:
            # parameters over several contexts: the call computes with the
            # copies of its input's context, and its outputs are there
            ctx = _first_nd(args, kwargs).context
            with _param_mod._use_context(
                    self.collect_params().values(), ctx):
                return _tag(self._facade_call(args, kwargs), ctx)
        return self._facade_call(args, kwargs)

    def _facade_call(self, args, kwargs):
        with autograd._facade():
            if self._tensor_forward:
                call = super().__call__
                args, kwargs = _unwrap(args), _unwrap(kwargs)
                if self._children:
                    return _wrap(call(*args, **kwargs))
                name = type(self).__name__
                out = _profiler.timed_call(
                    name, lambda: call(*args, **kwargs), ())
                if _profiler.backward_hooks_wanted():
                    _profiler.hook_backward(
                        name, out if isinstance(out, (tuple, list))
                        else (out,))
                return _wrap(out)
            return super().__call__(*args, **kwargs)

    def forward(self, *args):
        raise NotImplementedError

    def _symbol_forward(self, *args, **kwargs):
        raise MXNetError("%s has no symbol form: only a HybridBlock (and "
                         "the ported layers) composes a graph for export"
                         % type(self).__name__)

    def hybridize(self, active=True, **kwargs):
        for child in self._children.values():
            child.hybridize(active, **kwargs)

    def summary(self, *inputs):
        """Print each block with its own parameter count."""
        rows = []

        def walk(block, depth):
            n = sum(int(_np.prod(p.shape or ()))
                    for p in block._reg_params.values())
            rows.append(("  " * depth + block.__class__.__name__, n))
            for c in block._children.values():
                walk(c, depth + 1)

        walk(self, 0)
        lines = ["%-40s %12s" % ("Layer", "Params"), "-" * 53]
        lines += ["%-40s %12d" % r for r in rows]
        lines += ["-" * 53, "%-40s %12d" % ("Total (direct)",
                                            sum(n for _, n in rows))]
        print("\n".join(lines))  # allow-print


class HybridBlock(Block):
    """A Block written as ``hybrid_forward(F, x, ...)`` (reference:
    block.py:671)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._flags = {}

    def hybridize(self, active=True, static_alloc=False, static_shape=False,
                  **kwargs):
        """Records ``active`` and the flags (reference: block.py:832); the
        forward stays eager. Capturing it as a graph per input signature is
        ROADMAP queue 1 item 2."""
        self._active = active
        self._flags = dict(static_alloc=static_alloc,
                           static_shape=static_shape, **kwargs)
        super().hybridize(active, static_alloc=static_alloc,
                          static_shape=static_shape, **kwargs)

    def forward(self, *args, **kwargs):
        if not _has_nd(args, kwargs):
            # called with tensors (inside a tensor-path module, or by a
            # trainer): outside a façade call the NDArray calls inside
            # record while torch's grad mode is on, and train while the
            # module does
            if autograd._st().facade:
                return _unwrap(self.forward(*_wrap(args), **_wrap(kwargs)))
            with autograd._scope(recording=torch.is_grad_enabled(),
                                 training=self.training):
                return _unwrap(self.forward(*_wrap(args), **_wrap(kwargs)))
        params = {}
        for name, p in self._reg_params.items():
            if p._nd is None:
                p._finish_deferred_init()
            params[name] = p.data()
            held = self._held(name)
            if held is not None and held is not params[name]._data:
                # `torch.func.functional_call` put another tensor in the
                # module's place (a trainer's cast or expert rows)
                params[name] = NDArray(held)
        return self.hybrid_forward(nd, *args, **kwargs, **params)

    def _symbol_forward(self, *args, **kwargs):
        """``hybrid_forward`` with ``F`` the port's `sym` and each
        Parameter a variable of its full name."""
        from .. import symbol as sym_mod

        params = {name: sym_mod.var(p.name, shape=p.shape)
                  for name, p in self._reg_params.items()}
        return self.hybrid_forward(sym_mod, *args, **kwargs, **params)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError

    def export(self, path, epoch=0, n_inputs=1, input_names=None):
        """Write ``path-symbol.json`` (the graph of ``hybrid_forward`` on
        variable inputs, named ``data`` or ``data0``, ``data1``, ...) and
        ``path-%04d.params`` (every parameter under its full name,
        ``aux:`` for the graph's aux states, ``arg:`` otherwise), as the JAX
        package's export writes them (reference: block.py:868). The
        parameters must exist (a first forward makes deferred ones)."""
        from .. import symbol as sym_mod

        if input_names is None:
            input_names = ["data"] if n_inputs == 1 else \
                ["data%d" % i for i in range(n_inputs)]
        out = self(*[sym_mod.var(n) for n in input_names])
        if isinstance(out, (list, tuple)):
            out = sym_mod.Group(list(out))
        params = self.collect_params()
        aux_names = set(out.list_auxiliary_states())
        save_dict = {("aux:" if k in aux_names else "arg:") + k: p._reduce()
                     for k, p in params.items()}
        out.save("%s-symbol.json" % path)
        nd.save("%s-%04d.params" % (path, epoch), save_dict)


class SymbolBlock(HybridBlock):
    """A graph run as a Block (reference: block.py:952): every argument
    of ``outputs`` that is not an input, and every aux state, is a
    Parameter of its full name. Called with NDArrays (a façade call, so
    recorded under ``autograd.record``) or with tensors it interprets the
    graph, BatchNorm in training mode only while
    `autograd.is_training`."""

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix="", params=params)
        from .. import symbol as sym_mod

        if isinstance(outputs, (list, tuple)):
            outputs = sym_mod.Group(list(outputs))
        if isinstance(inputs, sym_mod.Symbol):
            inputs = list(inputs)
        self._sym_outputs = outputs
        self._input_names = [i.name for i in inputs]
        for name in outputs.list_arguments():
            if name not in self._input_names:
                self.params.get(name, allow_deferred_init=True)
        for name in outputs.list_auxiliary_states():
            if name not in self._input_names:
                self.params.get(name, grad_req="null",
                                allow_deferred_init=True)

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        """A SymbolBlock over ``symbol_file`` with ``input_names``, its
        parameters loaded from ``param_file`` onto ``ctx`` (either
        package's export; reference: block.py imports)."""
        from .. import symbol as sym_mod

        symbol = sym_mod.load(symbol_file)
        if isinstance(input_names, str):
            input_names = [input_names]
        ret = SymbolBlock(symbol, [sym_mod.var(n) for n in input_names])
        if param_file is not None:
            ret.collect_params().load(param_file, ctx=ctx)
        return ret

    def _symbol_forward(self, *args, **kwargs):
        raise MXNetError("SymbolBlock has no symbol form: export the block "
                         "it was imported from")

    def forward(self, *args):
        wrap = _has_nd(args, {})
        values = dict(zip(self._input_names, _unwrap(args)))
        values.update((n, p.var) for n, p in self.params.items())
        if any(v is None for v in values.values()):
            raise MXNetError("SymbolBlock: parameters %s are not loaded"
                             % [n for n, v in values.items() if v is None])
        from .. import random as _random

        dev = next(iter(values.values())).device
        outs = self._sym_outputs._interpret(
            values, is_train=autograd.is_training() if wrap
            else self.training, generator=_random.generator(dev),
            device=dev)
        outs = [_wrap(o) for o in outs] if wrap else list(outs)
        return outs[0] if len(outs) == 1 else outs


def _deferred(p):
    """Raise if ``p`` is deferred and never given an initializer."""
    if p._nd is None and not p._deferred_init:
        raise DeferredInitializationError(
            "Parameter %s has unknown shape %s and was not initialized; "
            "call initialize() before the first forward"
            % (p.name, p.shape))
