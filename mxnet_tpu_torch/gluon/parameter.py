"""Gluon Parameter and ParameterDict (counterpart of
`mxnet_tpu/gluon/parameter.py`; reference: python/mxnet/gluon/parameter.py).

A `Parameter` keeps one copy a context (`Context`), in the order given to
`initialize` (or `reset_ctx`); copies on two host contexts (``cpu(0)``,
``cpu(1)``) are two tensors. The first copy is the one the modules that
use it hold (`Block`s, and layers that are `torch.nn.Module`s), registered
under their attribute name, so ``state_dict``, ``named_parameters`` and
the tensor-in, tensor-out calls see it; when the Parameter makes a new
first copy (a deferred shape becomes known, `cast`, `reset_ctx`,
`initialize` on another device) it rebinds every such module. A façade
call of a Block on an array of another context holds that context's
copies in the modules for the call (`_use_context`), so the copy takes
the gradient of the batch it computed.

- Shapes may hold 0s, filled at the first forward (deferred
  initialisation, `DeferredInitializationError` until then).
- ``grad_req`` (write, add or null) and each copy's gradient buffer are
  the autograd variable's (`mxnet_tpu_torch.autograd.mark_variables`).
- `initialize` draws from an explicit CPU `torch.Generator` into the first
  copy, and the other copies are copies of it. With no ``ctx`` the tensor
  stays on the device it was made on when its module was given one, and
  goes to `context.current_context` (the card by default) otherwise.
- ``stype`` and ``grad_stype`` are recorded as the JAX package records
  them; the data and the tape's gradient stay dense. A ``grad_stype`` of
  row_sparse makes `gluon.Trainer` cast the gradient to row_sparse for an
  optimizer with ``supports_sparse`` (the lazy update).
"""
from __future__ import annotations

import contextlib
import threading
import weakref
from collections import OrderedDict

import numpy as _np
import torch

from .. import autograd
from .. import initializer
from .. import ndarray as nd
from ..base import MXNetError, np_dtype, torch_dtype
from ..context import (_innermost, _unchecked_device, as_context, cpu,
                       current_context, resolve_device)
from ..ndarray import NDArray

__all__ = ["DeferredInitializationError", "Parameter", "Constant",
           "ParameterDict"]

# the live parameters that hold more than one copy: a façade call looks
# for copies to hold only while one exists
_MULTI = weakref.WeakSet()


class DeferredInitializationError(MXNetError):
    """A parameter was used before its shape was known (reference:
    parameter.py:38)."""


def _ctx_list(ctx):
    """None, a context or a list of them as a list of `Context`s (None
    stays None)."""
    if ctx is None:
        return None
    ctxs = [as_context(c) for c in ctx] if isinstance(ctx, (list, tuple)) \
        else [as_context(ctx)]
    if not ctxs:
        raise MXNetError("an empty list of contexts")
    # a context named twice holds one copy, as in the JAX package
    return list(OrderedDict.fromkeys(ctxs))


@contextlib.contextmanager
def _use_context(params, ctx):
    """Hold ``ctx``'s copy of each of ``params`` in its modules for the
    block, and make it the copy `Parameter.data` and `Parameter.var`
    give; a parameter whose deferred shape becomes known inside the block
    joins it."""
    held = []
    stack = _using_stack()
    stack.append((ctx, held))
    try:
        for p in params:
            p._hold(ctx, held)
        yield
    finally:
        stack.pop()
        for p in held:
            p._hold(None, None)


_using = threading.local()


def _using_stack():
    """The calling thread's `_use_context` blocks under way, each (context,
    the parameters it holds)."""
    if not hasattr(_using, "stack"):
        _using.stack = []
    return _using.stack


class Parameter:
    """A trainable parameter (reference: parameter.py:43)."""

    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        for st in (stype, grad_stype):
            if st not in ("default", "row_sparse", "csr"):
                raise MXNetError("Parameter %s: unknown stype %r"
                                 % (name, st))
        self.name = name
        self._stype = stype
        self._grad_stype = grad_stype
        self._differentiable = differentiable
        self._grad_req = grad_req if differentiable else "null"
        if isinstance(shape, int):
            shape = (shape,)
        self._shape = tuple(shape) if shape is not None else None
        self.dtype = np_dtype(dtype)
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self._nd = None            # NDArray over the first copy's tensor
        self._copies = None        # OrderedDict Context -> NDArray
        self._active = None        # the context whose copy the modules hold
        self._owners = []          # (weakref to module, attribute, kind)
        self._placed = False       # the tensor's device was chosen
        self._initialized = False
        self._deferred_init = ()   # (init, contexts, generator)

    def __repr__(self):
        return "Parameter %s (shape=%s, dtype=%s)" % (self.name, self._shape,
                                                      self.dtype)

    # -- shape ------------------------------------------------------------
    @property
    def shape(self):
        return self._shape

    @shape.setter
    def shape(self, new_shape):
        new_shape = tuple(new_shape)
        if self._shape is None:
            self._shape = new_shape
            return
        # 0 is the unknown dim on either side (reference: parameter.py)
        if len(self._shape) != len(new_shape) or not all(
                s == 0 or n == 0 or s == n
                for s, n in zip(self._shape, new_shape)):
            raise MXNetError("cannot update shape %s -> %s for %s"
                             % (self._shape, new_shape, self.name))
        self._shape = tuple(s if n == 0 else n
                            for s, n in zip(self._shape, new_shape))

    def _shape_known(self):
        return self._shape is not None and all(s > 0 for s in self._shape)

    @property
    def grad_stype(self):
        return self._grad_stype

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise MXNetError("grad_req must be write, add or null")
        if not self._differentiable:
            req = "null"
        if req == self._grad_req:
            return
        self._grad_req = req
        if self._nd is not None:   # new, zero gradient buffers
            for arr in self._copies.values():
                arr._grad = None
            self._set_tensor(self._nd._data)
            self._mark_copies()

    # -- the tensors ------------------------------------------------------
    @property
    def var(self):
        """The tensor the modules hold (None until it exists): the first
        copy's, or the held context's inside a façade call. A buffer is
        read back from its module, which may have replaced it
        (``module.to(...)``)."""
        if self._nd is None:
            return None
        if self._active is not None:
            return self._copies[self._active]._data
        for ref, attr, kind in self._owners:
            module = ref()
            if kind == "buffer" and module is not None:
                t = module._buffers.get(attr)
                if t is not None and t is not self._nd._data:
                    self._nd._data = t
                break
        return self._nd._data

    def _bind(self, module, attr, kind="parameter", device=None):
        """Register ``module.<attr>`` as a user of this parameter, as a
        torch parameter or (``kind="buffer"``) a buffer. A parameter whose
        shape is known gets its tensor now, zeros on ``device`` (the CPU
        when None, until `initialize` places it)."""
        self._owners.append((weakref.ref(module), attr, kind))
        if self._nd is None and self._shape_known():
            self._placed = device is not None
            # a "ones" parameter (gamma, running_var) starts at 1, as the
            # tensor path's modules always had it; the rest at 0
            fill = torch.ones if self.init in ("ones", "one") \
                or isinstance(self.init, initializer.One) else torch.zeros
            self._set_tensor(fill(
                self._shape, dtype=torch_dtype(self.dtype),
                device=resolve_device(device) if device is not None
                else None), as_context(device))
        else:
            self._rebind(module, attr, kind)

    def _rebind(self, module, attr, kind, t=None):
        if t is None:
            t = None if self._nd is None else self._nd._data
        if kind == "buffer":
            module._buffers[attr] = t
        elif kind == "parameter":
            module._parameters[attr] = t

    def _trainable(self):
        return self._grad_req != "null" \
            and not any(k == "buffer" for _, _, k in self._owners)

    def _leaf(self, t):
        """``t``'s values as a tensor of this parameter: a leaf that
        requires grad unless ``grad_req`` is null, a plain tensor for a
        buffer."""
        t = t.detach()
        if self._trainable():
            return torch.nn.Parameter(t, requires_grad=True)
        buffer = any(k == "buffer" for _, _, k in self._owners)
        return t if buffer else torch.nn.Parameter(t, requires_grad=False)

    def _mark(self, arr):
        """Make ``arr`` (a copy) a variable by ``grad_req``."""
        if self._trainable():
            # the gradient buffer is made at the first backward or grad()
            # (a module trained on the tensor path never needs one)
            grad = arr._grad
            t = arr._data
            if grad is not None and (grad.shape != tuple(t.shape)
                                     or grad._data.dtype != t.dtype
                                     or grad._data.device != t.device):
                grad = None
            autograd.mark_variables([arr], [grad], self._grad_req)
        else:
            arr._grad, arr._grad_req = None, "null"

    def _set_tensor(self, t, ctx=None):
        """Make ``t``'s values the first copy's tensor (on context ``ctx``
        when given) and rebind every module."""
        var = self._leaf(t)
        if self._nd is None:
            self._nd = NDArray(var, ctx)
            self._nd._pinned = True
            # (a tensor on the meta device, made for its shape only, has
            # no context)
            key = self._nd.context if var.device.type in ("cpu", "cuda") \
                else None
            self._copies = OrderedDict([(key, self._nd)])
        else:
            self._nd._data = var
            if ctx is not None:
                self._nd._ctx = ctx
        self._mark(self._nd)
        for ref, attr, kind in self._owners:
            if ref() is not None:
                self._rebind(ref(), attr, kind)

    def _set_copies(self, ctxs):
        """One copy a context of ``ctxs``: the first copy placed on
        ``ctxs[0]`` (see `_set_tensor`), each other one a copy of its
        values, a variable of its own."""
        self._nd._ctx = ctxs[0]
        copies = OrderedDict([(ctxs[0], self._nd)])
        for c in ctxs[1:]:
            arr = NDArray(self._leaf(self._nd._data.detach().to(
                resolve_device(c), copy=True)), c)
            arr._pinned = True
            self._mark(arr)
            copies[c] = arr
        self._copies = copies
        if len(copies) > 1:
            _MULTI.add(self)
        else:
            _MULTI.discard(self)
        for ctx, held in _using_stack()[-1:]:
            # made inside a façade call on another context's batch
            self._hold(ctx, held)

    def _mark_copies(self):
        for arr in list(self._copies.values())[1:]:
            arr._data = self._leaf(arr._data)
            self._mark(arr)

    def _hold(self, ctx, held):
        """Hold ``ctx``'s copy in the modules (None: the first copy
        again); ``held`` collects the parameters to give back."""
        if ctx is None:
            self._active = None
            for ref, attr, kind in self._owners:
                if ref() is not None:
                    self._rebind(ref(), attr, kind)
            return
        if self._copies is None or len(self._copies) < 2:
            return
        arr = self._copies.get(ctx)
        if arr is None:
            raise MXNetError("Parameter %s not initialized on context %s "
                             "(has %s)" % (self.name, ctx,
                                           list(self._copies)))
        if arr is self._nd:
            return
        self._active = ctx
        held.append(self)
        for ref, attr, kind in self._owners:
            if ref() is not None:
                self._rebind(ref(), attr, kind, arr._data)

    # -- init -------------------------------------------------------------
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False, generator=None):
        """Fill the parameter (reference: parameter.py Parameter.initialize):
        with ``init``, else its own initializer, else ``default_init``, else
        `initializer.Uniform`, one copy a context of ``ctx`` (a context or
        a list). An unknown shape defers to the first forward when
        ``allow_deferred_init``."""
        if self._initialized and not force_reinit:
            return
        ctxs = _ctx_list(ctx)
        if init is None:
            init = self.init if self.init is not None \
                else (default_init if default_init is not None
                      else initializer.Uniform())
        if not self._shape_known():
            if self.allow_deferred_init:
                self._deferred_init = (init, ctxs, generator)
                return
            raise MXNetError("cannot initialize %s: shape %s unknown; set "
                             "allow_deferred_init or give the full shape"
                             % (self.name, self._shape))
        self._init_impl(init, ctxs, generator)

    def _contexts(self, ctxs):
        if ctxs is not None:
            return ctxs
        if self._nd is not None and self._placed:
            return list(self._copies)
        return [current_context()]

    def _init_impl(self, init, ctxs, generator):
        ctxs = self._contexts(ctxs)
        dev = resolve_device(ctxs[0])
        t = self.var
        if t is None or tuple(t.shape) != self._shape or t.device != dev \
                or t.dtype != torch_dtype(self.dtype):
            self._set_tensor(torch.zeros(self._shape,
                                         dtype=torch_dtype(self.dtype),
                                         device=dev))
        self._placed = True
        initializer.create(init)(initializer.InitDesc(self.name),
                                 self._nd._data, generator)
        self._set_copies(ctxs)
        self._deferred_init = ()
        self._initialized = True

    def _finish_deferred_init(self):
        """Initialize a deferred parameter once its shape is known."""
        if not self._deferred_init:
            return
        if not self._shape_known():
            raise DeferredInitializationError(
                "Parameter %s has unknown shape %s" % (self.name,
                                                       self._shape))
        init, ctxs, generator = self._deferred_init
        self._init_impl(init, ctxs, generator)

    # -- access -----------------------------------------------------------
    def _check(self):
        if self._nd is None:
            if self._deferred_init:
                raise DeferredInitializationError(
                    "Parameter %s has not been initialized yet: its shape "
                    "is known at the first forward" % self.name)
            raise MXNetError("Parameter %s has not been initialized. Call "
                             ".initialize() first" % self.name)

    def _copy(self, ctx):
        """The copy on ``ctx``; None: the held context's, else the
        innermost ``with ctx:`` block's if it has one, else the first."""
        self._check()
        if ctx is None:
            if self._active is not None:
                return self._copies[self._active]
            if len(self._copies) > 1:
                inner = _innermost()
                arr = self._copies.get(as_context(inner)) \
                    if inner is not None else None
                if arr is not None:
                    return arr
            return self._nd
        want = as_context(ctx)
        arr = self._copies.get(want)
        if arr is not None:
            return arr
        if len(self._copies) == 1 \
                and _unchecked_device(want) == self._nd._data.device:
            return self._nd   # one copy: any context of its device
        raise MXNetError("Parameter %s not initialized on context %s (has "
                         "%s)" % (self.name, want, list(self._copies)))

    def data(self, ctx=None):
        """The parameter's NDArray on ``ctx`` (the same object every
        call)."""
        return self._copy(ctx)

    def list_data(self):
        self._check()
        return list(self._copies.values())

    def grad(self, ctx=None):
        arr = self._copy(ctx)
        if self._grad_req == "null" or not arr._data.requires_grad:
            raise MXNetError("Parameter %s has grad_req='null'" % self.name)
        if arr._grad is None:
            arr._grad = autograd._zeros_like(arr._data)
            arr._grad._ctx = arr._ctx
        return arr._grad

    def list_grad(self):
        if self._nd is None or not self.var.requires_grad:
            return []
        return [self.grad(c) for c in self._copies]

    def row_sparse_data(self, row_id):
        raise MXNetError("Parameter %s: row_sparse_data needs a row_sparse "
                         "weight held by a kvstore; the weight is dense here "
                         "(only its gradient is row_sparse, grad_stype)"
                         % self.name)

    def list_ctx(self):
        if self._nd is None:
            if self._deferred_init:
                return self._contexts(self._deferred_init[1])
            return []
        return list(self._copies)

    def zero_grad(self):
        for g in self.list_grad():
            g._data.zero_()

    def set_data(self, data):
        """Write ``data`` (an NDArray, tensor or array) into every copy,
        off the tape; a deferred parameter takes its shape from it."""
        src = data._data if isinstance(data, NDArray) \
            else torch.from_numpy(_np.array(data)) \
            if not torch.is_tensor(data) else data
        self.shape = tuple(src.shape)
        if self._nd is None or tuple(self.var.shape) != self._shape:
            init, ctxs, generator = self._deferred_init or (None, None, None)
            self._init_impl(initializer.Zero(), ctxs, generator)
        with torch.no_grad():
            for arr in self._copies.values():
                arr._data.copy_(src)
        self._initialized = True

    def reset_ctx(self, ctx):
        """Move the parameter to ``ctx`` (a context or a list): one copy a
        context, each the first copy's values, with new gradient
        buffers."""
        ctxs = _ctx_list(ctx)
        if self._nd is not None:
            self._placed = True
            for arr in self._copies.values():
                arr._grad = None
            self._set_tensor(self.var.to(resolve_device(ctxs[0])))
            self._set_copies(ctxs)
        elif self._deferred_init:
            init, _, generator = self._deferred_init
            self._deferred_init = (init, ctxs, generator)

    def cast(self, dtype):
        """Cast every copy and its gradient buffer to ``dtype``."""
        self.dtype = np_dtype(dtype)
        if self._nd is not None:
            ctxs = list(self._copies)
            self._set_tensor(self.var.to(torch_dtype(dtype)))
            self._set_copies(ctxs)

    def _reduce(self):
        """A host copy (what `save` writes): the copies' mean, as the JAX
        package's ``save`` takes it (one copy: that copy)."""
        arrays = self.list_data()
        if len(arrays) == 1:
            return arrays[0].copyto(cpu())
        return sum(a.copyto(cpu()) for a in arrays) / len(arrays)


class Constant(Parameter):
    """A parameter that holds ``value`` and takes no gradient (reference:
    parameter.py Constant)."""

    def __init__(self, name, value):
        if not isinstance(value, NDArray):
            value = nd.array(value, ctx=cpu())
        self.value = value
        super().__init__(name, grad_req="null", shape=value.shape,
                         dtype=value.dtype,
                         init=initializer.Constant(value.asnumpy()),
                         differentiable=False)


class ParameterDict:
    """Parameters by name, with a prefix and sharing (reference:
    parameter.py:508)."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = OrderedDict()
        self._shared = shared

    @property
    def prefix(self):
        return self._prefix

    def __repr__(self):
        return "ParameterDict(%s)" % ", ".join(str(p) for p in
                                               self._params.values())

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def __getitem__(self, key):
        return self._params[key]

    def __contains__(self, key):
        return key in self._params

    def get(self, name, **kwargs):
        """The parameter ``prefix + name``, made with ``kwargs`` when it does
        not exist yet (here or in the shared dict)."""
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            param = Parameter(name, **kwargs)
            self._params[name] = param
        elif kwargs.get("shape") is not None:
            shape = kwargs["shape"]
            param.shape = (shape,) if isinstance(shape, int) else shape
        return param

    def get_constant(self, name, value=None):
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            if value is None:
                raise MXNetError("no constant %s and no value given" % name)
            param = Constant(name, value)
            self._params[name] = param
        return param

    def _get_impl(self, name):
        if name in self._params:
            return self._params[name]
        if self._shared is not None and name in self._shared._params:
            self._params[name] = self._shared._params[name]
            return self._params[name]
        return None

    def update(self, other):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise MXNetError("duplicate parameter name %s" % k)
            self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False, generator=None):
        """Initialize every parameter, ``init`` being the default for those
        without an initializer of their own."""
        for p in self._params.values():
            p.initialize(None, ctx, default_init=init,
                         force_reinit=force_reinit, generator=generator)

    def zero_grad(self):
        for p in self._params.values():
            p.zero_grad()

    def reset_ctx(self, ctx):
        for p in self._params.values():
            p.reset_ctx(ctx)

    def setattr(self, name, value):
        for p in self._params.values():
            setattr(p, name, value)

    def save(self, filename, strip_prefix=""):
        """Save every parameter by its full name (``strip_prefix`` taken
        off) in the `nd.save` container."""
        args = {}
        for p in self._params.values():
            name = p.name
            if strip_prefix and name.startswith(strip_prefix):
                name = name[len(strip_prefix):]
            args[name] = p._reduce()
        nd.save(filename, args)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        """Load a file of `save` (or of the JAX package's): ``arg:`` /
        ``aux:`` prefixes are dropped and ``restore_prefix`` added."""
        loaded = nd.load(filename, ctx=cpu())
        loaded = {(k.split(":", 1)[1] if k.startswith(("arg:", "aux:"))
                   else k): v for k, v in loaded.items()}
        if restore_prefix:
            loaded = {restore_prefix + k: v for k, v in loaded.items()}
        if not allow_missing:
            for name in self.keys():
                if name not in loaded:
                    raise MXNetError("Parameter %s missing in file %s"
                                     % (name, filename))
        for name, val in loaded.items():
            if name not in self._params:
                if not ignore_extra:
                    raise MXNetError("Parameter %s in file %s is not in "
                                     "the ParameterDict" % (name, filename))
                continue
            p = self._params[name]
            if ctx is not None and p._nd is None:
                p.initialize(ctx=ctx)
            p.set_data(val)
