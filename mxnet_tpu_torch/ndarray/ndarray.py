"""NDArray: the imperative tensor.

Counterpart of `mxnet_tpu/ndarray/ndarray.py` (reference:
include/mxnet/ndarray.h:82 and python/mxnet/ndarray/ndarray.py). Design
mapping:

- Storage → a contiguous `torch.Tensor`. The array's context is the
  `Context` it was placed with (``ctx=``, `copyto`, `as_in_context`;
  an op's outputs take their first input's), else its tensor's device as
  a `Context`: ``cpu(1)`` runs on the host and stays ``cpu(1)``.
  PyTorch's caching allocator owns memory and its streams order the work.
- In-place mutation is real, as in the reference: ``+=``, ``x[k] = v``,
  `copyto`, ``out=`` and `_set_data` write into the tensor's storage
  (``copy_``), so a view (``x[1:3]``, ``x.reshape(...)``, `detach`) and a
  raw pointer handed to a kernel (`mxnet_tpu_torch.rtc`) see the write.
  The JAX package swaps immutable buffers instead.
- Basic indexing whose result is contiguous (first-axis ints and slices)
  and `reshape` give views, as the reference's ``_at`` / ``_slice`` /
  ``Reshape`` handles do; any other index copies. An op's output never
  shares storage with its inputs.
- ``WaitToRead`` (ndarray.h:359) → `wait_to_read` synchronises the
  array's current stream.
- Autograd (`attach_grad`, `backward`, `grad`) is torch's graph, run by
  `mxnet_tpu_torch.autograd`: ops, indexing and views run with grad mode
  on only inside ``autograd.record()``. A write to an array that is part
  of a graph (a recorded output, or a variable) rebinds it to a new tensor,
  as the JAX package's immutable buffers behave, so the graph keeps the
  value it saved; a gluon Parameter's array is the exception, written in
  place off the tape (the optimizer's update), since its module holds
  that tensor.

Every operator call goes through `invoke` — the equivalent of
``Imperative::Invoke`` (src/imperative/imperative.cc:89): resolve the
`OpDef`, run its torch function, wrap the outputs, honour ``out=``.

Sparse storage is `ndarray.sparse` (row_sparse and csr arrays, row-sparse
gradient buffers); an op without a sparse form densifies a sparse input,
as the reference's storage fallback does. Live accounting
(`telemetry.memory.ndarray_live`): the constructor counts a handle and
its tensor's bytes, ``__del__`` takes them off, and `_set_data` of a
value of another size (which swaps the buffer, as the JAX package's
does) moves the bytes; an array made while telemetry is off is never
counted. 64-bit arrays stay 64-bit, as in
the reference, where the JAX package narrows them to 32 bits (README,
"int64").
"""
from __future__ import annotations

import io
import weakref
import zipfile
import zlib

import numpy as _np
import torch

from .. import autograd as _autograd
from .. import engine as _engine
from .. import ops as _ops
from .. import profiler as _profiler
from .. import random as _random
from ..base import MXNetError, atomic_writer, np_dtype, numeric_types, \
    torch_dtype
from ..context import Context, _innermost, _unchecked_device, \
    as_context, resolve_device
from ..ops.tensor import mx_reshape_shape
from ..telemetry import memory as _tm_memory

__all__ = ["NDArray", "invoke", "array", "zeros", "ones", "full", "empty",
           "arange", "concat", "stack", "save", "load", "waitall",
           "from_dlpack", "to_dlpack_for_read", "to_dlpack_for_write"]


def _broadcasts(src, dst):
    """Whether a tensor of shape ``src`` broadcasts to shape ``dst``."""
    try:
        return tuple(torch.broadcast_shapes(src, dst)) == tuple(dst)
    except RuntimeError:
        return False


class NDArray:
    """Multi-dimensional array on a device (reference: ndarray.h:82)."""

    __slots__ = ("_data", "_grad", "_grad_req", "_fresh_grad", "_leaves",
                 "_pinned", "_ctx", "_live_bytes", "__weakref__")

    def __init__(self, data, ctx=None):
        self._data = data  # torch.Tensor, contiguous
        self._ctx = ctx         # the Context it was placed with, or None
        self._grad = None       # gradient buffer (an NDArray) of a variable
        self._grad_req = "null"
        self._fresh_grad = False  # written by a backward since the last step
        self._leaves = None     # weakrefs to tensors a write replaced
        self._pinned = False    # a gluon Parameter's: written in place
        # live accounting: handles made minus handles collected, in counts
        # and bytes (plain list adds: this is the hot path); an array made
        # while telemetry is off carries None, so a later switch never
        # takes the gauge below zero
        if _tm_memory.enabled():
            nb = int(getattr(data, "nbytes", 0) or 0)
            self._live_bytes = nb
            _tm_memory.ndarray_created(nb)
        else:
            self._live_bytes = None

    def __del__(self):
        # interpreter shutdown may have torn the module down: never raise
        try:
            if self._live_bytes is not None:
                _tm_memory.ndarray_freed(self._live_bytes)
        except Exception:
            pass

    def _write(self, fn):
        """Apply ``fn`` (an in-place write) to this array's value. An array
        outside any graph, or a Parameter's, is written in place (the latter
        off the tape); one in a graph is rebound to a written copy, so the
        graph keeps the value it saved, and a variable's new tensor is a
        leaf again."""
        t = self._data
        if not t.requires_grad:
            fn(t)
            return
        if self._pinned:
            with torch.no_grad():
                fn(t)
            return
        with torch.set_grad_enabled(_autograd.is_recording()
                                    and not t.is_leaf):
            new = t.detach().clone() if t.is_leaf else t.clone()
            fn(new)
        if t.is_leaf:
            new.requires_grad_(True)
            self._leaves = (self._leaves or []) + [weakref.ref(t)]
        self._data = new

    # -- core properties --------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return np_dtype(self._data.dtype)

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.ndim

    @property
    def context(self):
        """The `Context` this array was placed with, else its device's."""
        ctx = self._ctx
        if ctx is not None and _unchecked_device(ctx).type \
                == self._data.device.type:
            return ctx
        return Context(self._data.device)

    ctx = context

    @property
    def stype(self):
        return "default"

    @property
    def handle(self):  # the tensor is the handle
        return self._data

    def _set_data(self, value):
        """Write ``value`` (a tensor, broadcast to the shape) into this
        array (see `_write`). A tensor that does not broadcast to the
        shape replaces the buffer instead, as the JAX package's swap
        does; the live bytes follow."""
        if torch.is_tensor(value) and value.shape != self._data.shape and \
                not _broadcasts(value.shape, self._data.shape):
            self._data = value.contiguous()
            if self._live_bytes is not None:
                nb = int(self._data.nbytes)
                if nb != self._live_bytes:
                    _tm_memory.ndarray_resized(nb - self._live_bytes)
                    self._live_bytes = nb
            return
        self._write(lambda t: t.copy_(value))

    # -- sync / transfer --------------------------------------------------
    def wait_to_read(self):
        """Block until the array's value is ready; an asynchronous device
        error raises here (reference: NDArray::WaitToRead ndarray.h:359)."""
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()
        return self

    wait_to_write = wait_to_read

    def asnumpy(self):
        """A numpy copy; bfloat16 (which numpy lacks) comes back as the same
        values in float32."""
        t = self._data.detach()
        dt = torch.float32 if t.dtype == torch.bfloat16 else t.dtype
        return t.to("cpu", dt, copy=True).numpy()

    def asscalar(self):
        return self.asnumpy().reshape(()).item()

    def item(self):
        return self.asscalar()

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __bool__(self):
        if self.size == 1:
            return bool(self.asscalar())
        raise MXNetError("ambiguous truth value of multi-element NDArray")

    def __len__(self):
        return self.shape[0]

    def copyto(self, other):
        if isinstance(other, NDArray):
            other._set_data(self._data)
            return other
        if isinstance(other, (Context, torch.device, str)):
            with _autograd._grad_mode():
                return NDArray(self._data.to(resolve_device(other),
                                             copy=True), as_context(other))
        raise TypeError("copyto: expected NDArray or device")

    def as_in_context(self, ctx):
        """This array when it is on ``ctx``, else a copy there (two host
        contexts are two arrays, as in the JAX package)."""
        if as_context(ctx) == self.context:
            return self
        return self.copyto(ctx)

    as_in_ctx = as_in_context

    def copy(self):
        return self.copyto(self.context)

    def detach(self):
        """The same values, cut from the graph (shares the storage)."""
        return NDArray(self._data.detach(), self._ctx)

    def astype(self, dtype, copy=True):
        return invoke("Cast", (self,), {"dtype": str(np_dtype(dtype))})

    def to_dlpack_for_read(self):
        """DLPack capsule sharing this array's memory (reference:
        ndarray.py:2231 over 3rdparty/dlpack)."""
        return torch.utils.dlpack.to_dlpack(self._data)

    def to_dlpack_for_write(self):
        """As `to_dlpack_for_read`: the consumer's writes land in this
        array (the JAX package can only hand out a copy)."""
        return torch.utils.dlpack.to_dlpack(self._data)

    # -- autograd ---------------------------------------------------------
    def attach_grad(self, grad_req="write", stype=None):
        """Make this array a variable with a zero gradient buffer of its
        shape and dtype (reference: ndarray.py attach_grad); ``grad_req``
        is write, add or null. With ``stype="row_sparse"`` the buffer is
        row_sparse from the start, so an alias taken before `backward` sees
        the gradient, which the write-back casts to row_sparse."""
        if stype not in (None, "default", "row_sparse"):
            raise MXNetError("attach_grad: unsupported grad stype %r "
                             "(default/row_sparse)" % (stype,))
        if stype == "row_sparse":
            from . import sparse as _sparse

            buf = _sparse.zeros("row_sparse", self.shape, ctx=self.context,
                                dtype=self._data.dtype)
        else:
            buf = _autograd._zeros_like(self._data)
        _autograd.mark_variables([self], [buf], grad_req)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        """Gradients of this array into every variable's buffer; a
        non-scalar array's head gradient defaults to ones."""
        _autograd.backward([self], None if out_grad is None else [out_grad],
                           retain_graph=retain_graph, train_mode=train_mode)

    @property
    def grad(self):
        """The gradient buffer (None unless `attach_grad` was called)."""
        return self._grad

    # -- shape ops --------------------------------------------------------
    def reshape(self, *shape, **kwargs):
        """A view with the new shape (MXNet's magic codes apply)."""
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        with _autograd._grad_mode():
            return NDArray(self._data.view(mx_reshape_shape(
                self.shape, shape, kwargs.get("reverse", False))), self._ctx)

    def reshape_like(self, other):
        return self.reshape(other.shape)

    def transpose(self, axes=None):
        return invoke("transpose", (self,), {"axes": axes})

    @property
    def T(self):
        return self.transpose()

    def flatten(self):
        return invoke("Flatten", (self,), {})

    def expand_dims(self, axis):
        return invoke("expand_dims", (self,), {"axis": axis})

    def squeeze(self, axis=None):
        return invoke("squeeze", (self,), {"axis": axis})

    def swapaxes(self, dim1, dim2):
        return invoke("SwapAxis", (self,), {"dim1": dim1, "dim2": dim2})

    def split(self, num_outputs, axis=1, squeeze_axis=False):
        return invoke("SliceChannel", (self,), {"num_outputs": num_outputs,
                                                "axis": axis,
                                                "squeeze_axis": squeeze_axis})

    def slice(self, begin, end, step=None):
        return invoke("slice", (self,), {"begin": begin, "end": end,
                                         "step": step or ()})

    def slice_axis(self, axis, begin, end):
        return invoke("slice_axis", (self,), {"axis": axis, "begin": begin, "end": end})

    def broadcast_to(self, shape):
        return invoke("broadcast_to", (self,), {"shape": shape})

    def broadcast_like(self, other):
        return invoke("broadcast_like", (self, other), {})

    def tile(self, reps):
        return invoke("tile", (self,), {"reps": reps})

    def repeat(self, repeats, axis=None):
        return invoke("repeat", (self,), {"repeats": repeats, "axis": axis})

    def take(self, indices, axis=0, mode="clip"):
        return invoke("take", (self, indices), {"axis": axis, "mode": mode})

    def pick(self, index, axis=-1, keepdims=False):
        return invoke("batch_take", (self, index), {"axis": axis, "keepdims": keepdims})

    def one_hot(self, depth, **kw):
        return invoke("one_hot", (self,), dict(depth=depth, **kw))

    def tostype(self, stype):
        """This array in storage ``stype`` (default, row_sparse or csr;
        reference: ndarray.py tostype -> cast_storage)."""
        if stype == "default":
            return self
        from . import sparse as _sparse

        return _sparse.cast_storage(self, stype)

    # -- reductions -------------------------------------------------------
    def sum(self, axis=None, keepdims=False, **kw):
        return invoke("sum", (self,), {"axis": axis, "keepdims": keepdims})

    def mean(self, axis=None, keepdims=False, **kw):
        return invoke("mean", (self,), {"axis": axis, "keepdims": keepdims})

    def prod(self, axis=None, keepdims=False, **kw):
        return invoke("prod", (self,), {"axis": axis, "keepdims": keepdims})

    def max(self, axis=None, keepdims=False, **kw):
        return invoke("max", (self,), {"axis": axis, "keepdims": keepdims})

    def min(self, axis=None, keepdims=False, **kw):
        return invoke("min", (self,), {"axis": axis, "keepdims": keepdims})

    def norm(self, ord=2, axis=None, keepdims=False):
        return invoke("norm", (self,), {"ord": ord, "axis": axis, "keepdims": keepdims})

    def argmax(self, axis=None, keepdims=False):
        return invoke("argmax", (self,), {"axis": axis, "keepdims": keepdims})

    def argmin(self, axis=None, keepdims=False):
        return invoke("argmin", (self,), {"axis": axis, "keepdims": keepdims})

    def argsort(self, axis=-1, is_ascend=True):
        return invoke("argsort", (self,), {"axis": axis, "is_ascend": is_ascend})

    def topk(self, axis=-1, k=1, ret_typ="indices", is_ascend=False):
        return invoke("topk", (self,), {"axis": axis, "k": k, "ret_typ": ret_typ,
                                        "is_ascend": is_ascend})

    def clip(self, a_min, a_max):
        return invoke("clip", (self,), {"a_min": a_min, "a_max": a_max})

    def abs(self):
        return invoke("abs", (self,), {})

    def sqrt(self):
        return invoke("sqrt", (self,), {})

    def square(self):
        return invoke("square", (self,), {})

    def exp(self):
        return invoke("exp", (self,), {})

    def log(self):
        return invoke("log", (self,), {})

    def sigmoid(self):
        return invoke("sigmoid", (self,), {})

    def tanh(self):
        return invoke("tanh", (self,), {})

    def relu(self):
        return invoke("relu", (self,), {})

    def softmax(self, axis=-1):
        return invoke("softmax", (self,), {"axis": axis})

    def log_softmax(self, axis=-1):
        return invoke("log_softmax", (self,), {"axis": axis})

    def dot(self, other, transpose_a=False, transpose_b=False):
        return invoke("dot", (self, other), {"transpose_a": transpose_a,
                                             "transpose_b": transpose_b})

    def zeros_like(self):
        return invoke("zeros_like", (self,), {})

    def ones_like(self):
        return invoke("ones_like", (self,), {})

    def flip(self, axis):
        return invoke("reverse", (self,), {"axis": axis})

    def pad(self, mode="constant", pad_width=(), constant_value=0.0):
        return invoke("Pad", (self,), {"mode": mode, "pad_width": pad_width,
                                       "constant_value": constant_value})

    # -- arithmetic dunders ----------------------------------------------
    def _binary(self, other, op, scalar_op, reverse=False):
        if isinstance(other, NDArray):
            args = (other, self) if reverse else (self, other)
            return invoke(op, args, {})
        if isinstance(other, numeric_types):
            name = scalar_op
            if reverse and "_r" not in scalar_op:
                rname = scalar_op.replace("_scalar", "").replace("_", "", 1)
                name = "_r%s_scalar" % rname
                if name not in _ops._REGISTRY:
                    name = scalar_op  # commutative
            return invoke(name, (self,), {"scalar": float(other)})
        if isinstance(other, _np.ndarray):
            return self._binary(array(other, ctx=self.context), op,
                                scalar_op, reverse)
        return NotImplemented

    def __add__(self, o):
        return self._binary(o, "elemwise_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binary(o, "elemwise_sub", "_minus_scalar")

    def __rsub__(self, o):
        return self._binary(o, "elemwise_sub", "_rminus_scalar", reverse=True)

    def __mul__(self, o):
        return self._binary(o, "elemwise_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binary(o, "elemwise_div", "_div_scalar")

    def __rtruediv__(self, o):
        return self._binary(o, "elemwise_div", "_rdiv_scalar", reverse=True)

    def __mod__(self, o):
        return self._binary(o, "elemwise_mod", "_mod_scalar")

    def __rmod__(self, o):
        return self._binary(o, "elemwise_mod", "_rmod_scalar", reverse=True)

    def __pow__(self, o):
        return self._binary(o, "elemwise_power", "_power_scalar")

    def __rpow__(self, o):
        return self._binary(o, "elemwise_power", "_rpower_scalar", reverse=True)

    def __matmul__(self, o):
        return self.dot(o)

    def __neg__(self):
        return invoke("negative", (self,), {})

    def __abs__(self):
        return invoke("abs", (self,), {})

    def __eq__(self, o):
        if isinstance(o, (NDArray,) + numeric_types):
            return self._binary(o, "elemwise_equal", "_equal_scalar")
        return NotImplemented

    def __ne__(self, o):
        if isinstance(o, (NDArray,) + numeric_types):
            return self._binary(o, "elemwise_not_equal", "_not_equal_scalar")
        return NotImplemented

    def __gt__(self, o):
        return self._binary(o, "elemwise_greater", "_greater_scalar")

    def __ge__(self, o):
        return self._binary(o, "elemwise_greater_equal", "_greater_equal_scalar")

    def __lt__(self, o):
        return self._binary(o, "elemwise_lesser", "_lesser_scalar")

    def __le__(self, o):
        return self._binary(o, "elemwise_lesser_equal", "_lesser_equal_scalar")

    def __hash__(self):
        return id(self)

    # in-place: the result is written into this array (see `_write`)
    def __iadd__(self, o):
        self._set_data((self + o)._data)
        return self

    def __isub__(self, o):
        self._set_data((self - o)._data)
        return self

    def __imul__(self, o):
        self._set_data((self * o)._data)
        return self

    def __itruediv__(self, o):
        self._set_data((self / o)._data)
        return self

    # -- indexing ---------------------------------------------------------
    def __getitem__(self, key):
        if isinstance(key, NDArray):
            key = key._data.long()
        dims, key = _positive_steps(key, self.shape)
        with _autograd._grad_mode():
            src = self._data.flip(dims) if dims else self._data
            out = src[key]
            if not out.is_contiguous():
                out = out.contiguous()
        return NDArray(out, self._ctx)

    def __setitem__(self, key, value):
        if isinstance(value, NDArray):
            value = value._data
        elif not isinstance(value, numeric_types):
            value = torch.from_numpy(_np.array(value))
        if torch.is_tensor(value):
            value = value.to(self._data.device, self._data.dtype)
        if isinstance(key, NDArray):
            key = key._data.long()
        dims, key = _positive_steps(key, self.shape)

        def write(t):
            if not dims:
                t[key] = value
                return
            # torch takes no negative step: write the flipped copy through
            # the mirrored key, and flip it back into place
            flipped = t.flip(dims)
            flipped[key] = value
            t.copy_(flipped.flip(dims))

        self._write(write)

    def __iter__(self):
        for i in range(self.shape[0]):
            yield self[i]

    def __repr__(self):
        return "\n%s\n<NDArray %s @%s>" % (
            self.asnumpy(), "x".join(str(s) for s in self.shape), self.context)

    # numpy interop
    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a


def _positive_steps(key, shape):
    """``(dims, key)``: the dimensions a key slices with a negative step, and
    the key that takes the same elements, in the same order, from the array
    flipped along those dimensions (every step positive), as torch needs.
    Keys without a negative step come back as they are."""
    parts = key if isinstance(key, tuple) else (key,)
    if not any(isinstance(k, slice) and k.step is not None and k.step < 0
               for k in parts):
        return (), key
    used = sum(1 for k in parts if k is not None and k is not Ellipsis)
    out, dims, d = [], [], 0
    for k in parts:
        if k is Ellipsis:
            out.append(k)
            d += len(shape) - used
            continue
        if k is None:
            out.append(k)
            continue
        if isinstance(k, slice) and k.step is not None and k.step < 0:
            n = shape[d]
            start, stop, step = k.indices(n)
            count = len(range(start, stop, step))
            first = n - 1 - start
            k = slice(first, first + count * -step, -step) if count \
                else slice(0, 0)
            dims.append(d)
        out.append(k)
        d += 1
    return tuple(dims), tuple(out)


# --------------------------------------------------------------------------
# op invocation — the Imperative::Invoke equivalent
# --------------------------------------------------------------------------

def _storage(t):
    return t.untyped_storage().data_ptr()


def invoke(op_name, inputs, attrs, out=None, ctx=None):
    """Invoke a registered op on NDArrays (reference call path:
    MXImperativeInvokeEx c_api_ndarray.cc:132 -> Imperative::Invoke
    imperative.cc:89). Outputs go to ``ctx`` if given, else to the first
    input's device (and context), else to `current_context`; each is a
    contiguous tensor of its own, never a view of an input. An op taking
    ``is_train`` gets autograd's training mode, one that ``needs_rng``
    this thread's generator for the device, and an op's hidden trailing
    outputs (the aux inputs it updated in place) are not returned. The op
    is one "imperative" profiler event (`profiler.timed_call`, the
    reference's ProfileOperator hook); recorded while profiling, its
    backward is one ``_backward_<op>`` event too
    (`profiler.hook_backward`)."""
    opdef = _ops.get(op_name)
    if opdef.host:
        return _invoke_host(opdef, op_name, inputs, attrs, out, ctx)
    attrs = {k: v._data if isinstance(v, NDArray) else v
             for k, v in attrs.items() if v is not None or k in ("axis",)}
    attrs.pop("name", None)
    if any(isinstance(i, NDArray) and i.stype != "default" for i in inputs):
        if opdef.sparse_fn is not None:
            return _invoke_sparse(opdef, op_name, inputs, attrs, out)
        # storage fallback: the op sees the dense values
        inputs = tuple(i.tostype("default") if isinstance(i, NDArray)
                       else i for i in inputs)
    tensors = tuple(i._data if isinstance(i, NDArray) else i for i in inputs)
    arrays = [t for t in tensors + tuple(attrs.values()) if torch.is_tensor(t)]
    if ctx is not None:
        dev, ctx = resolve_device(ctx), as_context(ctx)
    else:
        dev = arrays[0].device if arrays else resolve_device(None)
        ctx = next((i._ctx for i in inputs if isinstance(i, NDArray)), None)
    if _ops.takes_is_train(opdef):
        attrs.setdefault("is_train", _autograd.is_training())
    if opdef.needs_rng:
        attrs.setdefault("generator", _random.generator(dev))
    with _autograd._grad_mode():
        results = _profiler.timed_call(op_name, _ops.invoke_torch,
                                       (opdef.name, tensors, attrs))
        results = tuple(results) if isinstance(results, (tuple, list)) \
            else (results,)
        if _profiler.backward_hooks_wanted():
            _profiler.hook_backward(opdef.name, results)
        if opdef.num_outputs > 0:
            results = results[:opdef.visible_outputs]
        _engine.op_done(dev)
        shared = {_storage(t) for t in arrays}
        out_nd = []
        for r in results:
            r = r.to(dev)
            if _storage(r) in shared or not r.is_contiguous():
                r = r.clone(memory_format=torch.contiguous_format)
            out_nd.append(NDArray(r, ctx))

    return _deliver(out_nd, out)


def _deliver(out_nd, out):
    """The op's output arrays, or, with ``out=``, those arrays written with
    them."""
    if out is not None:
        outs = out if isinstance(out, (list, tuple)) else [out]
        for dst, src in zip(outs, out_nd):
            dst._set_data(src._data)
        return out
    return out_nd[0] if len(out_nd) == 1 else out_nd


def _invoke_sparse(opdef, op_name, inputs, attrs, out):
    """An op with a sparse form (``sparse_fn``, the lazy optimizer updates)
    given a sparse input: ``sparse_fn`` takes the NDArrays as they are and
    returns new tensors, off the tape."""
    with torch.no_grad():
        results = _profiler.timed_call(
            op_name, lambda: opdef.sparse_fn(*inputs, **attrs), ())
    results = results if isinstance(results, (tuple, list)) else (results,)
    return _deliver([NDArray(r) for r in results], out)


def _invoke_host(opdef, op_name, inputs, attrs, out, ctx):
    """A host op (``host``, the DGL graph ops): its function takes the
    NDArrays (sparse ones included) and returns NDArrays, computed with
    numpy on the host; one that ``needs_rng`` gets this thread's generator
    for the inputs' device."""
    attrs = {k: v for k, v in attrs.items() if v is not None}
    attrs.pop("name", None)
    if opdef.needs_rng:
        dev = next((i.context for i in inputs if isinstance(i, NDArray)),
                   None) if ctx is None else ctx
        attrs.setdefault("generator",
                         _random.generator(resolve_device(dev)))
    results = _profiler.timed_call(
        op_name, lambda: opdef.fn(*inputs, **attrs), ())
    results = list(results) if isinstance(results, (tuple, list)) \
        else [results]
    return _deliver(results, out)


# --------------------------------------------------------------------------
# creation / io functions (reference: python/mxnet/ndarray/ndarray.py + utils)
# --------------------------------------------------------------------------

def _placed(ctx):
    """The `Context` a new array is placed with: ``ctx``, else the
    innermost ``with ctx:`` block's (None: its device's)."""
    if ctx is None:
        ctx = _innermost()
        return ctx if isinstance(ctx, Context) else None
    return as_context(ctx)


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def array(source, ctx=None, dtype=None):
    """A new array holding a copy of ``source`` (an NDArray, a tensor or
    anything numpy takes); float32 unless ``dtype`` is given or the source
    is an NDArray (reference: python/mxnet/ndarray/ndarray.py `array`)."""
    dev = resolve_device(ctx)
    if isinstance(source, NDArray):
        if dtype is None:
            dtype = source.dtype
        source = source._data
    dtype = "float32" if dtype is None else dtype
    tdt = torch_dtype(dtype)
    if torch.is_tensor(source):
        return NDArray(source.detach().to(dev, tdt, copy=True),
                       _placed(ctx))
    # np.array copies, so the new tensor owns its memory
    npa = _np.array(source, order="C", dtype=_np.float32
                    if tdt == torch.bfloat16 else np_dtype(dtype))
    return NDArray(torch.from_numpy(npa).to(dev, tdt), _placed(ctx))


def zeros(shape, ctx=None, dtype="float32", **kwargs):
    return NDArray(torch.zeros(_shape(shape), dtype=torch_dtype(dtype),
                               device=resolve_device(ctx)), _placed(ctx))


def ones(shape, ctx=None, dtype="float32", **kwargs):
    return NDArray(torch.ones(_shape(shape), dtype=torch_dtype(dtype),
                              device=resolve_device(ctx)), _placed(ctx))


def full(shape, val, ctx=None, dtype="float32", **kwargs):
    return NDArray(torch.full(_shape(shape), val, dtype=torch_dtype(dtype),
                              device=resolve_device(ctx)), _placed(ctx))


def empty(shape, ctx=None, dtype="float32"):
    return zeros(shape, ctx=ctx, dtype=dtype)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype="float32"):
    return invoke("_arange", (), {"start": start, "stop": stop, "step": step,
                                  "repeat": repeat, "dtype": dtype}, ctx=ctx)


def concat(*arrays, dim=1):
    return invoke("Concat", tuple(arrays), {"dim": dim})


def stack(*arrays, axis=0):
    return invoke("stack", tuple(arrays), {"axis": axis})


def waitall():
    """Block until every card's queued work is done."""
    if torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


# numpy has no bfloat16: the JAX package's npz holds its raw bits as 2-byte
# void ("|V2"), and so does the port's
_BF16_NPZ = _np.dtype("V2")


def _to_npz(v):
    if not isinstance(v, NDArray):
        return _np.asarray(v)
    if v.stype != "default":   # written dense, as the JAX package does
        v = v.tostype("default")
    if v._data.dtype == torch.bfloat16:
        return v._data.view(torch.int16).cpu().numpy().view(_BF16_NPZ)
    return v.asnumpy()


def save(fname, data):
    """Save NDArrays in the JAX package's container (npz: keys "0", "1", ...
    for a list, the names for a dict), so each package loads the other's
    files. Crash-consistent: written to a same-directory temp file, fsynced
    and atomically renamed onto ``fname``."""
    if isinstance(data, NDArray):
        data = {"0": data}
    if isinstance(data, (list, tuple)):
        data = {str(i): v for i, v in enumerate(data)}
    arrays = {k: _to_npz(v) for k, v in data.items()}
    # write through a file object: savez then cannot append ".npz" to the
    # name, so the rename target is exactly the requested filename
    with atomic_writer(fname, "wb") as f:
        _np.savez(f, **arrays)


def _from_npz(a, ctx):
    if a.dtype == _BF16_NPZ:
        bits = torch.from_numpy(_np.ascontiguousarray(a).view(_np.int16))
        return NDArray(bits.view(torch.bfloat16).to(resolve_device(ctx),
                                                    copy=True), ctx)
    return array(a, ctx=ctx, dtype=a.dtype)


def load(fname, ctx=None):
    """NDArrays saved by `save` (or by the JAX package's ``nd.save``), on
    ``ctx`` (default `current_context`); a list for "0", "1", ... keys, else
    a dict. ``fname`` may also be the file's bytes."""
    src = fname
    if isinstance(fname, (bytes, bytearray)):
        src = io.BytesIO(bytes(fname))
        fname = "<bytes>"
    ctx = as_context(ctx) if ctx is not None \
        else Context(resolve_device(None))
    try:
        with _np.load(src, allow_pickle=False) as f:
            out = {k: _from_npz(f[k], ctx) for k in f.files}
    except (zipfile.BadZipFile, EOFError, zlib.error) as e:
        raise MXNetError(
            "failed to load NDArrays from %r: file is truncated or corrupt "
            "(%s: %s). nd.save writes atomically (temp + rename), so a "
            "complete save can't produce this; the file was likely copied "
            "partially or written by an interrupted transfer."
            % (fname, type(e).__name__, e)) from e
    keys = list(out)
    if keys and all(k.isdigit() for k in keys):
        return [out[k] for k in sorted(keys, key=int)]
    return out


def from_dlpack(capsule_or_tensor):
    """An NDArray sharing memory with a DLPack capsule or any object with
    ``__dlpack__`` (torch tensors, numpy arrays); its dtype and device are
    the source's (reference: ndarray.py from_dlpack). A non-contiguous
    source is copied."""
    t = torch.utils.dlpack.from_dlpack(capsule_or_tensor)
    return NDArray(t if t.is_contiguous() else t.contiguous())


def to_dlpack_for_read(arr):
    """Module-level form (reference exports both)."""
    return arr.to_dlpack_for_read()


def to_dlpack_for_write(arr):
    return arr.to_dlpack_for_write()
