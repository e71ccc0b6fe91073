"""Sparse NDArray storage: row_sparse and csr.

Counterpart of `mxnet_tpu/ndarray/sparse.py` (reference:
include/mxnet/ndarray.h:61-66 kRowSparseStorage / kCSRStorage, the Python
front python/mxnet/ndarray/sparse.py, and the kernels of
src/operator/tensor/cast_storage-inl.h, dot-inl.h, sparse_retain and
square_sum). Every sparse operation here is a torch gather, scatter or
segmented sum on the array's device; the JAX package lowers the same
operations to XLA's, and no Pallas kernel lies behind any of them.

- A sparse array keeps its logical dense shape and its components in a
  dict of torch tensors on one device (``_data``): ``data`` and
  ``indices`` for row_sparse (``indices`` sorted, unique rows), ``data``,
  ``indices`` (column ids) and ``indptr`` for csr. Index components are
  int32, the dtype the JAX package's arrays carry, so both packages'
  ``asnumpy()`` agree.
- Autograd stays dense, as in the JAX package: the tape's gradients are
  dense tensors, and a row_sparse gradient buffer (`attach_grad` with
  ``stype="row_sparse"``, a gluon Parameter's ``grad_stype``) is filled by
  casting the dense gradient. Sparsity pays off in the lazy optimizer
  updates, which touch only the gradient's rows, and in the kvstore's
  row_sparse push and pull.
- Sums have a fixed order on the card, so two runs agree bit for bit:
  `dot` of a csr matrix sums each output row over its CSR segment
  (``torch.segment_reduce`` over ``indptr``), and its transpose sums over
  the segments of one stable sort of the column ids, cached beside the row
  ids. `add` sums at most two values a row, which is the same in any
  order. No atomic float add is used.
- Output sizes that depend on the data (`cast_storage` to row_sparse or
  csr, `sparse_retain`, `add`) cost one host sync each (``nonzero`` or
  ``unique``); `dot` and its backward cost none.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import MXNetError, np_dtype, torch_dtype
from ..context import Context, resolve_device
from .ndarray import NDArray, array as _dense_array

__all__ = ["BaseSparseNDArray", "RowSparseNDArray", "CSRNDArray",
           "row_sparse_array", "csr_matrix", "cast_storage", "sparse_retain",
           "retain", "dot", "square_sum", "add", "zeros", "empty", "array",
           "sgd_update", "sgd_mom_update", "adam_update", "adagrad_update"]

_INDEX = torch.int32   # the index dtype the JAX package's arrays carry


def _t(x):
    return x._data if isinstance(x, NDArray) else x


class BaseSparseNDArray(NDArray):
    """Common base of the sparse arrays (reference: sparse.py
    BaseSparseNDArray): a logical shape and a dict of component tensors."""

    __slots__ = ("_shape", "_row_ids_cache", "_col_cache")

    @classmethod
    def _new(cls, comps, shape):
        out = cls.__new__(cls)
        NDArray.__init__(out, comps)
        out._shape = tuple(int(s) for s in shape)
        out._row_ids_cache = out._col_cache = None
        return out

    def _assign(self, other):
        """Take ``other``'s shape and components (the same stype); caches
        derived from the old components are dropped."""
        if type(other) is not type(self):
            raise MXNetError("cannot assign a %s to a %s"
                             % (other.stype, self.stype))
        self._shape = other._shape
        self._data = dict(other._data)
        self._row_ids_cache = self._col_cache = None
        return self

    @property
    def shape(self):
        return self._shape

    @property
    def size(self):
        return int(_np.prod(self._shape, dtype=_np.int64))

    @property
    def ndim(self):
        return len(self._shape)

    @property
    def dtype(self):
        return np_dtype(self._data["data"].dtype)

    @property
    def context(self):
        return Context(self._device)

    ctx = context

    @property
    def _device(self):
        return self._data["data"].device

    def wait_to_read(self):
        if self._device.type == "cuda":
            torch.cuda.current_stream(self._device).synchronize()
        return self

    wait_to_write = wait_to_read

    def asnumpy(self):
        return self.todense().asnumpy()

    def astype(self, dtype, copy=True):
        """The stored values cast to ``dtype``, sparsity kept (reference:
        sparse.py BaseSparseNDArray.astype)."""
        comps = dict(self._data)
        comps["data"] = comps["data"].to(torch_dtype(dtype))
        return type(self)._new(comps, self._shape)

    def todense(self):
        return self.tostype("default")

    def __repr__(self):
        return "\n<%s %s @%s>" % (type(self).__name__,
                                  "x".join(str(s) for s in self._shape),
                                  self.context)

    def __getitem__(self, key):
        return self.todense()[key]

    def __setitem__(self, key, value):
        raise MXNetError("sparse NDArray does not support item assignment")

    def _set_data(self, value):
        """Write a dense ``value`` (a tensor of this shape) into this array,
        cast to its storage type."""
        dense = NDArray(torch.as_tensor(value).to(
            self._device, self._data["data"].dtype).expand(self._shape)
            .contiguous())
        self._assign(cast_storage(dense, self.stype))

    def copyto(self, other):
        """Sparse-aware copy (reference: sparse.py copyto): to a device, the
        same stype there; to a sparse array of the same stype, its
        components; to a dense NDArray, the dense values."""
        if isinstance(other, (Context, torch.device, str)):
            dev = resolve_device(other)
            return type(self)._new({k: v.to(dev, copy=True)
                                    for k, v in self._data.items()},
                                   self._shape)
        if isinstance(other, BaseSparseNDArray):
            if type(other) is not type(self):
                raise MXNetError("copyto: stype mismatch (%s -> %s)"
                                 % (self.stype, other.stype))
            dev = other._device
            return other._assign(type(self)._new(
                {k: v.to(dev, copy=True) for k, v in self._data.items()},
                self._shape))
        if isinstance(other, NDArray):
            return self.todense().copyto(other)
        raise TypeError("copyto: expected NDArray or device")


class RowSparseNDArray(BaseSparseNDArray):
    """row_sparse (reference: sparse.py RowSparseNDArray): ``indices`` the
    sorted, unique rows present, ``data`` their values, (nnz_rows,) +
    shape[1:]."""

    __slots__ = ()

    @property
    def stype(self):
        return "row_sparse"

    @property
    def data(self):
        return NDArray(self._data["data"])

    values = data

    @property
    def indices(self):
        return NDArray(self._data["indices"])

    @property
    def num_rows(self):
        return int(self._data["indices"].shape[0])

    def tostype(self, stype):
        if stype == "row_sparse":
            return self
        if stype == "default":
            vals = self._data["data"]
            dense = torch.zeros(self._shape, dtype=vals.dtype,
                                device=vals.device)
            dense.index_copy_(0, self._data["indices"].long(), vals)
            return NDArray(dense)
        if stype == "csr":
            return self.todense().tostype("csr")
        raise MXNetError("unknown stype '%s'" % stype)

    def retain(self, row_ids):
        return sparse_retain(self, row_ids)


class CSRNDArray(BaseSparseNDArray):
    """csr: a 2-D compressed sparse row matrix (reference: sparse.py
    CSRNDArray): ``data`` (nnz,), ``indices`` (nnz,) column ids, ``indptr``
    (rows + 1,)."""

    __slots__ = ()

    @property
    def stype(self):
        return "csr"

    @property
    def data(self):
        return NDArray(self._data["data"])

    @property
    def indices(self):
        return NDArray(self._data["indices"])

    @property
    def indptr(self):
        return NDArray(self._data["indptr"])

    @property
    def nnz(self):
        return int(self._data["data"].shape[0])

    def _row_ids(self):
        """The row of each stored value (int64, on the device), computed
        from ``indptr`` once per component set, with no host sync."""
        if self._row_ids_cache is None:
            indptr = self._data["indptr"].long()
            self._row_ids_cache = torch.repeat_interleave(
                torch.arange(self._shape[0], device=indptr.device),
                indptr[1:] - indptr[:-1], output_size=self.nnz)
        return self._row_ids_cache

    def _col_order(self):
        """(order, offsets): the stable sort of the column ids, and where
        each of the ``shape[1]`` columns' run starts in it; computed once
        per component set, with no host sync. The transposed product sums
        each column's run in this order."""
        if self._col_cache is None:
            cols = self._data["indices"].long()
            order = torch.sort(cols, stable=True)[1]
            counts = torch.zeros(self._shape[1], dtype=torch.int64,
                                 device=cols.device)
            counts.index_add_(0, cols, torch.ones_like(cols))
            offsets = torch.zeros(self._shape[1] + 1, dtype=torch.int64,
                                  device=cols.device)
            torch.cumsum(counts, 0, out=offsets[1:])
            self._col_cache = (order, offsets)
        return self._col_cache

    def tostype(self, stype):
        if stype == "csr":
            return self
        if stype == "default":
            vals = self._data["data"]
            dense = torch.zeros(self._shape, dtype=vals.dtype,
                                device=vals.device)
            dense[self._row_ids(), self._data["indices"].long()] = vals
            return NDArray(dense)
        if stype == "row_sparse":
            return self.todense().tostype("row_sparse")
        raise MXNetError("unknown stype '%s'" % stype)


# --------------------------------------------------------------------------
# construction (reference: sparse.py row_sparse_array / csr_matrix)
# --------------------------------------------------------------------------

def _tensor(x, dev, dtype):
    if isinstance(x, NDArray):
        x = x._data
    if torch.is_tensor(x):
        return x.detach().to(dev, dtype, copy=True).contiguous()
    npa = _np.asarray(x)
    if dtype == torch.bfloat16:
        npa = npa.astype(_np.float32)
    return torch.from_numpy(_np.ascontiguousarray(npa)).to(dev, dtype)


def _make_rsp(data, indices, shape, dev, dtype):
    return RowSparseNDArray._new(
        {"data": _tensor(data, dev, torch_dtype(dtype)),
         "indices": _tensor(indices, dev, _INDEX)}, shape)


def _make_csr(data, indptr, indices, shape, dev, dtype):
    return CSRNDArray._new({"data": _tensor(data, dev, torch_dtype(dtype)),
                            "indices": _tensor(indices, dev, _INDEX),
                            "indptr": _tensor(indptr, dev, _INDEX)}, shape)


def _host(a, dtype):
    return _np.asarray(a.asnumpy() if isinstance(a, NDArray) else a,
                       dtype=dtype)


def _dev(ctx):
    return resolve_device(ctx)


def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """A RowSparseNDArray (reference: sparse.py row_sparse_array) from a
    ``(data, indices)`` pair (sorted here), a dense source, or another
    row_sparse array (returned as it is)."""
    if isinstance(arg1, RowSparseNDArray):
        return arg1
    dev = _dev(ctx)
    if isinstance(arg1, tuple) and len(arg1) == 2 \
            and not isinstance(arg1[0], int):
        data = _host(arg1[0], dtype or "float32")
        indices = _host(arg1[1], "int64")
        order = _np.argsort(indices)
        if shape is None:
            top = int(indices.max()) + 1 if indices.size else 0
            shape = (top,) + data.shape[1:]
        return _make_rsp(data[order], indices[order], shape, dev,
                         dtype or data.dtype)
    dense = arg1 if isinstance(arg1, NDArray) \
        else _dense_array(arg1, ctx=dev, dtype=dtype)
    return cast_storage(dense, "row_sparse")


def _check_columns(indices, shape, what):
    """Refuse a column index outside ``shape`` while the indices are still
    on the host (fault F5: the JAX package's densify drops such an entry
    silently)."""
    if indices.size:
        lo, hi = int(indices.min()), int(indices.max())
        if lo < 0 or hi >= shape[1]:
            raise MXNetError("%s: column index %d lies outside the shape %s "
                             "(%d columns)" % (what, hi if hi >= shape[1]
                                               else lo, tuple(shape),
                                               shape[1]))


def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """A CSRNDArray (reference: sparse.py csr_matrix) from ``(data,
    indices, indptr)`` (scipy's order), a scipy matrix, a dense source, or
    another csr array (returned as it is)."""
    if isinstance(arg1, CSRNDArray):
        return arg1
    dev = _dev(ctx)
    if isinstance(arg1, tuple) and len(arg1) == 3:
        data = _host(arg1[0], dtype or "float32")
        indices = _host(arg1[1], "int64")
        indptr = _host(arg1[2], "int64")
        if shape is None:
            shape = (len(indptr) - 1,
                     int(indices.max()) + 1 if indices.size else 0)
        _check_columns(indices, shape, "csr_matrix")
        return _make_csr(data, indptr, indices, shape, dev,
                         dtype or data.dtype)
    if hasattr(arg1, "tocsr"):   # a scipy.sparse matrix
        return array(arg1, ctx=dev, dtype=dtype)
    dense = arg1 if isinstance(arg1, NDArray) \
        else _dense_array(arg1, ctx=dev, dtype=dtype)
    return cast_storage(dense, "csr")


def array(source_array, ctx=None, dtype=None):
    """Sparse-aware ``nd.sparse.array`` (reference: sparse.py array): a
    sparse array as it is, a scipy matrix as csr, anything else dense."""
    if isinstance(source_array, BaseSparseNDArray):
        return source_array
    if hasattr(source_array, "tocsr"):
        csr = source_array.tocsr()
        return csr_matrix((csr.data, csr.indices, csr.indptr),
                          shape=csr.shape, ctx=ctx, dtype=dtype)
    return _dense_array(source_array, ctx=ctx, dtype=dtype)


def zeros(stype, shape, ctx=None, dtype="float32"):
    """An all-zero array of ``stype`` (reference: sparse.py zeros)."""
    dev = _dev(ctx)
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    dtype = dtype or "float32"
    if stype == "row_sparse":
        return _make_rsp(_np.zeros((0,) + shape[1:], dtype=_np.float32),
                         _np.zeros((0,), dtype=_np.int64), shape, dev, dtype)
    if stype == "csr":
        return _make_csr(_np.zeros((0,), dtype=_np.float32),
                         _np.zeros((shape[0] + 1,), dtype=_np.int64),
                         _np.zeros((0,), dtype=_np.int64), shape, dev, dtype)
    if stype == "default":
        from .ndarray import zeros as _dense_zeros

        return _dense_zeros(shape, ctx=dev, dtype=dtype)
    raise MXNetError("unknown stype '%s'" % stype)


def empty(stype, shape, ctx=None, dtype="float32"):
    return zeros(stype, shape, ctx=ctx, dtype=dtype)


# --------------------------------------------------------------------------
# operations (reference: cast_storage, sparse_retain, dot, square_sum and
# elemwise_add of src/operator/tensor)
# --------------------------------------------------------------------------

def cast_storage(arr, stype):
    """Convert between storage types (reference: cast_storage op). Dense to
    row_sparse scans the rows on the device; only the row count reaches the
    host (one sync), never the values."""
    if isinstance(arr, BaseSparseNDArray):
        return arr.tostype(stype)
    if stype == "default":
        return arr
    t = arr._data.detach()
    if stype == "row_sparse":
        if t.ndim < 1:
            raise MXNetError("row_sparse needs ndim >= 1")
        rows = torch.nonzero(t.reshape(t.shape[0], -1).ne(0).any(1))
        rows = rows.reshape(-1)
        return RowSparseNDArray._new({"data": t.index_select(0, rows),
                                      "indices": rows.to(_INDEX)}, t.shape)
    if stype == "csr":
        if t.ndim != 2:
            raise MXNetError("csr storage requires a 2-D array")
        rows, cols = torch.nonzero(t, as_tuple=True)
        counts = torch.zeros(t.shape[0], dtype=torch.int64, device=t.device)
        counts.index_add_(0, rows, torch.ones_like(rows))
        indptr = torch.zeros(t.shape[0] + 1, dtype=torch.int64,
                             device=t.device)
        torch.cumsum(counts, 0, out=indptr[1:])
        return CSRNDArray._new({"data": t[rows, cols].contiguous(),
                                "indices": cols.to(_INDEX),
                                "indptr": indptr.to(_INDEX)}, t.shape)
    raise MXNetError("unknown stype '%s'" % stype)


def sparse_retain(arr, indices):
    """Keep only the requested rows (reference: sparse_retain op); one host
    sync for the kept count."""
    if not isinstance(arr, RowSparseNDArray):
        raise MXNetError("sparse_retain expects a RowSparseNDArray")
    have = arr._data["indices"]
    want = _t(indices) if isinstance(indices, NDArray) \
        else torch.as_tensor(_np.asarray(indices))
    keep = torch.nonzero(torch.isin(have, want.to(have.device, have.dtype)))
    keep = keep.reshape(-1)
    return RowSparseNDArray._new(
        {"data": arr._data["data"].index_select(0, keep),
         "indices": have.index_select(0, keep)}, arr.shape)


retain = sparse_retain


def _csr_dot_math(lhs, dense, transpose_a):
    """csr x dense (or csr.T x dense) on tensors, each output row summed
    over its segment in a fixed order (see the module docstring)."""
    vals = lhs._data["data"]
    vec = dense.ndim == 1
    d2 = dense.reshape(dense.shape[0], -1)
    if not transpose_a:
        # out[m] = sum_k csr[m, k] * dense[k], over row m's CSR segment
        prods = vals[:, None] * d2.index_select(
            0, lhs._data["indices"].long())
        out = torch.segment_reduce(prods, "sum",
                                   offsets=lhs._data["indptr"].long(),
                                   axis=0, unsafe=True)
        return out.reshape(-1) if vec else out
    # out[k] = sum_m csr[m, k] * dense[m], over column k's run of the
    # stable sort of the column ids
    order, offsets = lhs._col_order()
    prods = vals.index_select(0, order)[:, None] * d2.index_select(
        0, lhs._row_ids().index_select(0, order))
    out = torch.segment_reduce(prods, "sum", offsets=offsets, axis=0,
                               unsafe=True)
    return out.reshape(-1) if vec else out


class _CSRDot(torch.autograd.Function):
    """dot(csr, w) as a node of torch's graph: differentiable in the dense
    ``w`` only (the csr matrix is data); the backward is the transposed
    product (reference: dot backward, dot-inl.h)."""

    @staticmethod
    def forward(ctx, rhs, lhs, transpose_a):
        ctx.lhs, ctx.transpose_a = lhs, transpose_a
        return _csr_dot_math(lhs, rhs, transpose_a)

    @staticmethod
    def backward(ctx, ograd):
        return (_csr_dot_math(ctx.lhs, ograd.contiguous(),
                              not ctx.transpose_a), None, None)


def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """Sparse-aware dot (reference: dot-inl.h): csr x dense and csr.T x
    dense as segmented sums, recorded on the tape with respect to ``rhs``
    (the sparse linear model's weight); a row_sparse operand is densified."""
    from .. import autograd as _ag

    if isinstance(lhs, CSRNDArray):
        if transpose_b:
            raise MXNetError("dot(csr, dense, transpose_b=True) is not "
                             "supported (as in the reference)")
        if rhs.ndim not in (1, 2):
            raise MXNetError("dot(csr, dense): rhs must be 1-D or 2-D, got "
                             "%dD" % rhs.ndim)
        dense = rhs.tostype("default") \
            if isinstance(rhs, BaseSparseNDArray) else rhs
        with _ag._grad_mode():
            return NDArray(_CSRDot.apply(dense._data, lhs, transpose_a))
    if isinstance(lhs, BaseSparseNDArray) or isinstance(rhs, BaseSparseNDArray):
        lhs = lhs.tostype("default")
        rhs = rhs.tostype("default")
    return lhs.dot(rhs, transpose_a=transpose_a, transpose_b=transpose_b)


def square_sum(arr, axis=None, keepdims=False):
    """sum(x^2) over the stored values only (reference: _square_sum op);
    along axis 1 of a 2-D array the result is row_sparse on the same
    rows."""
    if not isinstance(arr, RowSparseNDArray):
        raise MXNetError("square_sum expects a RowSparseNDArray")
    vals = arr._data["data"]
    if axis is None:
        return NDArray(torch.sum(vals * vals))
    if axis in (1, -1) and arr.ndim == 2:
        rows_sq = torch.sum(vals * vals, dim=1, keepdim=keepdims)
        out_shape = (arr.shape[0],) + ((1,) if keepdims else ())
        return RowSparseNDArray._new({"data": rows_sq,
                                      "indices": arr._data["indices"]},
                                     out_shape)
    return NDArray(torch.sum(arr.todense()._data.square(), dim=axis,
                             keepdim=keepdims))


def add(lhs, rhs):
    """row_sparse + row_sparse -> row_sparse over the union of the rows
    (reference: elemwise_add's sparse path; the kvstore's aggregation),
    on the device, one host sync for the union's size. Anything else adds
    densely."""
    if isinstance(lhs, RowSparseNDArray) and isinstance(rhs, RowSparseNDArray):
        if lhs.shape != rhs.shape:
            raise MXNetError("shape mismatch in sparse add")
        dev, dt = lhs._device, lhs._data["data"].dtype
        idx = torch.cat([lhs._data["indices"],
                         rhs._data["indices"].to(dev)]).long()
        vals = torch.cat([lhs._data["data"], rhs._data["data"].to(dev, dt)])
        union, inv = torch.unique(idx, return_inverse=True)
        summed = torch.zeros((union.shape[0],) + tuple(vals.shape[1:]),
                             dtype=dt, device=dev)
        summed.index_add_(0, inv, vals)   # at most two values a row
        return RowSparseNDArray._new({"data": summed,
                                      "indices": union.to(_INDEX)},
                                     lhs.shape)
    l = lhs.tostype("default") if isinstance(lhs, BaseSparseNDArray) else lhs
    r = rhs.tostype("default") if isinstance(rhs, BaseSparseNDArray) else rhs
    return l + r


# --------------------------------------------------------------------------
# lazy (row-wise) optimizer updates (reference: the Rsp updates of
# src/operator/optimizer_op.cc): only the gradient's rows are read and
# written; the weight and the states change in place. ``weight`` and the
# states are NDArrays or tensors; the rows are unique, so each write has
# one writer.
# --------------------------------------------------------------------------

def _lazy(weight, grad, rescale_grad, clip_gradient, wd):
    """(weight tensor, rows, the rows' weights, their gradient)."""
    w = _t(weight)
    rows = grad._data["indices"].to(w.device).long()
    g = grad._data["data"].to(w.device) * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    w_rows = w.index_select(0, rows)
    return w, rows, w_rows, g + wd * w_rows


def _put(t, rows, value):
    t.index_copy_(0, rows, value.to(t.dtype))


@torch.no_grad()
def sgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0):
    """Lazy SGD (reference: SGDUpdateRspImpl): the gradient's rows only."""
    w, rows, w_rows, g = _lazy(weight, grad, rescale_grad, clip_gradient, wd)
    _put(w, rows, w_rows + -lr * g)
    return weight


@torch.no_grad()
def sgd_mom_update(weight, grad, mom, lr, momentum, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    """Lazy SGD with momentum: the momentum of other rows stays as it
    is."""
    w, rows, w_rows, g = _lazy(weight, grad, rescale_grad, clip_gradient, wd)
    m = _t(mom)
    new_mom = momentum * m.index_select(0, rows) - lr * g
    _put(m, rows, new_mom)
    _put(w, rows, w_rows + new_mom)
    return weight


@torch.no_grad()
def adam_update(weight, grad, mean, var, lr, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """Lazy Adam (reference: AdamUpdateRspImpl): the moments of rows the
    gradient does not hold stay stale, as in the reference."""
    w, rows, w_rows, g = _lazy(weight, grad, rescale_grad, clip_gradient, wd)
    m, v = _t(mean), _t(var)
    m_rows = beta1 * m.index_select(0, rows) + (1 - beta1) * g
    v_rows = beta2 * v.index_select(0, rows) + (1 - beta2) * g * g
    _put(m, rows, m_rows)
    _put(v, rows, v_rows)
    _put(w, rows, w_rows + -lr * m_rows / (torch.sqrt(v_rows) + epsilon))
    return weight


@torch.no_grad()
def adagrad_update(weight, grad, history, lr, epsilon=1e-7, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    """Lazy AdaGrad (reference: _sparse_adagrad_update)."""
    w, rows, w_rows, g = _lazy(weight, grad, rescale_grad, clip_gradient, wd)
    h = _t(history)
    h_rows = h.index_select(0, rows) + g * g
    _put(h, rows, h_rows)
    _put(w, rows, w_rows + -lr * g / (torch.sqrt(h_rows) + epsilon))
    return weight
