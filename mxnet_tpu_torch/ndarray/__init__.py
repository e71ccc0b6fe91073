"""mxnet_tpu_torch.ndarray — imperative array API (counterpart of
`mxnet_tpu.ndarray`; reference: python/mxnet/ndarray), with the op
namespaces ``contrib`` (the control-flow ops ``foreach`` / ``while_loop`` /
``cond`` among them), ``linalg``, ``random`` and ``image``, and ``sparse``
(row_sparse and csr storage, `ndarray.sparse`)."""
from __future__ import annotations

from .ndarray import (NDArray, invoke, array, zeros, ones, full, empty, arange,
                      concat, stack, save, load, waitall, from_dlpack,
                      to_dlpack_for_read, to_dlpack_for_write)
from . import register as _register

_register.populate(globals())

from . import sparse  # noqa: E402
from .sparse import (BaseSparseNDArray, RowSparseNDArray,  # noqa: E402
                     CSRNDArray)

# control-flow ops live on nd.contrib (reference: ndarray/contrib.py)
from . import control_flow as _control_flow  # noqa: E402

contrib.foreach = _control_flow.foreach  # noqa: F821
contrib.while_loop = _control_flow.while_loop  # noqa: F821
contrib.cond = _control_flow.cond  # noqa: F821


def concatenate(arrays, axis=0, always_copy=True):
    """reference: ndarray.py concatenate (list -> one array along axis)."""
    # a bare NDArray is iterable row-wise, so list() would silently flatten
    # it; the reference asserts list-of-NDArray (ndarray.py:3724)
    if isinstance(arrays, NDArray):
        raise TypeError("concatenate expects a list of NDArrays, got NDArray")
    arrays = list(arrays)
    if not arrays:
        raise ValueError("concatenate expects a non-empty list")
    if len(arrays) == 1 and not always_copy:
        return arrays[0]
    return concat(*arrays, dim=axis)


def zeros_like(data):
    return invoke("zeros_like", (data,), {})


def ones_like(data):
    return invoke("ones_like", (data,), {})


def eye(N, M=0, k=0, ctx=None, dtype="float32"):
    return invoke("_eye", (), {"N": N, "M": M, "k": k, "dtype": dtype},
                  ctx=ctx)


def linspace(start, stop, num, endpoint=True, ctx=None, dtype="float32"):
    return invoke("_linspace", (), {"start": start, "stop": stop, "num": num,
                                    "endpoint": endpoint, "dtype": dtype},
                  ctx=ctx)
