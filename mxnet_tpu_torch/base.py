"""Base utilities: the framework error type, dtype names and crash-consistent
writes.

Counterpart of `mxnet_tpu/base.py`, reduced to what the port uses. The port
keeps its own copy instead of importing the JAX package.
"""
from __future__ import annotations

import os
import tempfile

import numpy as _np
import torch

__all__ = ["MXNetError", "atomic_writer", "numeric_types", "np_dtype",
           "torch_dtype", "unpad_outputs"]

numeric_types = (float, int, _np.generic)

# dtype name <-> torch dtype. numpy has no bfloat16 (the JAX package borrows
# ml_dtypes'), so on the numpy side the port names it by the string
# "bfloat16", which compares equal to the dtype's name as numpy dtypes do.
_TORCH_DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "uint8": torch.uint8,
    "int8": torch.int8,
    "int32": torch.int32,
    "int64": torch.int64,
    "bool": torch.bool,
}
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


class MXNetError(RuntimeError):
    """Error raised by the framework (reference: python/mxnet/base.py:49)."""


def np_dtype(dtype):
    """Normalize a user dtype (name, numpy dtype or torch dtype) to a numpy
    dtype; bfloat16 stays the name ``"bfloat16"``. None means float32."""
    if dtype is None:
        return _np.dtype(_np.float32)
    if isinstance(dtype, torch.dtype):
        dtype = _DTYPE_NAMES.get(dtype, str(dtype))
    if str(dtype) == "bfloat16":
        return "bfloat16"
    return _np.dtype(dtype)


def torch_dtype(dtype):
    """The torch dtype of a user dtype (see `np_dtype`)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = np_dtype(dtype)
    name = name if name == "bfloat16" else name.name
    try:
        return _TORCH_DTYPES[name]
    except KeyError:
        raise MXNetError("unsupported dtype %s" % (dtype,)) from None


def unpad_outputs(outputs, pad, copy=False):
    """Drop the trailing ``pad`` rows from every array in ``outputs``.

    The one unpad of every padded-batch consumer: a DataIter's last batch
    carries ``pad`` filler rows (`Module.predict` / `iter_predict`), and the
    serving micro-batcher pads coalesced batches up to a bucket
    (`serving/batcher.py`). Works on anything row-sliceable (NDArray,
    numpy). ``copy=True`` detaches each slice from the padded buffer.
    """
    out = []
    for o in outputs:
        s = o[0:o.shape[0] - pad] if pad else o
        out.append(s.copy() if copy else s)
    return out


class atomic_writer:
    """Crash-consistent file write: ``with atomic_writer(path, 'wb') as f``
    writes to a same-directory temp file, fsyncs it, and atomically renames
    onto `path` only if the block completed. A process killed mid-write can
    leave a stale temp file but never a truncated `path`."""

    def __init__(self, path, mode="wb"):
        self._path = os.fspath(path)
        self._mode = mode
        self._tmp = None
        self._f = None

    def __enter__(self):
        d = os.path.dirname(os.path.abspath(self._path)) or "."
        fd, self._tmp = tempfile.mkstemp(
            dir=d, prefix=os.path.basename(self._path) + ".tmp-")
        # mkstemp creates 0600; keep an existing target's mode, else honor
        # the umask like a plain open() would
        try:
            mode = os.stat(self._path).st_mode & 0o7777
        except OSError:
            umask = os.umask(0)
            os.umask(umask)
            mode = 0o666 & ~umask
        try:
            os.fchmod(fd, mode)
        except OSError:
            pass
        self._f = os.fdopen(fd, self._mode)
        return self._f

    def __exit__(self, exc_type, exc, tb):
        try:
            try:
                if exc_type is None:
                    self._f.flush()
                    os.fsync(self._f.fileno())
            finally:
                self._f.close()
            if exc_type is None:
                os.replace(self._tmp, self._path)
                self._tmp = None
                _fsync_dir(os.path.dirname(os.path.abspath(self._path)) or ".")
        finally:
            if self._tmp is not None and os.path.exists(self._tmp):
                os.unlink(self._tmp)
        return False


def _fsync_dir(path):
    """Persist a rename by fsyncing the containing directory (best-effort:
    some filesystems refuse O_RDONLY dir fsync)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)
