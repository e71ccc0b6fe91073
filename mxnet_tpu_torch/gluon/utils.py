"""Gluon utilities (counterpart of `mxnet_tpu/gluon/utils.py`; reference:
python/mxnet/gluon/utils.py): `split_data`, `split_and_load`,
`clip_global_norm` and `check_sha1`. ``download`` is not ported (ROADMAP
queue 1 item 6): the port fetches nothing.
"""
from __future__ import annotations

import hashlib
import warnings

import numpy as _np
import torch

from .. import ndarray as nd
from ..base import MXNetError
from ..ndarray import NDArray

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """``data`` in ``num_slice`` slices along ``batch_axis`` (reference:
    utils.py:31)."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise MXNetError(
            "data with shape %s cannot be evenly split into %d slices along "
            "axis %d" % (str(data.shape), num_slice, batch_axis))
    n_each = size // num_slice
    if even_split:
        return [data.slice_axis(batch_axis, i * n_each, (i + 1) * n_each)
                for i in range(num_slice)]
    step = (size + num_slice - 1) // num_slice
    return [data.slice_axis(batch_axis, i * step, min((i + 1) * step, size))
            for i in range(num_slice) if i * step < size]


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """Slices of ``data``, one on each context of ``ctx_list`` (reference:
    utils.py:79)."""
    if not isinstance(data, NDArray):
        data = nd.array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Scale ``arrays`` in place so that their joint 2-norm is at most
    ``max_norm``; returns the norm before (reference: utils.py:115). The
    norm is summed in f32 on the arrays' device and read back once."""
    if not arrays:
        raise MXNetError("clip_global_norm: no arrays")
    with torch.no_grad():
        dev = arrays[0]._data.device
        total = torch.stack([a._data.float().square().sum().to(dev)
                             for a in arrays]).sum()
        total_norm = float(total.sqrt())
        if check_isfinite and not _np.isfinite(total_norm):
            warnings.warn("nan or inf found in clip_global_norm")
        scale = max_norm / (total_norm + 1e-8)
        if scale < 1.0:
            for a in arrays:
                a._set_data(a._data * scale)
    return total_norm


def check_sha1(filename, sha1_hash):
    """Whether ``filename``'s SHA-1 is ``sha1_hash``."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        while True:
            data = f.read(1048576)
            if not data:
                break
            sha1.update(data)
    return sha1.hexdigest() == sha1_hash
