"""Four faults of the port against the JAX package, each held at the input
that showed it, on the CPU:

1. ``ops/nn.py:pooling`` with ``pooling_convention="full"`` keeps MXNet's
   ceil((H + 2 p - k) / s) + 1 windows, a last window that starts in the
   padding included (PyTorch's ``ceil_mode`` drops it), at the shape that
   diverged and at six that agreed before, NCHW and NHWC, and through
   ``gluon.nn.MaxPool2D(ceil_mode=True)``.
2. Integer ``mod`` by zero gives 0, as ``jnp.mod`` does, through
   ``elemwise_mod`` / ``broadcast_mod`` / ``mod``, ``_mod_scalar`` and
   ``_rmod_scalar``, with the divisor's sign for the rest.
3. ``softmax`` and ``log_softmax`` of an integer array return float32.
4. ``nd.softmax(x, length=l)`` binds ``l`` by name. The JAX package's
   generated function fails on the same call, so the port's ``nd`` is held
   against the JAX op.

Float results within 1e-6 relative and absolute (both sides compute in f32
from the same inputs); integer results and shapes exactly.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu.ops as jops
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd
from mxnet_tpu_torch import ops as tops
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.ops import nn as tnn_ops

CPU = mx.cpu()


# ---------------------------------------------------------------------------
# 1. max pooling, "full" convention
# ---------------------------------------------------------------------------

# (H = W, kernel, stride, pad): the shape that diverged first, then the six
# that agreed before the repair
_POOL_SHAPES = [(5, 2, 2, 1), (6, 3, 2, 1), (7, 3, 2, 1), (4, 3, 3, 1),
                (112, 3, 2, 1), (5, 3, 2, 0), (6, 2, 2, 1)]


def _pool_input(h, layout):
    x = np.random.RandomState(h).normal(size=(2, 3, h, h)).astype(np.float32)
    return x.transpose(0, 2, 3, 1).copy() if layout == "NHWC" else x


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("h,k,s,p", _POOL_SHAPES)
def test_pooling_full_matches_jax(h, k, s, p, layout):
    x = _pool_input(h, layout)
    attrs = dict(kernel=(k, k), stride=(s, s), pad=(p, p), pool_type="max",
                 pooling_convention="full", layout=layout)
    want = np.asarray(jops.get("Pooling").fn(jnp.asarray(x), **attrs))
    got = tnn_ops.pooling(torch.from_numpy(x), **attrs).numpy()
    out = -(-(h + 2 * p - k) // s) + 1
    assert want.shape[1 if layout == "NHWC" else 2] == out
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("h,k,s,p", _POOL_SHAPES)
def test_maxpool2d_ceil_mode_matches_jax(h, k, s, p):
    x = _pool_input(h, "NCHW")
    layer = tnn.MaxPool2D(pool_size=k, strides=s, padding=p, layout="NCHW",
                          ceil_mode=True)
    got = layer(torch.from_numpy(x)).numpy()
    want = np.asarray(jops.get("Pooling").fn(
        jnp.asarray(x), kernel=(k, k), stride=(s, s), pad=(p, p),
        pool_type="max", pooling_convention="full", layout="NCHW"))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# 2. integer modulo by zero
# ---------------------------------------------------------------------------

_DIVIDEND = np.array([1, -2, 3, 4, -7, 0], np.int64)
_DIVISOR = np.array([0, 0, 2, -3, 3, 0], np.int64)


@pytest.mark.parametrize("dtype", ["int32", "int64"])
@pytest.mark.parametrize("op", ["elemwise_mod", "broadcast_mod", "mod"])
def test_int_mod_by_zero_matches_jnp_mod(op, dtype):
    a, b = _DIVIDEND.astype(dtype), _DIVISOR.astype(dtype)
    if op == "broadcast_mod":
        a, b = a.reshape(2, 3), np.array([[0], [-2]], dtype)
    want = np.asarray(jops.get(op).fn(jnp.asarray(a), jnp.asarray(b)))
    got = tops.get(op).fn(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[b.ravel() == 0 if op != "broadcast_mod"
                        else np.broadcast_to(b == 0, a.shape)] == 0).all()


@pytest.mark.parametrize("dtype", ["int32", "int64"])
@pytest.mark.parametrize("op,scalar", [("_mod_scalar", 0),
                                       ("_mod_scalar", 0.7),
                                       ("_mod_scalar", -3),
                                       ("_rmod_scalar", 5),
                                       ("_rmod_scalar", -5)])
def test_int_scalar_mod_by_zero_matches_jnp_mod(op, scalar, dtype):
    """``int % 0.7`` casts the scalar to the array's dtype first, so it is a
    division by 0 too; ``_rmod_scalar`` divides by the array, zeros and
    negatives included."""
    a = _DIVIDEND.astype(dtype) if op == "_mod_scalar" \
        else _DIVISOR.astype(dtype) + np.array([0, 1, 0, 0, 0, -1], dtype)
    want = np.asarray(jops.get(op).fn(jnp.asarray(a), scalar=scalar))
    got = tops.get(op).fn(torch.from_numpy(a), scalar=scalar)
    np.testing.assert_array_equal(got.numpy(), want)


def test_int_mod_by_zero_through_nd():
    a = nd.array(_DIVIDEND.astype(np.int32), ctx=CPU, dtype="int32")
    b = nd.array(_DIVISOR.astype(np.int32), ctx=CPU, dtype="int32")
    want = np.asarray(jnp.mod(jnp.asarray(_DIVIDEND, jnp.int32),
                              jnp.asarray(_DIVISOR, jnp.int32)))
    np.testing.assert_array_equal((a % b).asnumpy(), want)
    np.testing.assert_array_equal(nd.broadcast_mod(a, b).asnumpy(), want)


# ---------------------------------------------------------------------------
# 3. softmax of an integer array
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["int32", "int64"])
@pytest.mark.parametrize("op,attrs", [("softmax", {}),
                                      ("softmax", {"axis": 0}),
                                      ("softmax", {"temperature": 2.0}),
                                      ("log_softmax", {}),
                                      ("log_softmax", {"axis": 0})])
def test_softmax_of_int_matches_jax(op, attrs, dtype):
    x = np.arange(-2, 4).reshape(2, 3).astype(dtype)
    want = np.asarray(jops.get(op).fn(jnp.asarray(x), **attrs))
    got = tops.get(op).fn(torch.from_numpy(x), **attrs)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# 4. nd.softmax with a length array by keyword
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("attrs", [{}, {"temperature": 2.0}, {"axis": -1},
                                   {"axis": -1, "temperature": 0.5}])
def test_nd_softmax_length_by_keyword_matches_jax_op(attrs):
    rng = np.random.RandomState(6)
    x = rng.uniform(-2, 2, (3, 5)).astype(np.float32)
    length = np.array([2, 5, 1], np.float32)
    want = np.asarray(jops.get("softmax").fn(
        jnp.asarray(x), length=jnp.asarray(length), **attrs))
    got = nd.softmax(nd.array(x, ctx=CPU), length=nd.array(length, ctx=CPU),
                     **attrs).asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert (got[0, 2:] == 0).all() and (got[2, 1:] == 0).all()
