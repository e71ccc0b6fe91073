"""Testing utilities (counterpart of `mxnet_tpu/test_utils.py`; reference:
python/mxnet/test_utils.py, SURVEY section 4). The same three oracles:

- **numeric gradients**: central finite differences of a graph against
  its bound executor's backward (`check_numeric_gradient`);
- **consistency**: the reference compared CPU and GPU kernels
  (`check_consistency`); here each dtype runs once under the naive engine
  (`engine.naive_engine`: every op synchronized as it is dispatched) and
  once without, all against the float64 naive run, with the JAX package's
  per-dtype tolerances;
- **seeded RNG**: `with_seed` seeds numpy, Python and `mx.random`, and
  prints the seed on failure so a run reproduces.

`default_context` is ``MXNET_TEST_DEVICE`` (``gpu:0``, ``cpu``) when set,
else `current_context`: the card, or the innermost ``with mx.cpu():``.
"""
from __future__ import annotations

import functools
import os
import random as _pyrandom

import numpy as np

from .context import current_context

__all__ = [
    "default_context", "set_default_context", "assert_almost_equal",
    "almost_equal", "same", "same_array", "rand_ndarray", "rand_shape_2d",
    "rand_shape_3d", "rand_shape_nd", "random_arrays", "random_sample",
    "check_numeric_gradient", "check_symbolic_forward", "check_symbolic_backward",
    "check_consistency", "numeric_grad", "simple_forward", "with_seed",
    "assert_exception", "discard_stderr", "DEFAULT_RTOL", "DEFAULT_ATOL",
]

_DEFAULT_CTX = [None]

# per-dtype default tolerances (reference: check_consistency's tol dict)
_DTYPE_TOL = {
    np.dtype(np.float64): (1e-5, 1e-7),
    np.dtype(np.float32): (1e-4, 1e-5),
    np.dtype(np.float16): (1e-2, 1e-3),
}
DEFAULT_RTOL = 1e-4
DEFAULT_ATOL = 1e-5


def default_context():
    """Context used by tests (reference: test_utils.py default_context(),
    switched by env DEV/MXNET_TEST_DEVICE)."""
    if _DEFAULT_CTX[0] is not None:
        return _DEFAULT_CTX[0]
    dev = os.environ.get("MXNET_TEST_DEVICE")
    if dev:
        from . import context as _ctx_mod

        kind, _, idx = dev.partition(":")
        return getattr(_ctx_mod, kind)(int(idx or 0))
    return current_context()


def set_default_context(ctx):
    _DEFAULT_CTX[0] = ctx


def _to_numpy(a):
    from .ndarray.ndarray import NDArray

    if isinstance(a, NDArray):
        return a.asnumpy()
    return np.asarray(a)


def same(a, b):
    return np.array_equal(_to_numpy(a), _to_numpy(b))


def same_array(array1, array2):
    """True if two NDArrays are views of the same memory (reference:
    test_utils.py same_array, which writes one and reads the other):
    the same first element, shape and strides."""
    d1 = getattr(array1, "_data", array1)
    d2 = getattr(array2, "_data", array2)
    return (d1.device == d2.device and d1.data_ptr() == d2.data_ptr()
            and d1.shape == d2.shape and d1.stride() == d2.stride())


def almost_equal(a, b, rtol=None, atol=None, equal_nan=False):
    a, b = _to_numpy(a), _to_numpy(b)
    rtol = DEFAULT_RTOL if rtol is None else rtol
    atol = DEFAULT_ATOL if atol is None else atol
    return np.allclose(a.astype(np.float64), b.astype(np.float64),
                       rtol=rtol, atol=atol, equal_nan=equal_nan)


def assert_almost_equal(a, b, rtol=None, atol=None, names=("a", "b"),
                        equal_nan=False):
    """Assert all elements close (reference: test_utils.py assert_almost_equal:
    reports max relative error and the worst-offending location)."""
    a_np, b_np = _to_numpy(a), _to_numpy(b)
    rtol = DEFAULT_RTOL if rtol is None else rtol
    atol = DEFAULT_ATOL if atol is None else atol
    if a_np.shape != b_np.shape:
        raise AssertionError("shape mismatch: %s %s vs %s %s"
                             % (names[0], a_np.shape, names[1], b_np.shape))
    af = a_np.astype(np.float64)
    bf = b_np.astype(np.float64)
    if np.allclose(af, bf, rtol=rtol, atol=atol, equal_nan=equal_nan):
        return
    denom = np.maximum(np.abs(af), np.abs(bf))
    denom[denom == 0] = 1.0
    rel = np.abs(af - bf) / denom
    rel[np.isnan(af) & np.isnan(bf)] = 0 if equal_nan else np.inf
    idx = np.unravel_index(np.argmax(rel), rel.shape)
    raise AssertionError(
        "Arrays not almost equal (rtol=%g, atol=%g): max rel err %g at %s: "
        "%s=%r vs %s=%r" % (rtol, atol, float(rel[idx]), list(idx),
                            names[0], af[idx], names[1], bf[idx]))


# --------------------------------------------------------------------------
# random data
# --------------------------------------------------------------------------

def rand_shape_2d(dim0=10, dim1=10):
    return tuple(np.random.randint(1, d + 1) for d in (dim0, dim1))


def rand_shape_3d(dim0=10, dim1=10, dim2=10):
    return tuple(np.random.randint(1, d + 1) for d in (dim0, dim1, dim2))


def rand_shape_nd(num_dim, dim=10):
    return tuple(np.random.randint(1, dim + 1, size=num_dim))


def random_sample(population, k):
    return _pyrandom.sample(list(population), k)


def rand_ndarray(shape, stype="default", density=None, dtype="float32",
                 ctx=None, distribution="uniform"):
    """Random NDArray, optionally sparse (reference: test_utils.py
    rand_ndarray / rand_sparse_ndarray)."""
    from . import ndarray as nd

    ctx = ctx or default_context()
    if distribution == "normal":
        arr = np.random.normal(size=shape)
    else:
        arr = np.random.uniform(-1.0, 1.0, size=shape)
    arr = arr.astype(dtype)
    if stype == "default":
        return nd.array(arr, ctx=ctx, dtype=dtype)
    density = 0.3 if density is None else density
    mask = np.random.uniform(0, 1, size=shape) < density
    if stype == "row_sparse":
        row_mask = mask.reshape(shape[0], -1).any(axis=1)
        arr = arr * row_mask.reshape((-1,) + (1,) * (len(shape) - 1))
    else:
        arr = arr * mask
    dense = nd.array(arr, ctx=ctx, dtype=dtype)
    return dense.tostype(stype)


def random_arrays(*shapes):
    arrays = [np.random.randn(*s).astype(np.float32) if s else
              np.array(np.random.randn(), dtype=np.float32) for s in shapes]
    if len(arrays) == 1:
        return arrays[0]
    return arrays


# --------------------------------------------------------------------------
# numeric-gradient oracle
# --------------------------------------------------------------------------

def numeric_grad(f, location, eps=1e-4):
    """Central finite differences of scalar-sum(f) wrt each location array
    (reference: test_utils.py numeric_grad)."""
    grads = {}
    loc = {k: np.array(v, dtype=np.float64) for k, v in location.items()}

    def total(vals):
        outs = f(vals)
        return sum(np.asarray(o, dtype=np.float64).sum() for o in outs)

    for name, v in loc.items():
        g = np.zeros_like(v)
        flat = v.reshape(-1)
        gflat = g.reshape(-1)
        for i in range(flat.size):
            old = flat[i]
            flat[i] = old + eps
            fp = total(loc)
            flat[i] = old - eps
            fm = total(loc)
            flat[i] = old
            gflat[i] = (fp - fm) / (2 * eps)
        grads[name] = g
    return grads


def _eval_list(sym, values, ctx=None):
    """The symbol's outputs on ``values`` (numpy arrays, each kept in its
    own dtype: a float64 run computes in float64) on ``ctx``."""
    from . import ndarray as nd

    ctx = ctx or default_context()
    outs = sym.eval(ctx=ctx, **{k: nd.array(v, ctx=ctx, dtype=v.dtype)
                                for k, v in values.items()})
    return outs if isinstance(outs, list) else [outs]


def check_numeric_gradient(sym, location, aux_states=None, numeric_eps=1e-3,
                           rtol=1e-2, atol=None, grad_nodes=None, ctx=None):
    """Finite differences vs the bound executor's backward on a Symbol
    (reference: test_utils.py check_numeric_gradient). `location`: list or
    dict of numpy arrays for the symbol's arguments."""
    from . import ndarray as nd

    ctx = ctx or default_context()
    args = sym.list_arguments()
    if isinstance(location, (list, tuple)):
        location = dict(zip(args, location))
    location = {k: np.asarray(v, dtype=np.float32) for k, v in location.items()}
    aux_states = {k: np.asarray(v, dtype=np.float32)
                  for k, v in (aux_states or {}).items()}
    grad_nodes = list(grad_nodes) if grad_nodes is not None else list(location)

    # the executor's grads of sum(outputs): bind -> forward -> backward(ones)
    arrs = {k: nd.array(v, ctx=ctx) for k, v in location.items()}
    aux = {k: nd.array(v, ctx=ctx) for k, v in aux_states.items()}
    req = {k: ("write" if k in grad_nodes else "null") for k in args}
    exe = sym.bind(ctx, args=arrs, grad_req=req, aux_states=aux)
    exe.forward(is_train=True)
    exe.backward()
    sym_grads = {k: exe.grad_dict[k].asnumpy() for k in grad_nodes}

    # numeric grads
    def f(vals):
        allv = dict(vals)
        allv.update({k: v for k, v in aux_states.items()})
        return [o.asnumpy() for o in _eval_list(sym, allv, ctx)]

    num_grads = numeric_grad(f, location, eps=numeric_eps)
    for k in grad_nodes:
        assert_almost_equal(num_grads[k], sym_grads[k], rtol=rtol,
                            atol=atol if atol is not None else rtol,
                            names=("numeric_%s" % k, "autograd_%s" % k))


def check_symbolic_forward(sym, location, expected, rtol=1e-4, atol=None,
                           aux_states=None, ctx=None):
    """Forward outputs vs expected numpy arrays (reference:
    test_utils.py check_symbolic_forward)."""
    ctx = ctx or default_context()
    args = sym.list_arguments()
    if isinstance(location, (list, tuple)):
        location = dict(zip(args, location))
    vals = {k: np.asarray(v) for k, v in location.items()}
    vals.update({k: np.asarray(v) for k, v in (aux_states or {}).items()})
    outs = _eval_list(sym, vals, ctx)
    expected = expected if isinstance(expected, (list, tuple)) else [expected]
    for o, e in zip(outs, expected):
        assert_almost_equal(o, e, rtol=rtol, atol=atol, names=("forward", "expected"))
    return [o.asnumpy() for o in outs]


def check_symbolic_backward(sym, location, out_grads, expected, rtol=1e-4,
                            atol=None, grad_req="write", aux_states=None, ctx=None):
    """Backward grads vs expected (reference: test_utils.py
    check_symbolic_backward)."""
    from . import ndarray as nd

    ctx = ctx or default_context()
    args = sym.list_arguments()
    if isinstance(location, (list, tuple)):
        location = dict(zip(args, location))
    if isinstance(expected, (list, tuple)):
        expected = dict(zip(args, expected))
    arrs = {k: nd.array(np.asarray(v), ctx=ctx) for k, v in location.items()}
    aux = {k: nd.array(np.asarray(v), ctx=ctx) for k, v in (aux_states or {}).items()}
    req = {k: (grad_req if k in expected else "null") for k in args}
    exe = sym.bind(ctx, args=arrs, grad_req=req, aux_states=aux)
    exe.forward(is_train=True)
    ograds = [nd.array(np.asarray(g), ctx=ctx) for g in
              (out_grads if isinstance(out_grads, (list, tuple)) else [out_grads])]
    exe.backward(ograds)
    for k, e in expected.items():
        assert_almost_equal(exe.grad_dict[k], e, rtol=rtol, atol=atol,
                            names=("grad_%s" % k, "expected_%s" % k))
    return {k: exe.grad_dict[k].asnumpy() for k in expected}


def check_consistency(sym, location, dtypes=("float64", "float32", "float16"),
                      tol=None, aux_states=None, ctx=None):
    """Cross-run oracle (reference: test_utils.py check_consistency runs one
    symbol across a ctx/dtype list and compares everything against the most
    precise run). Here each dtype runs twice, once under the naive engine
    (every op synchronized as it is dispatched) and once without, and every
    run is compared against the first dtype's naive run."""
    from . import engine

    ctx = ctx or default_context()
    args = sym.list_arguments()
    if isinstance(location, (list, tuple)):
        location = dict(zip(args, location))
    location = {k: np.asarray(v) for k, v in location.items()}
    aux_states = {k: np.asarray(v) for k, v in (aux_states or {}).items()}

    runs = []
    for dt in dtypes:
        for naive in (True, False):
            vals = {k: v.astype(dt) for k, v in location.items()}
            vals.update({k: v.astype(dt) for k, v in aux_states.items()})
            with engine.naive_engine(naive):
                outs = _eval_list(sym, vals, ctx)
            runs.append((dt, naive, [o.asnumpy() for o in outs]))

    ref = runs[0][2]
    for dt, naive, outs in runs[1:]:
        rtol, atol = (tol, tol) if tol is not None else _DTYPE_TOL.get(
            np.dtype(dt), (1e-2, 1e-3))
        for o, r in zip(outs, ref):
            assert_almost_equal(o, r, rtol=rtol, atol=atol,
                                names=("%s%s" % (dt, "/naive" if naive
                                                 else "/async"),
                                       "reference"))
    return ref


def simple_forward(sym, ctx=None, is_train=False, **inputs):
    """Evaluate a symbol on numpy kwargs, returning numpy (reference:
    test_utils.py simple_forward)."""
    outs = _eval_list(sym, {k: np.asarray(v) for k, v in inputs.items()},
                      ctx)
    outs = [o.asnumpy() for o in outs]
    return outs[0] if len(outs) == 1 else outs


# --------------------------------------------------------------------------
# misc
# --------------------------------------------------------------------------

def with_seed(seed=None):
    """Decorator: seed numpy/python/framework RNG per test, print the seed on
    failure (reference: tests/python/unittest/common.py with_seed)."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            this_seed = seed
            if this_seed is None:
                from . import env as _env_mod

                env = os.environ.get("MXNET_TEST_SEED") \
                    or _env_mod.raw("MXTPU_TEST_SEED")
                this_seed = int(env) if env else np.random.randint(0, 2 ** 31)
            np.random.seed(this_seed)
            _pyrandom.seed(this_seed)
            from . import random as mxrandom

            mxrandom.seed(this_seed)
            try:
                return fn(*args, **kwargs)
            except Exception:
                print("*** test failed with MXNET_TEST_SEED=%d - set this "
                      "env var to reproduce ***" % this_seed)  # allow-print
                raise

        return wrapper

    return deco


def assert_exception(f, exception_type, *args, **kwargs):
    try:
        f(*args, **kwargs)
    except exception_type:
        return
    raise AssertionError("did not raise %s" % exception_type)


class discard_stderr:
    """Context manager silencing stderr (reference: test_utils.py)."""

    def __enter__(self):
        import sys

        self._stderr = os.dup(2)
        self._devnull = os.open(os.devnull, os.O_WRONLY)
        os.dup2(self._devnull, 2)
        return self

    def __exit__(self, *exc):
        os.dup2(self._stderr, 2)
        os.close(self._devnull)
        os.close(self._stderr)
        return False
