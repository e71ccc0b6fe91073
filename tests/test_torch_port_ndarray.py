"""The port's ``mx.nd`` (`mxnet_tpu_torch.ndarray`) against the JAX
package's on the CPU: every op `mxnet_tpu/ops/tensor.py` registers, plus
``softmax`` / ``log_softmax``, on the same numpy inputs through both
``nd`` namespaces; the NDArray dunders, in-place writes and views,
indexing, the scalar-dtype and index-dtype rules, reshape codes, and
``nd.save`` / ``nd.load`` across the two packages.

Tolerances: shape, index and integer results exactly; float32 results
within 1e-6 relative, with an absolute floor of 1e-6 of the largest
magnitude (the two packages' math libraries round transcendental
functions differently by a few ulps); bfloat16 results within one bf16
rounding step (2^-7 of the larger of the two magnitudes, so a step across
a power of two counts as one). Dtypes must match, except where the port
keeps a 64-bit type that the JAX package narrows to 32 bits (README,
"int64"): there values are compared.
"""
import zlib

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu.ops as jops
import mxnet_tpu_torch as mx
from mxnet_tpu.ops.tensor import mx_reshape_shape as jax_reshape_shape
from mxnet_tpu_torch import nd
from mxnet_tpu_torch import ops as tops
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops.tensor import mx_reshape_shape

jnd = jmx.nd
CPU = mx.cpu()

F32, I32 = np.float32, np.int32


class C:
    """One case: positional inputs (numpy arrays), attrs (a numpy array
    there goes in by keyword as an NDArray), and whether the result must
    match exactly."""

    def __init__(self, inputs, exact=False, **attrs):
        self.inputs, self.attrs, self.exact = inputs, attrs, exact


def _u(r, shape, lo=-2.0, hi=2.0, dtype=F32):
    return r.uniform(lo, hi, shape).astype(dtype)


def _i(r, shape, lo=0, hi=5, dtype=I32):
    return r.randint(lo, hi, shape).astype(dtype)


def _bf(a):
    """``a`` marked to go in as bfloat16 (the cast happens per package)."""
    return ("bf16", a)


_BINARY = ["add", "sub", "mul", "div", "mod", "power", "maximum", "minimum",
           "hypot", "equal", "not_equal", "greater", "greater_equal",
           "lesser", "lesser_equal", "logical_and", "logical_or",
           "logical_xor"]
_COMPARE = {"equal", "not_equal", "greater", "greater_equal", "lesser",
            "lesser_equal", "logical_and", "logical_or", "logical_xor"}


def _binary_cases(n, r):
    if n in _COMPARE:
        a, b = _i(r, (3, 4), 0, 3).astype(F32), _i(r, (3, 4), 0, 3).astype(F32)
        return [C([a, b], exact=True)]
    a, b = _u(r, (3, 4)), _u(r, (3, 4))
    if n == "power":
        a = _u(r, (3, 4), 0.5, 2.0)
    if n == "mod":
        b = _u(r, (3, 4), 0.5, 2.0) * np.sign(_u(r, (3, 4)))
    cases = [C([a, b])]
    if n == "add":
        cases.append(C([a[:, :1], b[:1, :]]))
    if n in ("add", "mod", "div"):
        cases.append(C([_i(r, (3, 4), -4, 5), _i(r, (3, 4), 1, 5)],
                       exact=n != "div"))
    if n in ("add", "mul"):
        cases.append(C([_bf(a), _bf(b)]))
    return cases


_SCALAR = ["_%s_scalar" % n for n in _BINARY] + [
    "_plus_scalar", "_minus_scalar", "_rminus_scalar", "_rdiv_scalar",
    "_rpower_scalar", "_rmod_scalar"]


_INT_SCALAR = {"plus", "minus", "rminus", "mul", "div", "rdiv", "mod",
               "power", "equal", "maximum"}


def _scalar_cases(n, r):
    base = n[1:-len("_scalar")]
    exact = base in _COMPARE
    a = _u(r, (3, 4))
    s = 0.7
    if base in ("power", "rdiv", "rmod"):
        a = _u(r, (3, 4), 0.5, 2.0)
    if base == "power":
        s = 1.5
    if base == "rpower":
        s = 2.0
    cases = [C([a], exact=exact, scalar=s)]
    if base in _INT_SCALAR:
        # the scalar-dtype rule: an int32 array stays int32, the scalar is
        # cast to int32 first
        cases.append(C([_i(r, (3, 4), 1, 6)],
                       exact=base not in ("div", "rdiv"), scalar=2.7))
    if base in ("plus", "mul"):
        cases.append(C([_bf(a)], scalar=s))
    return cases


_POS = (0.1, 3.0)
_UNIT = (-0.9, 0.9)
_UNARY_DOMAIN = {"sqrt": _POS, "rsqrt": _POS, "log": _POS, "log10": _POS,
                 "log2": _POS, "log1p": _POS, "rcbrt": _POS,
                 "reciprocal": _POS, "arcsin": _UNIT, "arccos": _UNIT,
                 "arctanh": _UNIT, "erfinv": _UNIT, "arccosh": (1.1, 3.0),
                 "gamma": (0.5, 3.0), "gammaln": (0.5, 3.0),
                 "digamma": (0.5, 3.0)}
_UNARY = ["abs", "sign", "rint", "round", "ceil", "floor", "trunc", "fix",
          "square", "sqrt", "rsqrt", "cbrt", "rcbrt", "exp", "log", "log10",
          "log2", "log1p", "expm1", "sin", "cos", "tan", "arcsin", "arccos",
          "arctan", "sinh", "cosh", "tanh", "arcsinh", "arccosh", "arctanh",
          "sigmoid", "softsign", "relu", "reciprocal", "negative", "degrees",
          "radians", "erf", "erfinv", "gamma", "gammaln", "digamma",
          "logical_not", "identity"]
_EXACT_UNARY = {"abs", "sign", "rint", "round", "ceil", "floor", "trunc",
                "fix", "relu", "negative", "logical_not", "identity"}
_INT_UNARY = {"abs", "sign", "ceil", "relu", "logical_not", "square"}
_BF16_UNARY = {"exp", "tanh", "sqrt"}


def _unary_cases(n, r):
    lo, hi = _UNARY_DOMAIN.get(n, (-2.0, 2.0))
    a = _u(r, (3, 4), lo, hi)
    if n in ("round", "rint"):   # half to even
        a = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 2.4], F32)
    cases = [C([a], exact=n in _EXACT_UNARY)]
    if n in _INT_UNARY:
        cases.append(C([_i(r, (3, 4), -4, 5)], exact=True))
    if n in _BF16_UNARY:
        cases.append(C([_bf(a)]))
    return cases


_REDUCE = ["sum", "mean", "prod", "max", "min", "nansum", "nanprod",
           "sum_axis"]


def _reduce_cases(n, r):
    a = _u(r, (2, 3, 4), 0.5, 1.5)
    if n.startswith("nan"):
        a[0, 1, 2] = a[1, 0, 0] = np.nan
    cases = [C([a], axis=(0, 2), keepdims=True),
             C([a], axis=1, exclude=True)]
    if n in ("sum", "mean"):
        cases.append(C([_i(r, (2, 3, 4), -3, 4)], exact=n != "mean",
                       axis=2))
    return cases


def _build_specs():
    specs = {}
    for n in _BINARY:
        specs["elemwise_" + n] = lambda r, n=n: _binary_cases(n, r)
    for n in _SCALAR:
        specs[n] = lambda r, n=n: _scalar_cases(n, r)
    for n in _UNARY:
        specs[n] = lambda r, n=n: _unary_cases(n, r)
    for n in _REDUCE:
        specs[n] = lambda r, n=n: _reduce_cases(n, r)
    x234 = lambda r: _u(r, (2, 3, 4))  # noqa: E731
    x34 = lambda r: _u(r, (3, 4))  # noqa: E731
    seq = lambda r: _u(r, (4, 3, 2))  # noqa: E731
    lens = np.array([1, 4, 2], F32)
    ids = np.array([[0, 4, 2], [1, 3, 0]], F32)
    idx2 = np.array([[0, 2, 1, 2, 0], [3, 0, 1, 2, 1]], I32)
    specs.update({
        "add_n": lambda r: [C([x34(r), x34(r), x34(r)])],
        "hard_sigmoid": lambda r: [C([x34(r)], alpha=0.3, beta=0.4)],
        "ravel_multi_index": lambda r: [
            C([idx2], exact=True, shape=(3, 4)),
            C([idx2.astype(F32)], exact=True, shape=(3, 4))],
        "unravel_index": lambda r: [
            C([np.array([0, 5, 11, 7, 3], I32)], exact=True, shape=(3, 4))],
        "BlockGrad": lambda r: [C([x34(r)], exact=True)],
        "Cast": lambda r: [C([x34(r)], exact=True, dtype="int32"),
                           C([x34(r)], exact=True, dtype="float16"),
                           C([x34(r)], exact=True, dtype="bfloat16"),
                           C([_i(r, (3, 4))], exact=True, dtype="float32")],
        "clip": lambda r: [C([x34(r)], exact=True, a_min=-0.5, a_max=0.7)],
        "norm": lambda r: [C([x34(r)]), C([x34(r)], ord=1, axis=1,
                                          keepdims=True),
                           C([x234(r)], axis=(0, 2))],
        "argmax": lambda r: [C([x34(r)], exact=True, axis=1),
                             C([x34(r)], exact=True),
                             C([x34(r)], exact=True, axis=0, keepdims=True),
                             C([_i(r, (3, 4), 0, 100)], exact=True, axis=1)],
        "argmin": lambda r: [C([x34(r)], exact=True, axis=1),
                             C([x34(r)], exact=True)],
        "argmax_channel": lambda r: [C([x34(r)], exact=True)],
        "dot": lambda r: [C([x34(r), _u(r, (4, 5))]),
                          C([_u(r, (4, 3)), _u(r, (4, 5))], transpose_a=True),
                          C([x34(r), _u(r, (5, 4))], transpose_b=True),
                          C([_u(r, (4,)), _u(r, (4,))]),
                          C([x234(r), _u(r, (4, 2))])],
        "batch_dot": lambda r: [C([x234(r), _u(r, (2, 4, 5))]),
                                C([x234(r), _u(r, (2, 5, 4))],
                                  transpose_b=True)],
        "Reshape": lambda r: [C([x234(r)], exact=True, shape=s)
                              for s in ((0, -1), (-3, 0), (-4, 1, 2, 0, 0),
                                        (-2,), (6, 4))] + [
            C([x234(r)], exact=True, shape=(-1, 0), reverse=True)],
        "Flatten": lambda r: [C([x234(r)], exact=True)],
        "transpose": lambda r: [C([x234(r)], exact=True),
                                C([x234(r)], exact=True, axes=(1, 0, 2))],
        "expand_dims": lambda r: [C([x34(r)], exact=True, axis=1),
                                  C([x34(r)], exact=True, axis=-1)],
        "squeeze": lambda r: [C([_u(r, (1, 3, 1))], exact=True),
                              C([_u(r, (1, 3, 1))], exact=True, axis=0)],
        "SwapAxis": lambda r: [C([x234(r)], exact=True, dim1=0, dim2=2)],
        "reverse": lambda r: [C([x34(r)], exact=True, axis=1),
                              C([x34(r)], exact=True, axis=(0, 1))],
        "tile": lambda r: [C([x34(r)], exact=True, reps=(2, 1)),
                           C([x34(r)], exact=True, reps=(2, 1, 3))],
        "repeat": lambda r: [C([x34(r)], exact=True, repeats=2, axis=1),
                             C([x34(r)], exact=True, repeats=3)],
        "Pad": lambda r: [
            C([_u(r, (1, 2, 3, 3))], exact=True, mode=m,
              pad_width=(0, 0, 0, 0, 1, 2, 2, 1), constant_value=0.5)
            for m in ("constant", "edge", "reflect")],
        "Concat": lambda r: [C([x34(r), _u(r, (3, 2))], exact=True, dim=1),
                             C([x34(r), x34(r), x34(r)], exact=True, dim=0)],
        "stack": lambda r: [C([x34(r), x34(r)], exact=True, axis=1)],
        "SliceChannel": lambda r: [
            C([_u(r, (2, 6))], exact=True, num_outputs=3, axis=1),
            C([x34(r)], exact=True, num_outputs=3, axis=0,
              squeeze_axis=True)],
        "slice": lambda r: [
            C([_u(r, (4, 5))], exact=True, begin=(0, 1), end=(2, 3)),
            C([_u(r, (4, 5))], exact=True, begin=(1, None), end=(4, None),
              step=(2, -1)),
            C([_u(r, (4, 5))], exact=True, begin=(3,), end=(0,), step=(-1,))],
        "slice_axis": lambda r: [
            C([_u(r, (4, 5))], exact=True, axis=1, begin=1, end=3),
            C([_u(r, (4, 5))], exact=True, axis=0, begin=-2, end=None)],
        "slice_like": lambda r: [C([_u(r, (4, 5)), _u(r, (2, 3))],
                                   exact=True),
                                 C([_u(r, (4, 5)), _u(r, (2, 3))],
                                   exact=True, axes=(1,))],
        "space_to_depth": lambda r: [
            C([_u(r, (1, 2, 4, 4))], exact=True, block_size=2),
            C([_u(r, (1, 4, 4, 2))], exact=True, block_size=2,
              layout="NHWC")],
        "depth_to_space": lambda r: [C([_u(r, (1, 8, 2, 2))], exact=True,
                                       block_size=2)],
        "broadcast_to": lambda r: [C([_u(r, (3, 1))], exact=True,
                                     shape=(3, 4)),
                                   C([_u(r, (3, 1))], exact=True,
                                     shape=(0, 4))],
        "broadcast_like": lambda r: [C([_u(r, (1, 4)), x34(r)], exact=True)],
        "broadcast_axis": lambda r: [C([_u(r, (3, 1))], exact=True, axis=1,
                                       size=4)],
        "take": lambda r: [
            C([_u(r, (5, 3)), np.array([-1, 6, 2, 0], F32)], exact=True),
            C([_u(r, (5, 3)), np.array([[-1, 6], [2, 4]], F32)], exact=True,
              mode="wrap"),
            C([_u(r, (5, 3)), np.array([2, 0], I32)], exact=True, axis=1)],
        "batch_take": lambda r: [
            C([x34(r), np.array([0, 5, 2], F32)], exact=True),
            C([x34(r), np.array([1, 0, 3], F32)], exact=True,
              keepdims=True)],
        "Embedding": lambda r: [C([ids, _u(r, (5, 4))], exact=True,
                                  input_dim=5, output_dim=4)],
        "one_hot": lambda r: [
            C([np.array([-1, 0, 2, 7, 4], F32)], exact=True, depth=5),
            C([np.array([1, 3], I32)], exact=True, depth=4, on_value=2.0,
              off_value=-1.0, dtype="int32")],
        "gather_nd": lambda r: [C([x34(r), idx2[:, :3] % 3], exact=True)],
        "scatter_nd": lambda r: [
            C([_u(r, (3,)), np.array([[0, 2, 1], [3, 0, 2]], I32)],
              exact=True, shape=(3, 4))],
        "_scatter_set_nd": lambda r: [
            C([x34(r), _u(r, (3,)), np.array([[0, 2, 1], [3, 0, 2]], I32)],
              exact=True, shape=(3, 4))],
        "where": lambda r: [
            C([_i(r, (3, 4), 0, 2).astype(F32), x34(r), x34(r)], exact=True),
            C([np.array([1, 0, 1], F32), x34(r), x34(r)], exact=True)],
        "sort": lambda r: [C([_u(r, (3, 5))], exact=True),
                           C([_u(r, (3, 5))], exact=True, is_ascend=False),
                           C([_u(r, (3, 5))], exact=True, axis=0)],
        "argsort": lambda r: [C([_u(r, (3, 5))], exact=True),
                              C([_u(r, (3, 5))], exact=True, is_ascend=False,
                                dtype="int32"),
                              C([_u(r, (3, 5))], exact=True, axis=0)],
        "topk": lambda r: [
            C([_u(r, (3, 5))], exact=True, k=2, ret_typ=t, is_ascend=asc,
              axis=ax)
            for t, asc, ax in (("indices", False, -1), ("value", True, 0),
                               ("both", True, -1), ("mask", False, 0))],
        "shape_array": lambda r: [C([x234(r)], exact=True)],
        "size_array": lambda r: [C([x234(r)], exact=True)],
        "zeros_like": lambda r: [C([x34(r)], exact=True)],
        "ones_like": lambda r: [C([_i(r, (3, 4))], exact=True)],
        "_zeros": lambda r: [C([], exact=True, shape=(2, 3), dtype="int32")],
        "_ones": lambda r: [C([], exact=True, shape=(2, 3))],
        "_full": lambda r: [C([], exact=True, shape=(2, 3), value=0.7),
                            C([], exact=True, shape=(2,), value=0.7,
                              dtype="int32")],
        "_arange": lambda r: [C([], exact=True, start=2, stop=11, step=3,
                                repeat=2),
                              C([], exact=True, start=5),
                              C([], exact=True, start=0, stop=6,
                                dtype="int32")],
        "_linspace": lambda r: [C([], start=0.0, stop=1.0, num=5),
                                C([], start=-1.0, stop=2.0, num=4,
                                  endpoint=False)],
        "_eye": lambda r: [C([], exact=True, N=3, M=4, k=1),
                           C([], exact=True, N=3, k=-1, dtype="int32")],
        "diag": lambda r: [C([_u(r, (3,))], exact=True, k=1),
                           C([x34(r)], exact=True, k=-1)],
        "SequenceMask": lambda r: [
            C([seq(r), lens], exact=True, use_sequence_length=True,
              value=-1.0),
            C([_u(r, (3, 4, 2)), lens], exact=True, use_sequence_length=True,
              axis=1),
            C([seq(r)], exact=True)],
        "SequenceLast": lambda r: [
            C([seq(r), lens], exact=True, use_sequence_length=True),
            C([seq(r)], exact=True)],
        "SequenceReverse": lambda r: [
            C([seq(r), lens], exact=True, use_sequence_length=True),
            C([seq(r)], exact=True)],
        "smooth_l1": lambda r: [C([x34(r)], scalar=1.5)],
        "khatri_rao": lambda r: [C([_u(r, (2, 3)), _u(r, (4, 3))])],
        "histogram": lambda r: [C([_u(r, (20,))], bin_cnt=5),
                                C([_u(r, (20,))], bin_cnt=4,
                                  range=(-1.0, 1.0))],
        "softmax": lambda r: [
            C([_u(r, (3, 5))], temperature=2.0), C([x234(r)], axis=1)],
        "log_softmax": lambda r: [C([_u(r, (3, 5))]),
                                  C([_u(r, (3, 5))], temperature=0.5)],
    })
    return specs


SPECS = _build_specs()

# index-valued outputs the reference types as int64: the port keeps
# int64, the JAX package narrows to int32 (README, "int64")
_INT64_OUTPUTS = {"shape_array", "size_array", "histogram"}


def _jax_tensor_ops():
    names = [n for n, op in jops._REGISTRY.items()
             if op.fn.__module__ == "mxnet_tpu.ops.tensor"]
    return names, sorted({jops._REGISTRY[n].name for n in names})


def _to_pair(v):
    """(JAX NDArray, port NDArray) holding the same values."""
    if isinstance(v, tuple) and v[0] == "bf16":
        return (jnd.array(v[1], dtype="bfloat16"),
                nd.array(v[1], ctx=CPU, dtype="bfloat16"))
    return (jnd.array(v, dtype=v.dtype), nd.array(v, ctx=CPU, dtype=v.dtype))


def _compare(name, got, want, exact):
    got_np = got.asnumpy()
    want_np = np.asarray(want.asnumpy(), dtype=np.float32) \
        if str(want.dtype) == "bfloat16" else want.asnumpy()
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if name in _INT64_OUTPUTS and got.dtype == np.int64:
        assert want.dtype == np.int32, (name, want.dtype)
    else:
        assert str(got.dtype) == str(want.dtype), (name, got.dtype,
                                                   want.dtype)
    if exact or got.dtype.kind in "iub" if hasattr(got.dtype, "kind") \
            else exact:
        np.testing.assert_array_equal(got_np, want_np, err_msg=name)
    elif str(got.dtype) == "bfloat16":
        step = np.maximum(np.abs(got_np), np.abs(want_np)) * 2.0 ** -7
        assert (np.abs(got_np - want_np) <= step).all(), name
    else:
        floor = 1e-6 * float(np.nanmax(np.abs(want_np), initial=0.0))
        np.testing.assert_allclose(got_np, want_np, rtol=1e-6, atol=floor,
                                   err_msg=name)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_op_matches_jax(name):
    """Each registered op, through ``mxnet_tpu.nd`` and the port's
    ``nd``, on every case of its spec."""
    rng = np.random.RandomState(zlib.crc32(name.encode()))
    for case in SPECS[name](rng):
        pairs = [_to_pair(v) for v in case.inputs]
        kw = {k: _to_pair(v) if isinstance(v, np.ndarray) else (v, v)
              for k, v in case.attrs.items()}
        want = getattr(jnd, name)(*[p[0] for p in pairs],
                                  **{k: v[0] for k, v in kw.items()})
        got = getattr(nd, name)(*[p[1] for p in pairs],
                                **{k: v[1] for k, v in kw.items()},
                                **({} if pairs else {"ctx": CPU}))
        if isinstance(want, list):
            assert isinstance(got, list) and len(got) == len(want), name
        else:
            want, got = [want], [got]
        for g, w in zip(got, want):
            _compare(name, g, w, case.exact)


def test_softmax_length_matches_jax_op():
    """``softmax``'s ``length`` mask, op against op: through either
    package's generated ``nd.softmax`` the optional ``temperature`` slot
    takes the length array (ROADMAP, queue 3)."""
    import jax.numpy as jnp

    x = _u(np.random.RandomState(6), (3, 5))
    length = np.array([2, 5, 1], F32)
    want = jops.get("softmax").fn(jnp.asarray(x), axis=-1, temperature=2.0,
                                  length=jnp.asarray(length))
    got = tops.get("softmax").fn(torch.from_numpy(x), axis=-1,
                                 temperature=2.0,
                                 length=torch.from_numpy(length))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    assert (got.numpy()[0, 2:] == 0).all()


def test_registry_holds_every_jax_tensor_op_under_its_aliases():
    """157 ops under 228 names from ops/tensor.py, plus softmax and
    log_softmax, the 17 updates of ops/optimizer_ops.py under 19 names, and
    the layers, loss heads and RNN ops the symbolic path registers (the
    26 other ops of ops/nn.py under 30 names, with the fused BatchNorm ops
    that `HybridBlock.export` writes, 3 of ops/rnn.py), and the 4 image
    ops of ops/image_ops.py under 8 names; each alias resolves to the op
    its JAX alias names."""
    names, primaries = _jax_tensor_ops()
    assert (len(names), len(primaries)) == (228, 157)
    opt = sorted(n for n, o in jops._REGISTRY.items()
                 if o.fn.__module__ == "mxnet_tpu.ops.optimizer_ops")
    assert len(opt) == 19
    assert len({jops._REGISTRY[n].name for n in opt}) == 17
    layers = ["FullyConnected", "Convolution", "Pooling", "BatchNorm",
              "Activation", "Dropout", "SoftmaxOutput", "Softmax",
              "LinearRegressionOutput", "LogisticRegressionOutput",
              "MAERegressionOutput", "MakeLoss", "make_loss", "RNN",
              "_rnn_state_zeros", "_rnn_fused_state_zeros", "BatchNormRelu",
              "_contrib_BatchNormRelu", "BatchNormAddRelu",
              "_contrib_BatchNormAddRelu", "Deconvolution", "LayerNorm",
              "InstanceNorm", "L2Normalization", "LRN", "LeakyReLU",
              "im2col", "col2im", "softmax_cross_entropy", "UpSampling",
              "Correlation", "IdentityAttachKLSparseReg"]
    image = sorted(n for n, o in jops._REGISTRY.items()
                   if o.fn.__module__ == "mxnet_tpu.ops.image_ops")
    assert len(image) == 8
    assert sorted(tops.list_ops()) == sorted(names + opt + layers + image + [
        "softmax", "log_softmax"])
    for n in opt + layers + image:
        assert tops.get(n).name == jops._REGISTRY[n].name, n
        assert callable(getattr(nd, n))
    assert sorted(SPECS) == sorted(primaries + ["softmax", "log_softmax"])
    for n in names:
        assert tops.get(n).name == jops._REGISTRY[n].name, n
        assert tops.get(n) is tops.get(tops.get(n).name), n
        assert callable(getattr(nd, n)) and callable(getattr(nd.op, n))


_DUNDERS = ["__add__", "__radd__", "__sub__", "__rsub__", "__mul__",
            "__rmul__", "__truediv__", "__rtruediv__", "__mod__",
            "__rmod__", "__pow__", "__rpow__", "__eq__", "__ne__", "__gt__",
            "__ge__", "__lt__", "__le__"]


@pytest.mark.parametrize("dunder", _DUNDERS)
def test_binary_dunders_match_jax(dunder):
    """With an NDArray, a Python scalar and a numpy array on the other
    side, on float32 and int32 arrays."""
    rng = np.random.RandomState(1)
    for a, b in ((_u(rng, (3, 4), 0.5, 2.0), _u(rng, (3, 4), 0.5, 2.0)),
                 (_i(rng, (3, 4), 1, 5), _i(rng, (3, 4), 1, 5))):
        ja, ta = _to_pair(a)
        jb, tb = _to_pair(b)
        sc = 0.7 if a.dtype == F32 else 2.7
        for jo, to in ((jb, tb), (sc, sc), (b, b)):
            if dunder.startswith("__r") and isinstance(jo, jnd.NDArray):
                continue
            if dunder in ("__eq__", "__ne__") and isinstance(jo, np.ndarray):
                continue   # NotImplemented in both: numpy's own == runs
            want = getattr(ja, dunder)(jo)
            got = getattr(ta, dunder)(to)
            _compare(dunder, got, want, a.dtype == I32 and dunder not in (
                "__truediv__", "__rtruediv__"))


@pytest.mark.parametrize("dunder", ["__iadd__", "__isub__", "__imul__",
                                    "__itruediv__"])
def test_inplace_dunders_write_into_the_array(dunder):
    """``x op= y`` keeps the object and its storage, so a view taken
    before sees the write; the values are the JAX package's."""
    rng = np.random.RandomState(2)
    a, b = _u(rng, (3, 4), 0.5, 2.0), _u(rng, (3, 4), 0.5, 2.0)
    ja, ta = _to_pair(a)
    jb, tb = _to_pair(b)
    for jo, to in ((jb, tb), (0.7, 0.7)):
        view = ta[1:3]
        ptr = ta._data.data_ptr()
        jres, tres = getattr(ja, dunder)(jo), getattr(ta, dunder)(to)
        assert tres is ta and ta._data.data_ptr() == ptr
        _compare(dunder, ta, jres, False)
        np.testing.assert_array_equal(view.asnumpy(), ta.asnumpy()[1:3])
        ja = jres


def test_unary_dunders_and_matmul_match_jax():
    rng = np.random.RandomState(3)
    a, b = _u(rng, (3, 4)), _u(rng, (4, 2))
    ja, ta = _to_pair(a)
    jb, tb = _to_pair(b)
    _compare("neg", -ta, -ja, True)
    _compare("abs", abs(ta), abs(ja), True)
    _compare("matmul", ta @ tb, ja @ jb, False)


def test_scalar_dtype_rule_keeps_the_array_dtype():
    """int32 + 0.7 stays int32 (the scalar is cast to int32 first), as in
    the JAX package; PyTorch alone would promote to float."""
    x = np.arange(6, dtype=I32)
    jx, tx = _to_pair(x)
    for f in (lambda v: v + 0.7, lambda v: 0.7 + v, lambda v: v * 2.9,
              lambda v: v - 1.5, lambda v: v / 2.5):
        _compare("scalar rule", f(tx), f(jx), True)
    assert (tx + 0.7).dtype == np.int32
    np.testing.assert_array_equal((tx + 0.7).asnumpy(), x)
    assert (tx / 2.5).dtype == np.float32   # true division by int32 2


def test_argmax_positions_are_float32():
    x = _u(np.random.RandomState(4), (3, 4))
    jx, tx = _to_pair(x)
    for f in (lambda v: v.argmax(axis=1), lambda v: v.argmin(),
              lambda v: jnd.argmax_channel(v) if isinstance(v, jnd.NDArray)
              else nd.argmax_channel(v)):
        assert f(tx).dtype == np.float32
        _compare("argmax", f(tx), f(jx), True)


@pytest.mark.parametrize("spec,reverse", [
    ((0, -1), False), ((-1, 0), True), ((-2,), False), ((-3, -2), False),
    ((-4, 2, -1, -2), False), ((-4, -1, 3, 0, 0), False), ((2, 0, -1), True),
    ((0, -3), False), ((-3, 5), False)])
def test_reshape_codes_match_jax(spec, reverse):
    """The magic codes 0, -1, -2, -3, -4 and reverse, on the shape
    function and through ``NDArray.reshape`` (a view in the port)."""
    shape = (6, 3, 5)
    assert mx_reshape_shape(shape, spec, reverse) == \
        jax_reshape_shape(shape, spec, reverse)
    x = np.arange(90, dtype=F32).reshape(shape)
    jx, tx = _to_pair(x)
    got = tx.reshape(spec, reverse=reverse)
    _compare("reshape", got, jx.reshape(spec, reverse=reverse), True)
    assert got._data.data_ptr() == tx._data.data_ptr()


_KEYS = [1, slice(1, 3), (1, 2), (slice(None), 1), Ellipsis,
         (slice(0, 3, 2), slice(1, None))]


@pytest.mark.parametrize("key", range(len(_KEYS)))
def test_getitem_and_setitem_match_jax(key):
    """Indexing with ints, slices, tuples, Ellipsis and an NDArray; each
    key also assigned a scalar, an NDArray and a numpy array."""
    key = _KEYS[key]
    x = np.arange(20, dtype=F32).reshape(4, 5)
    jx, tx = _to_pair(x)
    _compare("getitem", tx[key], jx[key], True)
    shape = np.empty((4, 5))[key].shape
    for val in (7.5, np.full(shape, -2.0, F32)):
        jx[key] = val
        tx[key] = val
        _compare("setitem", tx, jx, True)
    jv, tv = _to_pair(np.full(shape, 9.0, F32))
    jx[key] = jv
    tx[key] = tv
    _compare("setitem", tx, jx, True)


def test_ndarray_index_and_views():
    x = np.arange(20, dtype=F32).reshape(4, 5)
    jx, tx = _to_pair(x)
    ji, ti = _to_pair(np.array([3, 0, 2], F32))
    _compare("getitem", tx[ti], jx[ji], True)
    jx[ji] = 1.0
    tx[ti] = 1.0
    _compare("setitem", tx, jx, True)
    # basic first-axis indexing is a view, as in the reference; a strided
    # or column index is a copy, so every NDArray stays contiguous
    row, col = tx[1], tx[:, 1]
    tx += 1
    np.testing.assert_array_equal(row.asnumpy(), tx.asnumpy()[1])
    assert col._data.is_contiguous()
    np.testing.assert_array_equal(col.asnumpy(), tx.asnumpy()[:, 1] - 1)
    # an op's output never shares its input's storage
    t = nd.transpose(tx)
    f = nd.identity(tx)
    tx[:] = 0
    assert t.asnumpy().any() and f.asnumpy().any()


def test_out_copyto_and_detach_write_in_place():
    x = nd.array(np.ones((2, 3)), ctx=CPU)
    y = nd.zeros((2, 3), ctx=CPU)
    view = y.detach()
    ptr = y._data.data_ptr()
    assert nd.elemwise_add(x, x, out=y) is y
    assert y._data.data_ptr() == ptr
    np.testing.assert_array_equal(view.asnumpy(), np.full((2, 3), 2.0))
    nd.ones((2, 3), ctx=CPU).copyto(y)
    np.testing.assert_array_equal(view.asnumpy(), np.ones((2, 3)))
    z = y.copyto(CPU)
    assert z is not y and z._data.data_ptr() != ptr


def test_save_and_load_cross_between_packages(tmp_path):
    """nd.save in one package and nd.load in the other, both ways: same
    container, same keys, same values and dtypes; the JAX package's
    bfloat16 (raw 16-bit void in the npz) loads in the port as bfloat16."""
    rng = np.random.RandomState(5)
    arrays = {"w": _u(rng, (3, 4)), "i": _i(rng, (5,)),
              "h": _u(rng, (2, 2)).astype(np.float16),
              "b": _i(rng, (4,)).astype(np.int8),
              "u": _i(rng, (4,)).astype(np.uint8)}
    jpath, tpath = str(tmp_path / "jax.params"), str(tmp_path / "port.params")
    jnd.save(jpath, {k: jnd.array(v, dtype=v.dtype) for k, v in arrays.items()})
    nd.save(tpath, {k: nd.array(v, ctx=CPU, dtype=v.dtype)
                    for k, v in arrays.items()})
    for got, want in ((nd.load(jpath, ctx=CPU), jnd.load(jpath)),
                      (jnd.load(tpath), nd.load(tpath, ctx=CPU))):
        assert sorted(got) == sorted(want) == sorted(arrays)
        for k in arrays:
            assert str(got[k].dtype) == str(want[k].dtype) == \
                str(arrays[k].dtype)
            np.testing.assert_array_equal(got[k].asnumpy(), arrays[k])
    # lists come back as lists, in order
    nd.save(tpath, [nd.array(v, ctx=CPU, dtype=v.dtype)
                    for v in arrays.values()])
    for got in (jnd.load(tpath), nd.load(tpath, ctx=CPU)):
        assert [a.asnumpy().tolist() for a in got] == \
            [v.tolist() for v in arrays.values()]
    bf = _u(rng, (3,))
    jnd.save(jpath, [jnd.array(bf, dtype="bfloat16")])
    got = nd.load(jpath, ctx=CPU)[0]
    assert got.dtype == "bfloat16"
    np.testing.assert_array_equal(
        got.asnumpy(), np.asarray(jnd.array(bf, dtype="bfloat16").asnumpy(),
                                  np.float32))
    with open(tpath, "wb") as f:
        f.write(b"PK\x03\x04 truncated")
    with pytest.raises(MXNetError, match="truncated or corrupt"):
        nd.load(tpath, ctx=CPU)


def test_int64_kept_where_jax_narrows():
    """The port's one deliberate dtype divergence: 64-bit arrays stay
    64-bit, as in the reference; the values agree."""
    x = np.array([2 ** 40, -3, 7], np.int64)
    assert nd.array(x, ctx=CPU, dtype="int64").dtype == np.int64
    small = np.array([5, -3, 7], np.int64)
    jx, tx = _to_pair(small)
    assert (jx.dtype, tx.dtype) == (np.int32, np.int64)
    np.testing.assert_array_equal((tx * 2).asnumpy(), (jx * 2).asnumpy())
    assert nd.shape_array(tx).dtype == np.int64


def test_default_context_is_the_card(monkeypatch):
    """Without a card, arrays with no ctx raise; ``ctx=mx.cpu()`` or a
    ``context.scope`` asks for the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: nd.zeros((2,)), lambda: nd.array([1.0]),
                 lambda: nd.arange(3), lambda: nd.eye(2),
                 lambda: nd.ones((1,)), lambda: mx.current_context()):
        with pytest.raises(MXNetError, match="device='cpu'"):
            make()
    with mx.context.scope(mx.cpu()):
        assert mx.current_context() == CPU
        assert nd.zeros((2,)).context == CPU
        assert nd.arange(3).context == CPU
    with pytest.raises(MXNetError):
        nd.zeros((2,))


def test_dlpack_shares_memory_and_autograd_is_not_ported():
    t = torch.arange(4, dtype=torch.int32)
    x = nd.from_dlpack(t)
    assert x.dtype == np.int32 and x._data.data_ptr() == t.data_ptr()
    back = torch.utils.dlpack.from_dlpack(nd.to_dlpack_for_write(x))
    back += 10
    np.testing.assert_array_equal(x.asnumpy(), [10, 11, 12, 13])
    # autograd is ported now: an integer array has no gradient, and a float
    # one shared through DLPack takes one over the same storage
    with pytest.raises(MXNetError, match="no gradient"):
        x.attach_grad()
    f = nd.from_dlpack(torch.arange(4, dtype=torch.float32))
    f.attach_grad()
    from mxnet_tpu_torch import autograd

    with autograd.record():
        y = (f * f).sum()
    y.backward()
    np.testing.assert_array_equal(f.grad.asnumpy(), [0, 2, 4, 6])
