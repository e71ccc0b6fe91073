"""The vision slice's ops and layers of the PyTorch port against the JAX
package, on the CPU: the convolution and pooling cases `ops/nn.py` gained
(1-D / 3-D convolution in both layouts, transposed convolution, avg, sum
and lp pooling with a window, global max, integer max), the 12 `nn.py`
registrations the port lacked (each also reached through ``mx.nd`` and
``mx.sym``), ``clip``'s gradient at its bounds, and the gluon layers of
`gluon/nn` that use them (forward, deferred shapes and symbol forms).

The same numpy inputs, made from a seed, go through the JAX op (its
registered function under ``jax.vjp``) and the port's (under
``torch.autograd``); the gradient is that of ``sum(out * ct)`` for a
random ``ct``.

Tolerances, and why:

* f32: rtol 1e-4 with an absolute floor of 1e-4 x the largest magnitude of
  the compared tensor, as tests/test_torch_port_resnet.py states them: both
  sides compute in f32 and sum in different orders (window sums, the
  convolutions' reductions, normalization moments).
* bf16: rtol 2^-7 with a floor of 2^-7 x the largest magnitude. The JAX
  package sums a bf16 pooling window in bf16; the port accumulates it in
  f32 and rounds once, so the two can sit a few bf16 steps apart near the
  sum's rounding ties: one step is 2^-8 relative, and the floor holds the
  spread of a 9-term bf16 sum.
* integer results exactly.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
import mxnet_tpu.ops as jops
from mxnet_tpu import gluon as jgluon

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import ops as tops
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn as tnn

F32_TOL = 1e-4
BF16_TOL = 2.0 ** -7


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two torch threads while this file runs: the suite runs its files in
    parallel worker processes, where more threads a worker only contend
    for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol, what=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    floor = tol * max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(got, want, rtol=tol, atol=floor,
                               err_msg=what)


def _np(t):
    return t.detach().float().cpu().numpy()


def _run_both(name, inputs, attrs, dtype="float32", seed=0, grad=True):
    """The op ``name`` of both packages on ``inputs`` (numpy): outputs, and
    the gradients of sum(out * ct) in every floating input."""
    fl = [np.issubdtype(a.dtype, np.floating) for a in inputs]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else None
    tdt = torch.bfloat16 if dtype == "bfloat16" else None
    jin = [jnp.asarray(a, jdt) if f and jdt else jnp.asarray(a)
           for a, f in zip(inputs, fl)]
    tin = [torch.from_numpy(np.array(a)) for a in inputs]
    tin = [t.to(tdt) if f and tdt else t for t, f in zip(tin, fl)]
    jfn, tfn = jops.get(name).fn, tops.get(name).fn
    if not grad:
        return (np.asarray(jfn(*jin, **attrs).astype(jnp.float32)
                           if jnp.issubdtype(jfn(*jin, **attrs).dtype,
                                             jnp.floating)
                           else jfn(*jin, **attrs)),
                tfn(*tin, **attrs).detach().cpu()), None
    idx = [i for i, f in enumerate(fl) if f]

    def f(*diff):
        args = list(jin)
        for i, d in zip(idx, diff):
            args[i] = d
        return jfn(*args, **attrs)

    jout, pull = jax.vjp(jax.jit(f), *[jin[i] for i in idx])
    ct = np.random.RandomState(seed + 99).standard_normal(
        jout.shape).astype(np.float32)
    jgrads = pull(jnp.asarray(ct, jout.dtype))
    leaves = [tin[i].requires_grad_() for i in idx]
    tout = tfn(*tin, **attrs)
    tgrads = torch.autograd.grad(
        tout, leaves, torch.from_numpy(ct).to(tout.dtype),
        allow_unused=True)
    return (np.asarray(jout.astype(jnp.float32)), tout), \
        [(np.asarray(j.astype(jnp.float32)), t) for j, t in zip(jgrads,
                                                              tgrads)]


def _check(name, inputs, attrs, dtype="float32", seed=0, grad=True):
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    (jout, tout), grads = _run_both(name, inputs, attrs, dtype, seed, grad)
    if not np.issubdtype(np.asarray(jout).dtype, np.floating):
        np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
        return
    _close(_np(tout), jout, tol, "%s out" % name)
    for i, (j, t) in enumerate(grads or []):
        assert t is not None, (name, i)
        _close(_np(t), j, tol, "%s grad %d" % (name, i))


def _rand(seed, *shape, lo=-2.0, hi=2.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# Pooling: every case of the JAX op
# ---------------------------------------------------------------------------

# (data shape, attrs, dtype)
_POOL_CASES = [
    ((2, 3, 9, 9), dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1)),
     "float32"),
    ((2, 9, 9, 3), dict(kernel=(3, 3), stride=(2, 2),
                        pooling_convention="full", layout="NHWC"), "float32"),
    ((2, 3, 11), dict(kernel=(3,), stride=(2,), pad=(1,)), "float32"),
    ((1, 2, 5, 6, 7), dict(kernel=(2, 3, 2), stride=(2, 2, 1)), "float32"),
    # Inception's AvgPool2D(3, 1, 1), channels-last, bf16 and f32
    ((2, 8, 8, 5), dict(kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                        pool_type="avg", layout="NHWC"), "float32"),
    ((2, 8, 8, 5), dict(kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                        pool_type="avg", layout="NHWC"), "bfloat16"),
    # a last window hanging over the edge: its padding is counted
    ((2, 3, 8, 8), dict(kernel=(3, 3), stride=(2, 2), pool_type="avg",
                        pooling_convention="full"), "float32"),
    ((2, 3, 8, 8), dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                        pool_type="avg", pooling_convention="full",
                        count_include_pad=False), "float32"),
    ((2, 3, 7, 7), dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                        pool_type="avg", count_include_pad=False),
     "float32"),
    ((2, 4, 10), dict(kernel=(4,), stride=(3,), pool_type="avg",
                      layout="NWC"), "float32"),
    ((1, 5, 6, 7, 2), dict(kernel=(2, 2, 3), stride=(2, 2, 2),
                           pool_type="avg", layout="NDHWC"), "float32"),
    ((2, 3, 8, 8), dict(kernel=(2, 2), stride=(2, 2), pool_type="sum"),
     "float32"),
    ((2, 3, 8, 8), dict(kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                        pool_type="lp", p_value=2), "float32"),
    ((2, 3, 9), dict(kernel=(3,), stride=(2,), pool_type="lp", p_value=3),
     "float32"),
    ((2, 7, 7, 6), dict(global_pool=True, pool_type="max", layout="NHWC"),
     "float32"),
    ((2, 6, 9), dict(global_pool=True, pool_type="max"), "float32"),
    ((1, 2, 3, 4, 5), dict(global_pool=True, pool_type="avg"), "float32"),
    ((2, 3, 4, 4), dict(global_pool=True, pool_type="sum"), "float32"),
    ((2, 3, 4, 4), dict(global_pool=True, pool_type="lp", p_value=2),
     "float32"),
    ((2, 8, 8, 5), dict(kernel=(3, 3), stride=(2, 2), layout="NHWC"),
     "bfloat16"),
]


@pytest.mark.parametrize("shape,attrs,dtype", _POOL_CASES)
def test_pooling_matches_jax(shape, attrs, dtype):
    x = _rand(len(_POOL_CASES), *shape)
    if attrs.get("pool_type") == "lp":
        x = x + np.sign(x) * 0.5   # |x| away from 0, where lp's slope is
    _check("Pooling", [x], attrs, dtype)


@pytest.mark.parametrize("attrs", [
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1)),
    dict(kernel=(2, 2), stride=(2, 2), pool_type="sum"),
    dict(kernel=(3, 3), stride=(2, 2), pool_type="avg",
         pooling_convention="full"),
    dict(global_pool=True, pool_type="max")])
def test_integer_pooling_matches_jax(attrs):
    x = np.random.RandomState(3).randint(-50, 50, (2, 3, 7, 7)).astype(
        np.int32)
    (jout, tout), _ = _run_both("Pooling", [x], attrs, grad=False)
    assert tout.dtype == (torch.float32 if attrs.get("pool_type") == "avg"
                          else torch.int32)
    np.testing.assert_allclose(tout.float().numpy(),
                               np.asarray(jout, np.float32), rtol=1e-6)


# ---------------------------------------------------------------------------
# Convolution (1-D, 3-D) and Deconvolution
# ---------------------------------------------------------------------------

# (data shape, weight shape, attrs)
_CONV_CASES = [
    ((2, 4, 11), (6, 4, 3), dict(kernel=(3,), stride=(2,), pad=(1,))),
    ((2, 11, 4), (6, 3, 2), dict(kernel=(3,), num_group=2, dilate=(2,),
                                 layout="NWC")),
    ((1, 3, 5, 6, 7), (4, 3, 2, 3, 2), dict(kernel=(2, 3, 2), pad=(1, 0, 1),
                                            stride=(1, 2, 1))),
    ((1, 5, 6, 7, 4), (6, 3, 2, 3, 2), dict(kernel=(3, 2, 3), num_group=2,
                                            stride=(2, 1, 1), dilate=(1, 2, 1),
                                            layout="NDHWC")),
    # depthwise, channels-last (MobileNet)
    ((2, 7, 7, 6), (6, 3, 3, 1), dict(kernel=(3, 3), stride=(2, 2),
                                      pad=(1, 1), num_group=6,
                                      layout="NHWC")),
    # Inception's 1x7 and 7x1 kernels with tuple padding
    ((2, 9, 9, 4), (5, 1, 7, 4), dict(kernel=(1, 7), pad=(0, 3),
                                      layout="NHWC")),
    ((2, 4, 9, 9), (5, 4, 7, 1), dict(kernel=(7, 1), pad=(3, 0))),
]


@pytest.mark.parametrize("dshape,wshape,attrs", _CONV_CASES)
def test_convolution_matches_jax(dshape, wshape, attrs):
    x, w = _rand(1, *dshape), _rand(2, *wshape, lo=-0.5, hi=0.5)
    b = _rand(3, wshape[0])
    _check("Convolution", [x, w, b], dict(attrs, num_filter=wshape[0]))


# (data shape, weight shape, attrs): the weight (I, O/g, *k), or
# (I, *k, O/g) channels-last; a bias where no_bias is False
_DECONV_CASES = [
    ((2, 4, 5, 6), (4, 3, 3, 3), dict(kernel=(3, 3), stride=(2, 2),
                                      pad=(1, 1), adj=(1, 1))),
    ((2, 5, 6, 4), (4, 3, 3, 3), dict(kernel=(3, 3), stride=(2, 2),
                                      num_group=2, layout="NHWC",
                                      no_bias=False)),
    ((2, 4, 7), (4, 2, 4), dict(kernel=(4,), stride=(3,), pad=(1,),
                                dilate=(2,))),
    ((1, 2, 3, 4, 3), (2, 3, 2, 2, 2), dict(kernel=(2, 2, 2),
                                            stride=(2, 1, 2), no_bias=False)),
    ((2, 4, 5, 6), (4, 3, 3, 3), dict(kernel=(3, 3), stride=(2, 2),
                                      pad=(1, 1), target_shape=(10, 12))),
    # adj beyond the stride, which PyTorch's output_padding refuses
    ((1, 2, 4, 4), (2, 2, 3, 3), dict(kernel=(3, 3), stride=(1, 1),
                                      pad=(2, 2), adj=(2, 1))),
]


@pytest.mark.parametrize("dshape,wshape,attrs", _DECONV_CASES)
def test_deconvolution_matches_jax(dshape, wshape, attrs):
    no_bias = attrs.pop("no_bias", True)
    ch_last = attrs.get("layout", "").endswith("C")
    g = attrs.get("num_group", 1)
    nf = wshape[-1] * g if ch_last else wshape[1] * g
    x, w = _rand(4, *dshape), _rand(5, *wshape, lo=-0.5, hi=0.5)
    inputs = [x, w] + ([] if no_bias else [_rand(6, nf)])
    _check("Deconvolution", inputs, dict(attrs, num_filter=nf,
                                         no_bias=no_bias))
    attrs["no_bias"] = no_bias


# ---------------------------------------------------------------------------
# the 12 registrations the port lacked
# ---------------------------------------------------------------------------

def _with_zeros(x):
    x = x.copy()
    x.flat[::7] = 0.0     # the gradient at 0 takes the x >= 0 branch
    return x


_OP_CASES = {
    "LayerNorm": [
        lambda: ([_rand(7, 3, 4, 6), _rand(8, 6), _rand(9, 6)],
                 dict(eps=1e-5)),
        lambda: ([_rand(7, 3, 5, 4), _rand(8, 5), _rand(9, 5)],
                 dict(axis=1, eps=1e-3))],
    "InstanceNorm": [
        lambda: ([_rand(10, 2, 3, 5, 4), _rand(11, 3), _rand(12, 3)],
                 dict(eps=1e-3))],
    "L2Normalization": [
        lambda: ([_rand(13, 2, 3, 4, 4)], dict(mode=m))
        for m in ("instance", "channel", "spatial")],
    "LRN": [lambda: ([_rand(14, 2, 7, 3, 3)], dict(nsize=5, alpha=1e-2))],
    "LeakyReLU": [
        lambda: ([_with_zeros(_rand(15, 2, 3, 4))], dict(act_type="leaky",
                                                          slope=0.1)),
        lambda: ([_with_zeros(_rand(16, 2, 3, 4)), _rand(17, 3, lo=0.0,
                                                         hi=0.5)],
                 dict(act_type="prelu")),
        lambda: ([_with_zeros(_rand(18, 2, 3, 4))], dict(act_type="elu",
                                                          slope=0.7)),
        lambda: ([_with_zeros(_rand(19, 2, 3, 4))], dict(act_type="selu")),
        lambda: ([_rand(20, 2, 3, 4)], dict(act_type="gelu")),
        lambda: ([_with_zeros(_rand(21, 2, 3, 4))], dict(act_type="rrelu"))],
    "im2col": [lambda: ([_rand(22, 2, 3, 7, 6)],
                        dict(kernel=(3, 2), stride=(2, 1), dilate=(1, 2),
                             pad=(1, 1)))],
    "col2im": [lambda: ([_rand(23, 2, 12, 40)],
                        dict(output_size=(6, 7), kernel=(2, 2),
                             stride=(1, 1), pad=(0, 1)))],
    "softmax_cross_entropy": [
        lambda: ([_rand(24, 5, 7),
                  np.random.RandomState(25).randint(0, 7, 5).astype(
                      np.float32)], {})],
    "UpSampling": [
        lambda: ([_rand(26, 2, 3, 4, 5)], dict(scale=2)),
        lambda: ([_rand(27, 2, 3, 4, 4), _rand(28, 2, 2, 2, 2)],
                 dict(scale=2, num_args=2)),
        lambda: ([_rand(29, 2, 3, 4, 4), _rand(30, 2, 3, 8, 8)],
                 dict(scale=2, num_args=2, multi_input_mode="sum")),
        lambda: ([_rand(31, 2, 3, 4, 5)], dict(scale=3,
                                              sample_type="bilinear"))],
    "Correlation": [
        lambda: ([_rand(32, 2, 3, 7, 8), _rand(33, 2, 3, 7, 8)],
                 dict(kernel_size=1, max_displacement=2)),
        lambda: ([_rand(34, 1, 2, 9, 9), _rand(35, 1, 2, 9, 9)],
                 dict(kernel_size=3, max_displacement=2, stride1=2,
                      stride2=2, pad_size=2, is_multiply=False))],
    "IdentityAttachKLSparseReg": [lambda: ([_rand(36, 3, 4)], {})],
}


@pytest.mark.parametrize("name,case", [(n, i) for n, cs in _OP_CASES.items()
                                       for i in range(len(cs))])
def test_new_registrations_match_jax(name, case):
    inputs, attrs = _OP_CASES[name][case]()
    if name == "softmax_cross_entropy":
        # the label is an index: only the data's gradient is compared
        (jout, tout), _ = _run_both(name, inputs, attrs, grad=False)
        _close(_np(tout), jout, F32_TOL, name)
        x = torch.from_numpy(inputs[0]).requires_grad_()
        tops.get(name).fn(x, torch.from_numpy(inputs[1])).backward()
        jg = jax.grad(lambda d: jops.get(name).fn(
            d, jnp.asarray(inputs[1])))(jnp.asarray(inputs[0]))
        _close(_np(x.grad), np.asarray(jg), F32_TOL, name + " grad")
        return
    _check(name, inputs, attrs)


def test_registrations_reach_nd_and_sym():
    """Every name the JAX module registers (27, 31 with the aliases) is a
    port op, an ``mx.nd`` function and an ``mx.sym`` function; one case
    each of the new ones through ``mx.nd`` equals the JAX ``mx.nd``
    call, and composes a node of that op in ``mx.sym``."""
    import inspect
    import re

    import mxnet_tpu.ops.nn as jnn_mod

    src = inspect.getsource(jnn_mod)
    names = []
    for n, a in re.findall(r'@register\("([^"]+)"(?:, aliases=\(([^)]*)\))?',
                           src):
        names += [n] + re.findall(r'"([^"]+)"', a)
    assert len(names) == 31
    for n in names:
        tops.get(n)
        sym_ns = mx.sym.contrib if n.startswith("_contrib_") else mx.sym
        assert callable(getattr(mx.nd, n))
        assert callable(getattr(sym_ns, n.replace("_contrib_", "")))
    cpu = mx.cpu()
    for name, cases in _OP_CASES.items():
        inputs, attrs = cases[0]()
        want = getattr(jmx.nd, name)(*[jmx.nd.array(a) for a in inputs],
                                     **attrs)
        got = getattr(mx.nd, name)(*[mx.nd.array(a, ctx=cpu)
                                     for a in inputs], **attrs)
        _close(got.asnumpy(), want.asnumpy(), F32_TOL, "nd." + name)
        node = getattr(mx.sym, name)(*[mx.sym.var("v%d" % i)
                                       for i in range(len(inputs))], **attrs)
        assert name in node.tojson()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_gradient_at_the_bounds_is_jax_half(dtype):
    x = np.array([-1.0, 0.0, 3.0, 6.0, 7.0], np.float32)
    _check("clip", [x], dict(a_min=0.0, a_max=6.0), dtype)
    t = torch.tensor(x).to(getattr(torch, dtype)).requires_grad_()
    tops.get("clip").fn(t, 0.0, 6.0).sum().backward()
    assert t.grad.float().tolist() == [0.0, 0.5, 1.0, 0.5, 0.0]
    assert tops.get("clip").fn(torch.arange(-3, 9), 0, 6).tolist() == \
        [0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 6, 6]


def test_pooling_and_conv_refuse_what_the_jax_op_refuses():
    with pytest.raises(MXNetError, match="unknown pool_type"):
        tops.get("Pooling").fn(torch.zeros(1, 1, 4, 4), kernel=(2, 2),
                               pool_type="median")
    with pytest.raises(MXNetError, match="1-D, 2-D or 3-D"):
        tops.get("Convolution").fn(torch.zeros(1, 1, 2, 2, 2, 2),
                                   torch.zeros(1, 1, 1, 1, 1, 1))
    with pytest.raises(MXNetError, match="kernel attr"):
        tops.get("Convolution").fn(torch.zeros(1, 2, 5),
                                   torch.zeros(3, 2, 3), kernel=(2,))


# ---------------------------------------------------------------------------
# gluon layers
# ---------------------------------------------------------------------------

# (class name, constructor arguments, input shape)
_LAYERS = [
    ("Conv1D", dict(channels=4, kernel_size=3, strides=2, padding=1), (2, 3,
                                                                        9)),
    ("Conv3D", dict(channels=3, kernel_size=(2, 3, 2), padding=(1, 1, 0)),
     (1, 2, 4, 5, 4)),
    ("Conv1DTranspose", dict(channels=3, kernel_size=3, strides=2,
                             output_padding=1), (2, 4, 5)),
    ("Conv2DTranspose", dict(channels=4, kernel_size=3, strides=2, padding=1,
                             groups=2, layout="NHWC"), (2, 5, 5, 4)),
    ("Conv3DTranspose", dict(channels=2, kernel_size=2, strides=2),
     (1, 3, 2, 3, 2)),
    ("MaxPool1D", dict(pool_size=3, strides=2, ceil_mode=True), (2, 3, 8)),
    ("MaxPool3D", dict(pool_size=2, layout="NDHWC"), (1, 4, 4, 4, 2)),
    ("AvgPool1D", dict(pool_size=3, strides=1, padding=1), (2, 3, 7)),
    ("AvgPool2D", dict(pool_size=3, strides=2, padding=1,
                       count_include_pad=False, layout="NHWC"), (2, 7, 7,
                                                                 3)),
    ("AvgPool3D", dict(pool_size=2), (1, 2, 4, 4, 4)),
    ("GlobalMaxPool1D", {}, (2, 3, 7)),
    ("GlobalMaxPool2D", dict(layout="NHWC"), (2, 5, 5, 3)),
    ("GlobalMaxPool3D", {}, (1, 2, 3, 3, 3)),
    ("GlobalAvgPool1D", {}, (2, 3, 7)),
    ("GlobalAvgPool3D", dict(layout="NDHWC"), (1, 3, 3, 3, 2)),
    ("ReflectionPad2D", dict(padding=2), (2, 3, 5, 5)),
    ("LeakyReLU", dict(alpha=0.2), (2, 3, 4)),
    ("PReLU", {}, (2, 3, 4)),
    ("ELU", dict(alpha=0.5), (2, 3, 4)),
    ("SELU", {}, (2, 3, 4)),
    ("Swish", dict(beta=1.5), (2, 3, 4)),
    ("GELU", {}, (2, 3, 4)),
    ("InstanceNorm", dict(scale=True), (2, 3, 4, 4)),
    ("LayerNorm", dict(axis=1), (2, 5, 3)),
]


def _layer_pair(name, kwargs):
    np.random.seed(0)
    jl = getattr(jgluon.nn, name)(**kwargs)
    tl = getattr(tnn, name)(**kwargs)
    jl.initialize(jmx.init.Xavier())
    tl.initialize(mx.init.Xavier(), ctx=mx.cpu())
    return jl, tl


@pytest.mark.parametrize("name,kwargs,shape", _LAYERS,
                         ids=["%s-%d" % (n, i) for i, (n, _, _)
                              in enumerate(_LAYERS)])
def test_layers_match_jax(name, kwargs, shape):
    """Deferred shapes and the forward against the JAX layer on the JAX
    layer's weights (the ops' gradients are held above); the symbol form
    composes the JAX layer's ops."""
    jl, tl = _layer_pair(name, kwargs)
    x = _rand(40, *shape)
    jy = jl(jmx.nd.array(x))
    tl(mx.nd.array(x, ctx=mx.cpu()))   # the deferred shapes
    jparams = jl.collect_params()
    tparams = tl.collect_params()
    assert [p.shape for p in tparams.values()] == \
        [p.shape for p in jparams.values()]
    for (jn, jp), (tn, tp) in zip(jparams.items(), tparams.items()):
        assert jn.split("_", 1)[1] == tn.split("_", 1)[1]
        tp.set_data(jp.data().asnumpy())
    ty = tl(mx.nd.array(x, ctx=mx.cpu()))
    _close(ty.asnumpy(), jy.asnumpy(), F32_TOL, name)
    jsym, tsym = jl(jmx.sym.var("data")), tl(mx.sym.var("data"))
    import json

    def ops(s):
        return [n["op"] for n in json.loads(s.tojson())["nodes"]]

    assert ops(tsym) == ops(jsym)


def test_lambdas_and_dropout_axes():
    x = _rand(41, 2, 3, 4)
    tl = tnn.Lambda("relu")
    jl = jgluon.nn.Lambda("relu")
    _close(tl(mx.nd.array(x, ctx=mx.cpu())).asnumpy(),
           jl(jmx.nd.array(x)).asnumpy(), F32_TOL, "Lambda")
    _close(tl(torch.from_numpy(x)).numpy(), np.maximum(x, 0), F32_TOL,
           "Lambda on tensors")
    th = tnn.HybridLambda(lambda a: a * 2)
    _close(th(torch.from_numpy(x)).numpy(), x * 2, F32_TOL, "HybridLambda")
    th2 = tnn.HybridLambda("tanh")
    _close(th2(mx.nd.array(x, ctx=mx.cpu())).asnumpy(), np.tanh(x),
           F32_TOL, "HybridLambda by name")
    assert "tanh" in th2(mx.sym.var("data")).tojson()
    with pytest.raises(MXNetError, match="Lambda has no symbol form"):
        tl(mx.sym.var("data"))
    # Dropout(axes=...): one draw shared along the axes
    drop = tnn.Dropout(0.5, axes=(1,))
    drop.train()
    out = drop(torch.ones(64, 5, 3))
    assert torch.equal(out, out[:, :1, :].expand_as(out))
    assert set(out.unique().tolist()) <= {0.0, 2.0}
    assert "axes" in drop(mx.sym.var("data")).tojson()


def test_layer_norm_and_gelu_export_and_load_in_jax(tmp_path):
    """LayerNorm and GELU have symbol forms now: a block of them exports,
    and the JAX package's SymbolBlock computes what the port's block
    does."""
    net = tnn.HybridSequential()
    with net.name_scope():
        net.add(tnn.Dense(6, in_units=4), tnn.LayerNorm(in_channels=6),
                tnn.GELU())
    net.initialize(ctx=mx.cpu())
    x = _rand(42, 3, 4)
    want = net(mx.nd.array(x, ctx=mx.cpu())).asnumpy()
    prefix = str(tmp_path / "ln")
    net.export(prefix)
    jb = jgluon.SymbolBlock.imports(prefix + "-symbol.json", ["data"],
                                    prefix + "-0000.params")
    _close(jb(jmx.nd.array(x)).asnumpy(), want, F32_TOL, "export")
