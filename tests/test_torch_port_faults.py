"""Faults of the port against the JAX package, each held at the input that
showed it, on the CPU:

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
5. ``nd.take(x, idx, axis=-1)`` takes along the last axis (it raised).
6. ``nd.sort`` / ``nd.argsort`` with ``axis=None`` sort the flattened array
   (they raised).
7. ``nd.topk`` puts the lower index first among equal values, as
   ``lax.top_k``, both ways, and its mask marks what the JAX package's
   stable argsort picks.
8. NDArray indexing with a negative step reads and writes numpy's elements
   (it raised).
9. ``SoftmaxCrossEntropyLoss`` clips a label outside [0, K) as ``pick``
   does (it raised).
10. ``NDArray.detach`` cuts the array from the graph.
11. A bound graph's ops with no array input (``_zeros``, ``_ones``,
    ``_full``, ``_arange``) put their outputs on the executor's device, as
    the JAX package's land on the current context; they took torch's
    default device, so a graph bound on the card mixed devices. Held here
    with torch's default device set to ``meta`` while a CPU executor runs
    (on the card in ``test_torch_port_cuda.py``), from a fresh thread.

12. ``context``: ``cpu(0)`` takes the reference's device id (it raised);
    ``with mx.cpu():`` and ``with mx.gpu(0):`` set what `current_context`
    returns, whichever of that block and a `context.scope` is the inner
    one (the block entered torch's device context, which
    `current_context` never read); every zoo factory and ``get_model``
    build on the ``ctx`` they are given (they dropped it and resolved the
    card).
13. A layer's ``weight``, ``bias``, ``gamma``, ``beta``, ``running_mean``,
    ``running_var`` and ``alpha`` are its gluon Parameters (they were
    tensors): ``lr_mult`` and ``grad_req`` set there reach the Trainer,
    and ``data()`` returns the array.
14. ResNet v1 and the transformer zoo are `HybridBlock`s built as the JAX
    package builds them: names, ``.params`` files both ways, a forward on
    NDArrays, ``export`` (ResNet; the transformer blocks refuse it in both
    packages), ``initialize(init, ctx=)`` and the pretrained message.
15. ``HybridSequential`` slicing gives a container of the same type (the
    slice was passed as a prefix).

Float results within 1e-6 relative and absolute (both sides compute in f32
from the same inputs); integer results and shapes exactly. A whole net's
output (14) within 1e-5 of its largest magnitude: the two packages'
convolutions and GEMMs sum in other orders.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx_j
import mxnet_tpu.ops as jops
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, nd
from mxnet_tpu_torch.gluon import loss as tloss
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


# ---------------------------------------------------------------------------
# 5. take along axis -1
# ---------------------------------------------------------------------------

_X234 = np.arange(24, dtype=np.float32).reshape(2, 3, 4)


@pytest.mark.parametrize("mode", ["clip", "wrap"])
@pytest.mark.parametrize("idx", [[1, 0], [[0, 2], [1, -1]]])
@pytest.mark.parametrize("axis", [-1, -2, -3])
def test_take_negative_axis_matches_jax(axis, idx, mode):
    i = np.array(idx, np.float32)
    want = mx_j.nd.take(mx_j.nd.array(_X234), mx_j.nd.array(i), axis=axis,
                        mode=mode).asnumpy()
    got = nd.take(nd.array(_X234, ctx=CPU), nd.array(i, ctx=CPU), axis=axis,
                  mode=mode).asnumpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# 6. sort / argsort of the flattened array
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["sort", "argsort"])
@pytest.mark.parametrize("is_ascend", [True, False])
def test_sort_axis_none_matches_jax(op, is_ascend):
    x = np.random.RandomState(5).permutation(24).astype(np.float32) \
        .reshape(2, 3, 4)
    want = getattr(mx_j.nd, op)(mx_j.nd.array(x), axis=None,
                                is_ascend=is_ascend).asnumpy()
    got = getattr(nd, op)(nd.array(x, ctx=CPU), axis=None,
                          is_ascend=is_ascend).asnumpy()
    assert got.shape == want.shape == (24,)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# 7. topk among equal values
# ---------------------------------------------------------------------------

_TIES = np.array([[1, 3, 3, 3, 0, 3], [2, 2, 2, 2, 2, 2]], np.float32)


def _ties_wide(dtype):
    rng = np.random.RandomState(7)
    return rng.randint(0, 4, (2, 120)).astype(np.float32), dtype


@pytest.mark.parametrize("ret_typ", ["indices", "value", "both", "mask"])
@pytest.mark.parametrize("is_ascend", [False, True])
@pytest.mark.parametrize("case", ["ties", "wide-float32", "wide-bfloat16"])
def test_topk_ties_match_jax(case, is_ascend, ret_typ):
    x, dtype = (_TIES, "float32") if case == "ties" \
        else _ties_wide(case.split("-")[1])
    k = 2 if case == "ties" else 7
    want = mx_j.nd.topk(mx_j.nd.array(x, dtype=dtype), k=k,
                        ret_typ=ret_typ, is_ascend=is_ascend)
    got = nd.topk(nd.array(x, ctx=CPU, dtype=dtype), k=k, ret_typ=ret_typ,
                  is_ascend=is_ascend)
    want = want if isinstance(want, list) else [want]
    got = got if isinstance(got, list) else [got]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.asnumpy(), w.asnumpy())
    if case == "ties" and ret_typ == "indices" and not is_ascend:
        np.testing.assert_array_equal(got[0].asnumpy(), [[1, 2], [0, 1]])


# ---------------------------------------------------------------------------
# 8. negative steps in NDArray indexing
# ---------------------------------------------------------------------------

_X453 = np.arange(60, dtype=np.float32).reshape(4, 5, 3)
_NEG_KEYS = [slice(None, None, -1), (slice(None), slice(None, None, -2)),
             slice(3, 1, -1), (Ellipsis, slice(None, None, -1)),
             (1, slice(4, None, -3), None), (slice(2, None, -1), 0),
             slice(0, 2, -1)]


@pytest.mark.parametrize("key", _NEG_KEYS, ids=repr)
def test_negative_step_read_matches_jax(key):
    want = mx_j.nd.array(_X453)[key].asnumpy()
    got = nd.array(_X453, ctx=CPU)[key].asnumpy()
    np.testing.assert_array_equal(want, _X453[key])
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("key", _NEG_KEYS[:4], ids=repr)
def test_negative_step_write_matches_jax(key):
    value = -1 - np.arange(_X453[key].size, dtype=np.float32) \
        .reshape(_X453[key].shape)
    j = mx_j.nd.array(_X453)
    j[key] = mx_j.nd.array(value)
    t = nd.array(_X453, ctx=CPU)
    t[key] = nd.array(value, ctx=CPU)
    np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())


# ---------------------------------------------------------------------------
# 9. SoftmaxCrossEntropyLoss with labels outside [0, K)
# ---------------------------------------------------------------------------

def test_softmax_ce_clips_labels_as_jax():
    pred = np.random.RandomState(9).normal(size=(4, 5)).astype(np.float32)
    label = np.array([-1, 1, 2, 5], np.float32)
    want = mx_j.gluon.loss.SoftmaxCrossEntropyLoss()(
        mx_j.nd.array(pred), mx_j.nd.array(label)).asnumpy()
    got = tloss.SoftmaxCrossEntropyLoss()(
        nd.array(pred, ctx=CPU), nd.array(label, ctx=CPU)).asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    clipped = tloss.SoftmaxCrossEntropyLoss()(
        nd.array(pred, ctx=CPU), nd.array([0, 1, 2, 4], ctx=CPU)).asnumpy()
    np.testing.assert_array_equal(got, clipped)


# ---------------------------------------------------------------------------
# 10. detach stops the gradient
# ---------------------------------------------------------------------------

def test_detach_stops_the_gradient():
    x = nd.array([1.0, 2.0, 3.0], ctx=CPU)
    x.attach_grad()
    with autograd.record():
        y = x * x
        z = (y.detach() * x + y).sum()
    z.backward()
    # d/dx (y_const * x + x^2) = y + 2x, with y = x^2 held constant
    np.testing.assert_allclose(x.grad.asnumpy(), [3.0, 8.0, 15.0])
    assert not y.detach()._data.requires_grad
    jx = mx_j.nd.array([1.0, 2.0, 3.0])
    jx.attach_grad()
    with mx_j.autograd.record():
        jy = jx * jx
        jz = (jy.detach() * jx + jy).sum()
    jz.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), jx.grad.asnumpy())


# ---------------------------------------------------------------------------
# 11. ops with no array input, in a bound graph
# ---------------------------------------------------------------------------

def _creation_graph(m):
    data = m.sym.var("data")
    return m.sym.Group([
        data + m.sym.zeros((2, 3)), data * m.sym.ones((2, 3)),
        m.sym.broadcast_add(data, m.sym.arange(3)),
        data + m.sym._full(shape=(2, 3), value=1.5)])


def test_creation_ops_take_the_executors_device():
    import threading

    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    want = [o.asnumpy() for o in _creation_graph(mx_j).eval(
        data=mx_j.nd.array(x))]
    got = []

    def run():
        exe = _creation_graph(mx).bind(
            CPU, {"data": nd.array(x, ctx=CPU)}, grad_req="null")
        torch.set_default_device("meta")
        try:
            got.extend(o.asnumpy() for o in exe.forward(is_train=False))
        finally:
            torch.set_default_device(None)

    t = threading.Thread(target=run)
    t.start()
    t.join(30)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# 12. devices: cpu(0), `with mx.cpu():`, the zoo's ctx
# ---------------------------------------------------------------------------

def test_cpu_takes_the_reference_device_id():
    assert mx.cpu(0) == mx.cpu() == torch.device("cpu")
    assert str(mx_j.cpu(0)) == "cpu(0)"
    a = nd.zeros((2,), ctx=mx.cpu(0))
    assert a.context == torch.device("cpu")


def test_with_device_sets_current_context_as_jax():
    from mxnet_tpu_torch import context

    with mx.cpu():
        got = nd.zeros((2,))
        assert mx.current_context() == torch.device("cpu")
    with mx_j.cpu():
        want = mx_j.nd.zeros((2,))
    assert got.context.type == "cpu" and str(want.context) == "cpu(0)"
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    # the inner block wins, a scope or a device block (devices not
    # resolved: the card need not be present)
    with context.scope(mx.gpu(0)):
        with mx.cpu():
            assert context._innermost() == torch.device("cpu")
        assert context._innermost() == torch.device("cuda", 0)
    with mx.gpu(0):
        with context.scope(mx.cpu()):
            assert context._innermost() == torch.device("cpu")
        assert context._innermost() == torch.device("cuda", 0)
    assert context._innermost() is None


@pytest.mark.parametrize("name", ["alexnet", "vgg11", "squeezenet1.0",
                                  "densenet121", "inceptionv3",
                                  "mobilenet0.25", "mobilenetv2_0.25",
                                  "resnet18_v1", "resnet18_v2"])
def test_zoo_builds_on_the_ctx_it_is_given(name):
    from mxnet_tpu.gluon.model_zoo import vision as jvision
    from mxnet_tpu_torch.gluon.model_zoo import vision

    net = vision.get_model(name, ctx=mx.cpu(), classes=10)
    # (several JAX factories take no ctx; its default context is the host)
    jnet = jvision.get_model(name, classes=10)
    net.initialize()
    params = net.collect_params()
    assert [p.list_ctx() for p in params.values()] == \
        [[torch.device("cpu")]] * len(params)
    assert sorted(k.split("_", 1)[1] for k in params) == \
        sorted(k.split("_", 1)[1] for k in jnet.collect_params())


# ---------------------------------------------------------------------------
# 13. layer parameter attributes
# ---------------------------------------------------------------------------

def _dense_step(pkg, attr, value):
    """A Dense(2, in_units=3) of ones, ``attr`` of its weight set, one SGD
    step at lr 1 on sum(d(ones((1, 3)))): the weight after."""
    d = pkg.gluon.nn.Dense(2, in_units=3)
    d.initialize(pkg.init.One(), ctx=pkg.cpu())
    setattr(d.weight, attr, value)
    trainer = pkg.gluon.Trainer(d.collect_params(), "sgd",
                                {"learning_rate": 1.0})
    x = pkg.nd.ones((1, 3), ctx=pkg.cpu())
    with pkg.autograd.record():
        y = d(x).sum()
    y.backward()
    trainer.step(1)
    return d.weight.data().asnumpy()


@pytest.mark.parametrize("attr,value,expect", [("lr_mult", 0.1, 0.9),
                                               ("grad_req", "null", 1.0)])
def test_layer_parameter_attributes_reach_the_trainer_as_jax(attr, value,
                                                             expect):
    want = _dense_step(mx_j, attr, value)
    got = _dense_step(mx, attr, value)
    np.testing.assert_allclose(want, expect, rtol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_layer_attributes_are_parameters():
    from mxnet_tpu_torch.gluon.parameter import Parameter

    layers = {"dense": (tnn.Dense(2, in_units=3), ("weight", "bias")),
              "conv": (tnn.Conv2D(2, 3, in_channels=1), ("weight", "bias")),
              "bn": (tnn.BatchNorm(in_channels=2),
                     ("gamma", "beta", "running_mean", "running_var")),
              "prelu": (tnn.PReLU(), ("alpha",)),
              "embed": (tnn.Embedding(5, 2), ("weight",)),
              "ln": (tnn.LayerNorm(2), ("gamma", "beta"))}
    for name, (layer, attrs) in layers.items():
        layer.initialize(ctx=CPU)
        for a in attrs:
            p = getattr(layer, a)
            assert isinstance(p, Parameter), (name, a)
            assert p is layer.collect_params()[layer.prefix + a]
            assert p.data()._data is layer._held(a), (name, a)
    x = nd.array(np.arange(6, dtype=np.float32).reshape(2, 3), ctx=CPU)
    dense = layers["dense"][0]
    want = x.asnumpy() @ dense.weight.data().asnumpy().T \
        + dense.bias.data().asnumpy()
    np.testing.assert_allclose(dense(x).asnumpy(), want, rtol=1e-6)
    np.testing.assert_allclose(dense(x._data).detach().numpy(), want,
                               rtol=1e-6)
    assert tnn.Dense(2, in_units=3, use_bias=False).bias is None


# ---------------------------------------------------------------------------
# 14. ResNet v1 and the transformer zoo as HybridBlocks
# ---------------------------------------------------------------------------

def _same_weights(jnet, net):
    from mxnet_tpu_torch import convert

    params = {k: p.data().asnumpy() for k, p in
              jnet.collect_params().items()}
    net.load_state_dict(convert.vision_params_from_jax(params, net),
                        strict=True)


def _net_close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("fused", [False, True])
def test_resnet18_v1_save_load_export_as_jax(tmp_path, fused):
    from mxnet_tpu.gluon.model_zoo import vision as jvision
    from mxnet_tpu_torch.gluon import SymbolBlock
    from mxnet_tpu_torch.gluon.model_zoo import vision

    np.random.seed(0)
    jnet = jvision.resnet18_v1(classes=10, fuse_epilogue=fused)
    jnet.initialize(mx_j.init.Xavier(), ctx=mx_j.cpu())
    x = np.random.RandomState(1).randn(2, 3, 32, 32).astype(np.float32)
    want = jnet(mx_j.nd.array(x)).asnumpy()
    net = vision.resnet18_v1(classes=10, fuse_epilogue=fused, ctx=CPU)
    assert isinstance(net, mx.gluon.HybridBlock)
    assert sorted(net._collect_params_with_prefix()) == \
        sorted(jnet._collect_params_with_prefix())
    _same_weights(jnet, net)
    xn = nd.array(x, ctx=CPU)
    _net_close(net(xn).asnumpy(), want, "forward")
    # the port's file back into the port, and the JAX package's file
    net.save_parameters(str(tmp_path / "t.params"))
    jnet.save_parameters(str(tmp_path / "j.params"))
    for f in ("t.params", "j.params"):
        again = vision.resnet18_v1(classes=10, fuse_epilogue=fused, ctx=CPU)
        again.load_parameters(str(tmp_path / f), ctx=CPU)
        _net_close(again(xn).asnumpy(), want, f)
    again.hybridize()
    again.export(str(tmp_path / "net"))
    sb = SymbolBlock.imports(str(tmp_path / "net-symbol.json"), ["data"],
                             str(tmp_path / "net-0000.params"), ctx=CPU)
    _net_close(sb(xn).asnumpy(), want, "export")
    jsb = mx_j.gluon.SymbolBlock.imports(str(tmp_path / "net-symbol.json"),
                                         ["data"],
                                         str(tmp_path / "net-0000.params"))
    _net_close(jsb(mx_j.nd.array(x)).asnumpy(), want, "export in JAX")


def test_resnet_pretrained_names_load_parameters_as_jax():
    from mxnet_tpu.gluon.model_zoo import vision as jvision
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.gluon.model_zoo import vision

    with pytest.raises(Exception, match="load_parameters"):
        jvision.resnet18_v1(pretrained=True)
    with pytest.raises(MXNetError, match="load_parameters"):
        vision.resnet18_v1(pretrained=True)
    assert callable(vision.ResNetV1.load_parameters)


def _lm_pair(tmp_path, make, jmake, **kw):
    """The JAX net, its `.params` file, and the port's net with it loaded
    (names and child paths are the JAX package's)."""
    np.random.seed(3)
    jnet = jmake(vocab_size=50, **kw)
    jnet.initialize(mx_j.init.Xavier(), ctx=mx_j.cpu())
    ids = np.random.RandomState(4).randint(0, 50, (2, 6)).astype(np.int32)
    jout = jnet(mx_j.nd.array(ids, dtype="int32"))
    jnet.save_parameters(str(tmp_path / "j.params"))
    net = make(vocab_size=50, **kw)
    net.initialize(mx.init.Xavier(), ctx=CPU)
    assert sorted(k.split("_", 1)[1] for k in net.collect_params()) == \
        sorted(k.split("_", 1)[1] for k in jnet.collect_params())
    net.load_parameters(str(tmp_path / "j.params"), ctx=CPU)
    return jnet, net, ids, jout


def test_transformer_lm_initialize_ctx_save_load_as_jax(tmp_path):
    """examples/serving/generate_lm.py:51's call, then the JAX LM's file
    in the port, a save -> load round trip, and export refused in both."""
    from mxnet_tpu.gluon.model_zoo import transformer as jtr
    from mxnet_tpu_torch.gluon.model_zoo import transformer as ttr

    jnet, net, ids, jout = _lm_pair(tmp_path, ttr.lm_mini, jtr.lm_mini)
    _net_close(net(nd.array(ids, ctx=CPU, dtype="int32")).asnumpy(),
               jout.asnumpy(), "lm_mini")
    net.save_parameters(str(tmp_path / "t.params"))
    again = ttr.lm_mini(vocab_size=50).initialize(mx.init.Xavier(),
                                                  ctx=mx.cpu())
    again.load_parameters(str(tmp_path / "t.params"), ctx=CPU)
    _net_close(again(torch.from_numpy(ids)).detach().numpy(),
               jout.asnumpy(), "lm_mini reloaded")
    with pytest.raises(Exception):
        jnet.export(str(tmp_path / "j"))
    with pytest.raises(Exception):
        again.export(str(tmp_path / "t"))


def test_bert_mini_loads_the_jax_file(tmp_path):
    from mxnet_tpu.gluon.model_zoo import transformer as jtr
    from mxnet_tpu_torch.gluon.model_zoo import transformer as ttr

    jnet, net, ids, jout = _lm_pair(tmp_path, ttr.bert_mini, jtr.bert_mini,
                                    dropout=0.0)
    seq, pooled = net(nd.array(ids, ctx=CPU, dtype="int32"))
    _net_close(seq.asnumpy(), jout[0].asnumpy(), "bert_mini sequence")
    _net_close(pooled.asnumpy(), jout[1].asnumpy(), "bert_mini pooled")
    assert len(net.encoder.cells) == 2


# ---------------------------------------------------------------------------
# 15. HybridSequential slicing
# ---------------------------------------------------------------------------

def test_sequential_slice_matches_jax():
    out = {}
    for pkg in (mx_j, mx):
        net = pkg.gluon.nn.HybridSequential()
        net.add(pkg.gluon.nn.Dense(4, in_units=3),
                pkg.gluon.nn.Dense(2, in_units=4))
        net.initialize(pkg.init.One(), ctx=pkg.cpu())
        tail = net[1:]
        assert type(tail) is type(net) and len(tail) == 1
        assert tail.prefix == net.prefix
        assert list(tail._children.values()) == [net[1]] == [net[-1]]
        out[pkg] = tail(pkg.nd.ones((1, 4), ctx=pkg.cpu())).asnumpy()
    np.testing.assert_array_equal(out[mx], out[mx_j])
