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
16. An entry point's ``device=None`` / ``ctx=None`` resolves through the
    innermost ``context.scope`` (or ``with mx.cpu():``) block, then the
    card: ``ModelRepository.load(generate=True)`` under ``scope(cpu())``
    (``examples/serving/generate_lm.py:58``) builds its engine on the CPU
    (it raised "no CUDA device" here and built on the card there), as do
    `ServedLM.load`, `load_lm`, ``Predictor``, the recurrent layers and
    ``RNNModel`` (these two resolved the card at construction; they now
    take the device at ``initialize``, as the JAX package's do). Without
    a scope, the entry points still default to the card.
17. F6: ``DistributedTrainer.step`` returns an `NDArray` (a bare tensor
    before, so the census scripts' ``loss.asnumpy()`` raised), and a
    plain callable loss gets a model's whole output tuple (``loss_inputs``
    None: it got the first output only, so ``train_moe.py``'s ``lm_loss``
    could not unpack ``(logits, aux)``). Held with a two-output MoE net
    against the JAX package's trainer over a one-device mesh: the
    callable sees the tuple, and each step's ``.asnumpy()`` equals the
    JAX loss within 1e-5 relative; ``loss_inputs="pred"`` pins the first
    output, as there.
18. An initializer draws into a host buffer whatever torch's default
    device: under ``with mx.gpu(0):`` (the block
    ``examples/image_classification/train_imagenet.py:96`` initializes
    its net in) the buffer was made on the card and the CPU generator
    refused it. Held with torch's default device set to ``meta``: the
    draws equal those made without the block.
19. F8: ``MultiHeadAttention`` at batch 1 (a pipeline's microbatch of one
    sequence) flattened its (1, H, L, D) heads into a strided view, and
    the flash kernels raised on the card ("q must be contiguous"). Held
    with `pallas_kernels._FlashAttention` recording what it is handed:
    contiguous (BH, L, D) tensors, and the layer's output equal to the
    JAX layer's on the same weights.
20. F9: three names the JAX package exports were missing: ``mx.Symbol``,
    ``gluon.nn.SymbolBlock`` and ``serving.ServeRequest``. Each is now the
    port's own object of that role, as the JAX package binds its own.

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
    assert mx.cpu(0) == mx.cpu() != mx.cpu(1)
    assert str(mx.cpu(0)) == str(mx_j.cpu(0)) == "cpu(0)"
    assert mx.context.resolve_device(mx.cpu(1)) == torch.device("cpu")
    a = nd.zeros((2,), ctx=mx.cpu(0))
    assert a.context == mx.cpu(0)
    assert a._data.device == torch.device("cpu")


def test_with_device_sets_current_context_as_jax():
    from mxnet_tpu_torch import context

    with mx.cpu():
        got = nd.zeros((2,))
        assert mx.current_context() == mx.cpu()
    with mx_j.cpu():
        want = mx_j.nd.zeros((2,))
    assert str(got.context) == str(want.context) == "cpu(0)"
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    # the inner block wins, a scope or a device block (devices not
    # resolved: the card need not be present)
    with context.scope(mx.gpu(0)):
        with mx.cpu():
            assert context._innermost() == mx.cpu()
        assert context._innermost() == mx.gpu(0)
    with mx.gpu(0):
        with context.scope(mx.cpu()):
            assert context._innermost() == mx.cpu()
        assert context._innermost() == mx.gpu(0)
        with torch.device("cpu"):
            assert context._innermost() == torch.device("cpu")
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
        [[mx.cpu()]] * len(params)
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


# ---------------------------------------------------------------------------
# 16. entry points read the caller's device scope
# ---------------------------------------------------------------------------

def _lm_artifact(tmp_path):
    from mxnet_tpu_torch.gluon.model_zoo.transformer import lm_mini
    from mxnet_tpu_torch.serving import save_lm

    lm = lm_mini(vocab_size=32)
    lm.initialize(mx.init.Xavier(), ctx=CPU)
    return save_lm(lm, str(tmp_path / "lm"))


@pytest.mark.parametrize("block", ["scope", "with cpu"])
def test_generate_load_under_a_cpu_scope_builds_on_the_cpu(tmp_path, block):
    from mxnet_tpu_torch.serving import ModelRepository

    prefix = _lm_artifact(tmp_path)
    repo = ModelRepository()
    scope = mx.context.scope(CPU) if block == "scope" else mx.cpu()
    with scope:
        model = repo.load("lm", prefix, generate=True,
                          generate_opts=dict(num_pages=16, page_size=4,
                                             max_prompt=8, max_new_tokens=2,
                                             max_batch=2))
    try:
        engine = model.scheduler.engine
        assert engine.device == torch.device("cpu")
        assert all(p.device.type == "cpu" for p in engine.lm.parameters())
    finally:
        model.close(drain=False, timeout=0)


def test_entry_points_take_the_scope_then_the_card(tmp_path):
    from mxnet_tpu_torch.serving.generate import load_lm

    prefix = _lm_artifact(tmp_path)
    with mx.context.scope(CPU):
        assert mx.context.resolve_device(None) == torch.device("cpu")
        lm = load_lm(prefix)
        assert next(lm.parameters()).device.type == "cpu"
        layer = mx.gluon.rnn.LSTM(4, num_layers=1, input_size=3)
        layer.initialize()
        assert layer.l0_i2h_weight.data().context == mx.cpu()
    if not torch.cuda.is_available():
        with pytest.raises(mx.MXNetError, match="no CUDA device"):
            mx.context.resolve_device(None)
        with pytest.raises(mx.MXNetError, match="no CUDA device"):
            load_lm(prefix)
    # built without a scope, a recurrent layer takes its device at
    # initialize, as the JAX package's does
    from mxnet_tpu_torch.gluon.model_zoo.word_lm import RNNModel

    net = RNNModel(20, 8, 8, 1, dropout=0.0)
    net.initialize(ctx=CPU)
    assert all(p.device.type == "cpu" for p in net.parameters())


# ---------------------------------------------------------------------------
# 17. F6: the trainer's return type and loss inputs
# ---------------------------------------------------------------------------

def _two_output_net(gluon, MoEFFN):
    class Net(gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.embed = gluon.nn.Dense(8, flatten=False)
                self.moe = MoEFFN(units=8, hidden_size=16, num_experts=4,
                                  num_experts_per_token=2, z_loss_coef=1e-3,
                                  capacity_factor=2.0, return_aux=True)
                self.out = gluon.nn.Dense(3, flatten=False)

        def hybrid_forward(self, F, x):
            h, aux = self.moe(self.embed(x))
            return self.out(h), aux

    return Net(prefix="f6net_")


def test_trainer_step_returns_ndarray_and_feeds_the_output_tuple_f6():
    import jax

    from mxnet_tpu.gluon.contrib.moe import MoEFFN as JMoE
    from mxnet_tpu.parallel import DistributedTrainer as JTrainer
    from mxnet_tpu.parallel import make_mesh as jmake_mesh
    from mxnet_tpu_torch.gluon.contrib.moe import MoEFFN
    from mxnet_tpu_torch.parallel import DistributedTrainer

    rng = np.random.RandomState(17)
    x = rng.normal(size=(4, 5, 6)).astype(np.float32)
    y = rng.randint(0, 3, (4, 5)).astype(np.float32)
    mx_j.random.seed(17)
    jnet = _two_output_net(mx_j.gluon, JMoE)
    jnet.initialize(mx_j.init.Xavier())
    jnet(mx_j.nd.array(x))
    tnet = _two_output_net(mx.gluon, MoEFFN)
    tnet.initialize(ctx=CPU)
    with CPU:
        tnet(mx.nd.array(x))
    for name, p in tnet.collect_params().items():
        p.set_data(jnet.collect_params()[name].data().asnumpy())

    def make_loss(gluon, seen):
        sce = gluon.loss.SoftmaxCrossEntropyLoss()

        def lm_loss(out, label):
            logits, aux = out
            seen.append(len(out))
            return sce(logits, label) + 0.01 * aux

        return lm_loss

    jseen, tseen = [], []
    jtr = JTrainer(jnet, "adam", {"learning_rate": 1e-2},
                   loss=make_loss(mx_j.gluon, jseen),
                   mesh=jmake_mesh([("dp", 1)], devices=jax.devices()[:1]))
    ttr = DistributedTrainer(tnet, "adam", {"learning_rate": 1e-2},
                             loss=make_loss(mx.gluon, tseen))
    for _ in range(3):
        want = float(jtr.step(x, y).asnumpy())
        got = ttr.step(x, y)
        assert isinstance(got, mx.nd.NDArray) and got.shape == ()
        np.testing.assert_allclose(float(got.asnumpy()), want, rtol=1e-5)
    assert tseen == [2, 2, 2] and jseen
    pinned = DistributedTrainer(tnet, "sgd",
                                loss=tloss.SoftmaxCrossEntropyLoss(),
                                loss_inputs="pred")
    assert np.isfinite(pinned.step(x, y).asnumpy())
    with pytest.raises(mx.MXNetError, match="loss_inputs"):
        DistributedTrainer(tnet, "sgd", loss_inputs="all")


# ---------------------------------------------------------------------------
# 18. initializers draw on the host whatever torch's default device
# ---------------------------------------------------------------------------

def test_initializer_draws_on_the_host_under_a_device_block():
    def draws(block):
        net = tnn.HybridSequential()
        net.add(tnn.Dense(8, in_units=6), tnn.Dense(3, in_units=8))
        with block:
            net.initialize(mx.init.Xavier(), ctx=CPU, seed=3)
        return {k: v.detach().clone() for k, v in net.state_dict().items()}

    import contextlib

    want = draws(contextlib.nullcontext())
    got = draws(torch.device("meta"))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].device.type == "cpu" and torch.equal(got[k], want[k])


# ---------------------------------------------------------------------------
# 19. F8: flash attention is handed contiguous heads at batch 1
# ---------------------------------------------------------------------------

def test_attention_at_batch_one_hands_the_kernels_contiguous_heads_f8(
        monkeypatch):
    from mxnet_tpu.gluon.model_zoo import transformer as jzoo
    from mxnet_tpu_torch.gluon.model_zoo import transformer as tzoo
    from mxnet_tpu_torch.ops import pallas_kernels as tpk

    seen = []
    apply = tpk._FlashAttention.apply

    def recording(q, k, v, *rest):
        seen.append([t.is_contiguous() for t in (q, k, v)])
        return apply(q, k, v, *rest)

    monkeypatch.setattr(tpk._FlashAttention, "apply", recording)
    x = np.random.RandomState(8).normal(size=(1, 6, 8)).astype(np.float32)
    mx_j.random.seed(8)
    jatt = jzoo.MultiHeadAttention(8, 2, prefix="att_")
    jatt.initialize()
    want = jatt(mx_j.nd.array(x)).asnumpy()
    tatt = tzoo.MultiHeadAttention(8, 2, prefix="att_")
    tatt.initialize(ctx=CPU)
    for (n, a), (_, b) in zip(sorted(jatt.collect_params().items()),
                              sorted(tatt.collect_params().items())):
        b.set_data(a.data().asnumpy())
    with torch.no_grad():
        got = tatt(torch.from_numpy(x)).numpy()
    assert seen == [[True, True, True]]
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_f9_exports_name_the_jax_packages_objects():
    from mxnet_tpu.gluon import nn as jnn
    from mxnet_tpu import serving as jserving
    from mxnet_tpu_torch import gluon, serving
    from mxnet_tpu_torch.serving import batcher

    assert mx.Symbol is mx.sym.Symbol
    assert tnn.SymbolBlock is gluon.SymbolBlock
    assert serving.ServeRequest is batcher.ServeRequest
    assert "Symbol" in mx.__all__ and mx_j.Symbol is mx_j.sym.Symbol
    assert "SymbolBlock" in tnn.__all__ and hasattr(jnn, "SymbolBlock")
    assert "ServeRequest" in serving.__all__ and \
        hasattr(jserving, "ServeRequest")
