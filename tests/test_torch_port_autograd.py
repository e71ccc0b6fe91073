"""`mxnet_tpu_torch.autograd` and the NDArray autograd surface against the
JAX package's, on the CPU.

The same numpy inputs (from a seed) go through both packages' ``nd`` ops
under ``autograd.record()``; the outputs and every variable's gradient
must agree: a set of ops (elementwise, broadcast, ``dot``, reductions,
indexing, ``softmax``), ``grad_req`` write / add / null, head gradients,
``retain_graph``, a second-order ``grad``, ``pause``, a custom
``Function`` and an in-place write after a recorded use. Tolerance: f32
rtol 1e-4 with an absolute floor of 1e-4 x max|want| (both compute in f32,
summing in other orders).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, nd
from mxnet_tpu_torch.base import MXNetError

TOL = 1e-4
PKGS = {"jax": jmx, "torch": mx}


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.context.scope(mx.cpu()):
        yield


def _close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    floor = TOL * float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=TOL, atol=floor, err_msg=what)


def _inputs(seed, *shapes):
    rng = np.random.RandomState(seed)
    return [rng.uniform(-1.5, 1.5, s).astype(np.float32) for s in shapes]


# (name, function of (F, x, y), x shape, y shape)
_OPS = [
    ("elementwise", lambda F, x, y: F.exp(x) * y + F.tanh(x) / (y * y + 1),
     (3, 4), (3, 4)),
    ("broadcast", lambda F, x, y: F.broadcast_mul(F.broadcast_add(x, y), x)
     - F.broadcast_div(y, F.sigmoid(x) + 1), (3, 4), (1, 4)),
    ("dot", lambda F, x, y: F.dot(x, y, transpose_b=True) * 2.0,
     (3, 4), (5, 4)),
    ("reductions", lambda F, x, y: F.sum(x * x, axis=1) + F.max(y, axis=1)
     + F.mean(x * y, axis=1), (3, 4), (3, 4)),
    ("indexing", lambda F, x, y: F.broadcast_sub(
        F.slice_axis(x, axis=0, begin=1, end=3)
        * F.take(y, F.array([2.0, 0.0]), axis=0)
        + F.slice_axis(F.reverse(x, axis=0), axis=0, begin=0, end=2),
        F.pick(F.slice_axis(y, axis=0, begin=0, end=2), F.array([1.0, 3.0]),
               axis=1, keepdims=True)), (3, 4), (3, 4)),
    ("softmax", lambda F, x, y: F.log_softmax(x, axis=-1) * y
     + F.softmax(y, axis=0), (3, 4), (3, 4)),
]


def _run(pkg, fn, arrays, reqs, head_grad=None, repeat=1):
    xs = [pkg.nd.array(a) for a in arrays]
    for x, req in zip(xs, reqs):
        x.attach_grad(req)
    for _ in range(repeat):
        with pkg.autograd.record():
            out = fn(pkg.nd, *xs)
        out.backward(None if head_grad is None else pkg.nd.array(head_grad))
    return out.asnumpy(), [x.grad.asnumpy() for x in xs]


@pytest.mark.parametrize("name,fn,xs,ys", _OPS, ids=[o[0] for o in _OPS])
@pytest.mark.parametrize("reqs", [("write", "write"), ("add", "write"),
                                  ("write", "null")])
def test_ops_gradients_match_jax(name, fn, xs, ys, reqs):
    arrays = _inputs(hash(name) % 1000, xs, ys)
    # add: two backwards accumulate; write: the second overwrites
    want = _run(jmx, fn, arrays, reqs, repeat=2)
    got = _run(mx, fn, arrays, reqs, repeat=2)
    _close(got[0], want[0], name + " out")
    for i, (g, w) in enumerate(zip(got[1], want[1])):
        _close(g, w, "%s grad %d (%s)" % (name, i, reqs[i]))
    if reqs[1] == "null":
        assert not got[1][1].any()


@pytest.mark.parametrize("name,fn,xs,ys", _OPS[:4],
                         ids=[o[0] for o in _OPS[:4]])
def test_head_gradient_matches_jax(name, fn, xs, ys):
    arrays = _inputs(11, xs, ys)
    shape = fn(jmx.nd, *[jmx.nd.array(a) for a in arrays]).shape
    head = np.random.RandomState(12).normal(size=shape).astype(np.float32)
    want = _run(jmx, fn, arrays, ("write", "write"), head)
    got = _run(mx, fn, arrays, ("write", "write"), head)
    for g, w in zip(got[1], want[1]):
        _close(g, w, name)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_retain_graph(pkg):
    p = PKGS[pkg]
    x = p.nd.array([1.0, 2.0, 3.0])
    x.attach_grad("add")
    with p.autograd.record():
        y = (x * x).sum()
    y.backward(retain_graph=True)
    y.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), [4.0, 8.0, 12.0])
    if pkg == "torch":
        # the graph is freed: the port raises, as the reference does (the
        # JAX package's tape, with nothing left, writes nothing)
        with pytest.raises(MXNetError, match="freed"):
            y.backward()


def _second_order(p):
    x = p.nd.array([0.5, -1.0, 2.0])
    x.attach_grad()
    with p.autograd.record():
        y = x * x * x + p.nd.sin(x)
        g = p.autograd.grad([y], [x], create_graph=True)[0]
        z = (g * g).sum()
    z.backward()
    return g.asnumpy(), x.grad.asnumpy()


def test_second_order_grad_matches_jax():
    want, got = _second_order(jmx), _second_order(mx)
    _close(got[0], want[0], "first order")
    _close(got[1], want[1], "second order")
    x = np.array([0.5, -1.0, 2.0])
    _close(got[1], 2 * (3 * x * x + np.cos(x)) * (6 * x - np.sin(x)),
           "closed form")


def test_grad_leaves_the_buffers_alone():
    x = nd.array([1.0, 2.0])
    x.attach_grad()
    buf = x.grad
    with autograd.record():
        y = (x * 3).sum()
    (g,) = autograd.grad([y], [x])
    np.testing.assert_array_equal(g.asnumpy(), [3.0, 3.0])
    assert not buf.asnumpy().any()
    y.backward()
    # the buffer taken before the backward sees the new values
    np.testing.assert_array_equal(buf.asnumpy(), [3.0, 3.0])


def _paused(p):
    x, w = p.nd.array([1.0, 2.0, 3.0]), p.nd.array([0.5, 0.5, 2.0])
    x.attach_grad()
    w.attach_grad()
    with p.autograd.record():
        with p.autograd.pause():
            c = x * w     # not recorded: a constant below
            inner = (p.autograd.is_recording(), p.autograd.is_training())
        z = (c * x + w * w).sum()
    z.backward()
    return inner, x.grad.asnumpy(), w.grad.asnumpy()


def test_pause_matches_jax():
    want, got = _paused(jmx), _paused(mx)
    assert got[0] == want[0] == (False, False)
    _close(got[1], want[1], "x")
    _close(got[2], want[2], "w")


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_scope_flags(pkg):
    ag = PKGS[pkg].autograd
    assert (ag.is_recording(), ag.is_training()) == (False, False)
    with ag.record():
        assert (ag.is_recording(), ag.is_training()) == (True, True)
        with ag.predict_mode():
            assert ag.is_training() is False
    with ag.record(train_mode=False):
        assert (ag.is_recording(), ag.is_training()) == (True, False)
        with ag.train_mode():
            assert ag.is_training()
    assert ag.set_recording(True) is False
    assert ag.set_recording(False) is True
    assert ag.set_training(True) is False
    assert ag.set_training(False) is True


def _sigmoid_fn(p):
    class Sigmoid(p.autograd.Function):
        def forward(self, x):
            y = 1 / (1 + p.nd.exp(-x))
            self.save_for_backward(y)
            return y

        def backward(self, dy):
            (y,) = self.saved_tensors
            return dy * y * (1 - y) * 3.0   # scaled: the custom one counts

    x = p.nd.array([-1.0, 0.0, 0.5, 2.0])
    x.attach_grad()
    with p.autograd.record():
        y = Sigmoid()(x)
        z = (y * x).sum()
    z.backward()
    return y.asnumpy(), x.grad.asnumpy()


def test_custom_function_matches_jax():
    want, got = _sigmoid_fn(jmx), _sigmoid_fn(mx)
    _close(got[0], want[0], "forward")
    _close(got[1], want[1], "backward")


def _inplace_after_use(p):
    x = p.nd.array([1.0, 2.0, 3.0])
    x.attach_grad()
    with p.autograd.record():
        y = x * x
        z = (y * x).sum()
    x[:] = 10.0          # the variable written after its recorded use
    z.backward()
    return z.asnumpy(), x.grad.asnumpy(), x.asnumpy()


def test_inplace_write_after_recorded_use_matches_jax():
    want, got = _inplace_after_use(jmx), _inplace_after_use(mx)
    for g, w, what in zip(got, want, ("z", "grad", "x")):
        _close(g, w, what)
    # d/dx x^3 = 3x^2 at the recorded x
    _close(got[1], [3.0, 12.0, 27.0], "closed form")


def test_inplace_write_to_a_recorded_output_stays_on_the_tape():
    """``y += 1`` inside record() is part of the graph, as in the reference
    (the JAX package's tape loses the write and treats y as a constant)."""
    x = nd.array([1.0, 2.0, 3.0])
    x.attach_grad()
    with autograd.record():
        y = x * x
        y += 1
        y[0] = y[0] * 2
        z = (y * x).sum()
    z.backward()
    want = 3 * np.array([1.0, 2.0, 3.0]) ** 2 + 1
    want[0] = 2 * want[0]
    _close(x.grad.asnumpy(), want, "d/dx (x^2 + 1) x, first element doubled")


def test_ndarray_indexing_is_recorded():
    """Basic and negative-step indexing are recorded ops in the port, as in
    the reference (the JAX package's ``__getitem__`` is not on its tape)."""
    x = nd.array(np.arange(12, dtype=np.float32).reshape(3, 4))
    x.attach_grad()
    with autograd.record():
        z = (x[::-1][:2] * 2).sum() + x[0, 1:3].sum()
    z.backward()
    want = np.zeros((3, 4), np.float32)
    want[1:] = 2
    want[0, 1:3] += 1
    np.testing.assert_array_equal(x.grad.asnumpy(), want)


def test_unrecorded_ops_build_no_graph():
    x = nd.array([1.0, 2.0])
    x.attach_grad()
    y = x * 2 + x[0]
    assert not y._data.requires_grad
    assert x.reshape((2, 1))._data.grad_fn is None
    with autograd.record():
        assert x.reshape((2, 1))._data.grad_fn is not None
    y.backward()    # nothing recorded: nothing to do, as in the JAX package
    assert not x.grad.asnumpy().any()


def test_mark_variables_pairs_buffers():
    for p in (jmx, mx):
        x = p.nd.array([1.0, 2.0])
        g = p.nd.zeros((2,))
        p.autograd.mark_variables([x], [g], "write")
        with p.autograd.record():
            y = (x * x).sum()
        y.backward()
        np.testing.assert_array_equal(g.asnumpy(), [2.0, 4.0])
    with pytest.raises(MXNetError, match="grad_req"):
        autograd.mark_variables([nd.array([1.0])], [nd.zeros((1,))], "sum")
    assert torch.is_grad_enabled()
