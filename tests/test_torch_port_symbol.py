"""The symbolic graph API of the PyTorch port (`mx.sym`, `Executor`)
against the JAX package's, on the CPU, at small sizes.

Every graph is composed by the same code in both packages, each under a
fresh `NameManager`, so auto-names match. Then:

* the two graphs' ``tojson()`` (parsed), arguments, outputs, aux states,
  ``infer_shape`` and ``infer_type`` are equal, and a ``-symbol.json``
  written by either package loads in the other;
* bound (``simple_bind``) on the same numpy arrays, made from a seed, a
  training forward and backward give the same outputs (rtol 1e-5, atol
  1e-6), gradients (rtol 1e-4 with an absolute floor of 1e-4 x the
  largest magnitude of the compared gradient: both sides compute in f32
  and sum in other orders) and BatchNorm aux states, for ``grad_req``
  write, add (two backwards) and null: an MLP and a conv + BatchNorm +
  Pooling + FC net with SoftmaxOutput, the ``RNN`` op in modes lstm, gru
  and rnn_tanh (2 layers, T 5, B 3, H 8), each loss head and
  SoftmaxOutput's options.

The JAX side runs its LSTM through its Pallas kernels in interpret mode
(``MXTPU_PALLAS_LSTM=1``, by monkeypatch, as tests/test_pallas.py does);
the port runs the plain versions its kernel wrappers take for CPU tensors.
Also on the port alone: which LSTM wrapper a forward reaches, the kept
graph's lifetime, and shape inference on ``meta`` tensors, which launches
no kernel.
"""
import json

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import pallas_kernels as tpk

FWD_RTOL, FWD_ATOL, GRAD_TOL = 1e-5, 1e-6, 1e-4
T, B, H = 5, 3, 8


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.context.scope(mx.cpu()):
        yield


@pytest.fixture
def pallas_lstm(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS_LSTM", "1")


def _pair(build):
    """``build(package)`` in both packages, each under a fresh
    NameManager: (JAX symbol, port symbol)."""
    with jmx.name.NameManager():
        js = build(jmx)
    with mx.name.NameManager():
        ts = build(mx)
    return js, ts


# -- graphs ------------------------------------------------------------------

def mlp(m):
    net = m.sym.FullyConnected(m.sym.var("data"), num_hidden=16, name="fc1")
    net = m.sym.Activation(net, act_type="relu", name="relu1")
    net = m.sym.FullyConnected(net, num_hidden=10, name="fc2")
    return m.sym.SoftmaxOutput(net, name="softmax")


def conv_bn(m):
    # no bias before the BatchNorm, which takes the mean out: its gradient
    # would be zero up to rounding noise
    net = m.sym.Convolution(m.sym.var("data"), kernel=(3, 3), pad=(1, 1),
                            num_filter=4, no_bias=True)
    net = m.sym.BatchNorm(net, fix_gamma=False)
    net = m.sym.Activation(net, act_type="relu")
    net = m.sym.Pooling(net, kernel=(2, 2), stride=(2, 2), pool_type="max")
    net = m.sym.Flatten(net)
    net = m.sym.FullyConnected(net, num_hidden=10)
    return m.sym.SoftmaxOutput(net, name="softmax")


def rnn_op(mode):
    def build(m):
        args = [m.sym.var("data"), m.sym.var("rnn_parameters"),
                m.sym.var("rnn_state")]
        if mode == "lstm":
            args.append(m.sym.var("rnn_state_cell"))
        return m.sym.RNN(*args, state_size=H, num_layers=2, mode=mode,
                         name="rnn")
    return build


def arithmetic(m):
    a = m.sym.var("a", lr_mult=2.0)
    b = m.sym.var("b")
    with m.AttrScope(group="g1"):
        c = (a + b) * 2.0 - a / 3.0
        d = m.sym.exp(c - 1.0) + m.sym.broadcast_mul(a, b)
    return m.sym.Group([c, d, m.sym.sum(d, axis=1)])


def loss_head(op, **attrs):
    def build(m):
        net = m.sym.FullyConnected(m.sym.var("data"), num_hidden=4,
                                   name="fc")
        if op == "MakeLoss":
            return m.sym.MakeLoss(net, name="loss", **attrs)
        return getattr(m.sym, op)(net, m.sym.var("label"), name="loss",
                                  **attrs)
    return build


def softmax_case(**attrs):
    def build(m):
        return m.sym.SoftmaxOutput(m.sym.var("data"), m.sym.var("label"),
                                   name="softmax", **attrs)
    return build


RNN_PARAMS = {"lstm": 4, "gru": 3, "rnn_tanh": 1}
GRAPHS = {
    "mlp": (mlp, {"data": (4, 7), "softmax_label": (4,)}),
    "conv_bn": (conv_bn, {"data": (2, 3, 6, 6), "softmax_label": (2,)}),
    "arithmetic": (arithmetic, {"a": (3, 4), "b": (3, 4)}),
}
for _mode in RNN_PARAMS:
    GRAPHS["rnn_" + _mode] = (rnn_op(_mode), {
        "data": (T, B, 6), "rnn_state": (2, B, H),
        **({"rnn_state_cell": (2, B, H)} if _mode == "lstm" else {})})
for _op in ("LinearRegressionOutput", "LogisticRegressionOutput",
            "MAERegressionOutput"):
    GRAPHS[_op] = (loss_head(_op, grad_scale=0.5),
                   {"data": (5, 3), "label": (5, 4)})
GRAPHS["MakeLoss"] = (loss_head("MakeLoss", normalization="batch"),
                      {"data": (5, 3)})


# -- composition -----------------------------------------------------------

@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_graph_json_names_and_shapes_match_jax(name):
    build, shapes = GRAPHS[name]
    js, ts = _pair(build)
    assert json.loads(ts.tojson()) == json.loads(js.tojson())
    assert ts.list_arguments() == js.list_arguments()
    assert ts.list_outputs() == js.list_outputs()
    assert ts.list_auxiliary_states() == js.list_auxiliary_states()
    assert ts.attr_dict() == js.attr_dict()
    assert ts.get_internals().list_outputs() == \
        js.get_internals().list_outputs()
    jshape, tshape = js.infer_shape(**shapes), ts.infer_shape(**shapes)
    assert [list(map(tuple, s)) for s in tshape] == \
        [list(map(tuple, s)) for s in jshape]
    assert ts.infer_type(np.float32) == js.infer_type(np.float32)
    partial = {k: v for k, v in list(shapes.items())[:1]}
    assert ts.infer_shape_partial(**partial)[0] == \
        [None if s is None else tuple(s)
         for s in js.infer_shape_partial(**partial)[0]]


def test_missing_shapes_raise_as_in_jax():
    js, ts = _pair(mlp)
    with pytest.raises(Exception, match="softmax_label"):
        js.infer_shape(data=(4, 7))
    with pytest.raises(MXNetError, match="softmax_label"):
        ts.infer_shape(data=(4, 7))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_symbol_json_files_cross_both_ways(tmp_path, writer):
    js, ts = _pair(conv_bn)
    fname = str(tmp_path / "net-symbol.json")
    (js if writer == "jax" else ts).save(fname)
    loaded_t, loaded_j = mx.sym.load(fname), jmx.sym.load(fname)
    assert json.loads(loaded_t.tojson()) == json.loads(js.tojson())
    assert json.loads(loaded_j.tojson()) == json.loads(ts.tojson())
    shapes = GRAPHS["conv_bn"][1]
    jex, tex = _bind(loaded_j, loaded_t, shapes, "write", seed=3)
    _forward_backward(jex, tex, 1)


# -- execution ---------------------------------------------------------------

def _values(sym, shapes, seed):
    """Arguments and aux states of ``sym`` from a seed: labels integral,
    moving variances positive, the rest normal."""
    rng = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    args = {}
    for n, s in zip(sym.list_arguments(), arg_shapes):
        if "label" in n:
            args[n] = rng.randint(0, 4, s).astype(np.float32)
        elif n.endswith("parameters"):
            args[n] = rng.uniform(-0.3, 0.3, s).astype(np.float32)
        else:
            args[n] = rng.randn(*s).astype(np.float32)
    aux = {n: (rng.uniform(0.5, 1.5, s) if n.endswith("var")
               else rng.randn(*s)).astype(np.float32)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, aux


def _bind(js, ts, shapes, grad_req, seed=0, values=None):
    args, aux = values or _values(js, shapes, seed)
    jex = js.simple_bind(ctx=jmx.cpu(), grad_req=grad_req, **shapes)
    tex = ts.simple_bind(ctx=mx.cpu(), grad_req=grad_req, **shapes)
    jex.copy_params_from({k: jmx.nd.array(v) for k, v in args.items()},
                         {k: jmx.nd.array(v) for k, v in aux.items()})
    tex.copy_params_from({k: mx.nd.array(v) for k, v in args.items()},
                         {k: mx.nd.array(v) for k, v in aux.items()})
    return jex, tex


def _close_grad(got, want, what):
    want = np.asarray(want, np.float64)
    floor = GRAD_TOL * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               rtol=GRAD_TOL, atol=floor, err_msg=what)


def _forward_backward(jex, tex, rounds, out_grads=None):
    for _ in range(rounds):
        jouts = jex.forward(is_train=True)
        touts = tex.forward(is_train=True)
        jex.backward(None if out_grads is None
                     else [jmx.nd.array(g) for g in out_grads])
        tex.backward(None if out_grads is None
                     else [mx.nd.array(g) for g in out_grads])
    assert len(touts) == len(jouts)
    for j, t in zip(jouts, touts):
        np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), rtol=FWD_RTOL,
                                   atol=FWD_ATOL)
    for name, j in jex.grad_dict.items():
        t = tex.grad_dict[name]
        assert (t is None) == (j is None), name
        if j is not None:
            _close_grad(t.asnumpy(), j.asnumpy(), "grad of " + name)
    for name, j in jex.aux_dict.items():
        np.testing.assert_allclose(tex.aux_dict[name].asnumpy(), j.asnumpy(),
                                   rtol=FWD_RTOL, atol=FWD_ATOL, err_msg=name)


@pytest.mark.parametrize("grad_req", ["write", "add", "null"])
@pytest.mark.parametrize("name", ["mlp", "conv_bn", "rnn_lstm", "rnn_gru",
                                  "rnn_rnn_tanh", "LinearRegressionOutput",
                                  "LogisticRegressionOutput",
                                  "MAERegressionOutput", "MakeLoss"])
def test_executor_forward_backward_matches_jax(pallas_lstm, name, grad_req):
    build, shapes = GRAPHS[name]
    js, ts = _pair(build)
    jex, tex = _bind(js, ts, shapes, grad_req, seed=len(name))
    out_grads = None
    if name.startswith("rnn_"):   # a plain output: its head gradient given
        rng = np.random.RandomState(7)
        out_grads = [rng.randn(T, B, H).astype(np.float32)]
    _forward_backward(jex, tex, 2 if grad_req == "add" else 1, out_grads)


SOFTMAX_CASES = {
    "plain": ({}, (6, 5)),
    "grad_scale": ({"grad_scale": 2.0}, (6, 5)),
    "ignore": ({"use_ignore": True, "ignore_label": 1}, (6, 5)),
    "batch": ({"normalization": "batch"}, (6, 5)),
    "valid": ({"normalization": "valid", "use_ignore": True,
               "ignore_label": 0}, (6, 5)),
    "smooth": ({"smooth_alpha": 0.1}, (6, 5)),
    "multi_output": ({"multi_output": True}, (3, 4, 5)),
    "multi_output_ignore": ({"multi_output": True, "use_ignore": True,
                             "ignore_label": 2,
                             "normalization": "valid"}, (3, 4, 5)),
}


@pytest.mark.parametrize("case", sorted(SOFTMAX_CASES))
def test_softmax_output_options_match_jax(case):
    attrs, shape = SOFTMAX_CASES[case]
    label_shape = (shape[0],) + shape[2:] if attrs.get("multi_output") \
        else shape[:1]
    js, ts = _pair(softmax_case(**attrs))
    rng = np.random.RandomState(11)
    values = ({"data": rng.randn(*shape).astype(np.float32),
               "label": rng.randint(0, 4, label_shape).astype(np.float32)},
              {})
    jex, tex = _bind(js, ts, {"data": shape, "label": label_shape}, "write",
                     values=values)
    _forward_backward(jex, tex, 1)


# -- the port's own contracts ------------------------------------------------

def _count_calls(monkeypatch, names):
    calls = dict.fromkeys(names, 0)
    for n in names:
        real = getattr(tpk, n)

        def wrapped(*a, _real=real, _n=n, **kw):
            calls[_n] += a[0].device.type != "meta"
            return _real(*a, **kw)
        monkeypatch.setattr(tpk, n, wrapped)
    return calls


@pytest.mark.parametrize("is_train,grad_req,want", [
    (True, "write", "lstm_fwd"), (False, "write", "lstm_infer"),
    (True, "null", "lstm_infer")])
def test_executor_chooses_the_lstm_wrapper(monkeypatch, is_train, grad_req,
                                           want):
    """A training forward that takes a gradient reaches lstm_fwd (and its
    backward lstm_bwd); an inference forward, and a training forward with
    every grad_req null (nothing to differentiate), reach lstm_infer."""
    calls = _count_calls(monkeypatch, ["lstm_infer", "lstm_fwd", "lstm_bwd"])
    _, ts = _pair(rnn_op("lstm"))
    shapes = GRAPHS["rnn_lstm"][1]
    ex = ts.simple_bind(grad_req=grad_req, **shapes)
    ex.forward(is_train=is_train)
    if is_train:
        ex.backward([mx.nd.ones((T, B, H))])
    assert calls[want] == 2, calls
    assert calls["lstm_bwd"] == (2 if want == "lstm_fwd" else 0), calls
    assert sum(calls.values()) == calls[want] + calls["lstm_bwd"]


def test_training_forward_keeps_the_graph_until_backward():
    _, ts = _pair(mlp)
    ex = ts.simple_bind(**GRAPHS["mlp"][1])
    ex.forward(is_train=False)
    assert ex._graph is None
    with pytest.raises(MXNetError, match="before forward"):
        ex.backward()
    ex.forward(is_train=True)
    kept = ex._graph
    assert kept is not None
    ex.forward(is_train=True)
    assert ex._graph is not kept      # the next forward replaced it
    ex.backward()
    assert ex._graph is None          # backward released it
    ex.forward(is_train=True)
    ex.drop_graph()
    assert ex._graph is None


def test_shape_inference_runs_on_meta_and_launches_nothing(monkeypatch):
    """infer_shape runs BatchNorm's conv-epilogue wrappers and the LSTM
    wrappers on meta tensors: their plain versions, shapes only; no kernel
    is built or launched."""
    def no_kernel(*a, **kw):
        raise AssertionError("a kernel was reached during shape inference")

    monkeypatch.setattr(tpk, "_call", no_kernel)
    monkeypatch.setattr(tpk._build, "load", no_kernel)
    for build, shapes in (GRAPHS["conv_bn"], GRAPHS["rnn_lstm"]):
        _, ts = _pair(build)
        assert ts.infer_shape(**shapes)[1]
    meta = dict(device="meta")
    ys, c_all, gates = tpk.lstm_fwd(torch.empty(T, B, 4 * H, **meta),
                                    torch.empty(4 * H, H, **meta),
                                    torch.empty(B, H, **meta),
                                    torch.empty(B, H, **meta))
    assert (ys.shape, c_all.shape, gates.shape) == \
        ((T, B, H), (T, B, H), (T, B, 4 * H)) and ys.is_meta
    vecs = tpk.epi_stats(torch.empty(12, 4, **meta), torch.empty(4, **meta),
                         torch.empty(4, **meta))
    assert [tuple(v.shape) for v in vecs] == [(4,)] * 5


def test_nd_ops_hide_aux_outputs_and_take_the_training_mode():
    """mx.nd.BatchNorm returns one array and updates its moving statistics
    in place only in training mode (autograd.record / train_mode)."""
    rng = np.random.RandomState(5)
    x = mx.nd.array(rng.randn(4, 3, 2, 2))
    g, b = mx.nd.ones((3,)), mx.nd.zeros((3,))
    mm, mv = mx.nd.zeros((3,)), mx.nd.ones((3,))
    out = mx.nd.BatchNorm(x, g, b, mm, mv)
    assert isinstance(out, mx.nd.NDArray) and float(mm.abs().sum()) == 0.0
    with mx.autograd.record():
        mx.nd.BatchNorm(x, g, b, mm, mv)
    want = 0.1 * x.asnumpy().mean(axis=(0, 2, 3))
    np.testing.assert_allclose(mm.asnumpy(), want, rtol=1e-5, atol=1e-7)
    assert mx.nd.Dropout(x, p=0.5).shape == x.shape
