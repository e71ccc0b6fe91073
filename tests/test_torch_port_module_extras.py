"""The rest of the symbolic façade of the PyTorch port against the JAX
package's, on the CPU, at small sizes: `monitor.Monitor` (on an executor
and in `Module.fit(monitor=)`), `module.PythonLossModule`,
`module.SequentialModule`, `model.FeedForward` and ``mx.viz``.

The same graphs are composed in both packages (each under a fresh
`NameManager`) over the same numpy inputs and initial parameters (the JAX
module's Xavier draw, numpy's generator seeded). The monitor's rows have
the same steps and names in the same order, and statistics within 1e-6 x
their scale; forward, input gradients and one SGD update of the
sequential chain, and `FeedForward`'s fit and predict, agree within the
module tests' rtol 1e-4 with a floor of 1e-4 x the largest magnitude;
`print_summary` prints the same text character for character, and
`plot_network` gives the same graphviz source, or the same `ImportError`
without graphviz.
"""
import json
import logging
import sys

import numpy as np
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx

TOL = 1e-4
STAT_TOL = 1e-6
BATCH = 8


@pytest.fixture(autouse=True)
def cpu():
    with mx.context.scope(mx.cpu()):
        yield


def _close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    floor = TOL * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=floor, err_msg=what)


def _data(seed, n=2 * BATCH, dim=6, classes=3):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, dim).astype(np.float32),
            rng.randint(0, classes, (n,)).astype(np.float32))


def _mlp(m, head=True):
    with m.name.NameManager():
        h = m.sym.FullyConnected(m.sym.var("data"), num_hidden=8, name="fc1")
        h = m.sym.Activation(h, act_type="relu", name="act1")
        h = m.sym.FullyConnected(h, num_hidden=3, name="fc2")
        return m.sym.SoftmaxOutput(h, name="softmax") if head else h


def _jax_init(sym, shapes, seed=0):
    """Xavier parameters of ``sym`` from the JAX package's `Module`
    (numpy's generator seeded), as numpy."""
    labels = [k for k in shapes if k != "data"]
    mod = jmx.mod.Module(sym, label_names=labels or None,
                         context=jmx.cpu())
    mod.bind([("data", shapes["data"])],
             [(k, shapes[k]) for k in labels] or None)
    np.random.seed(seed)
    mod.init_params(jmx.init.Xavier())
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


# ---------------------------------------------------------------------------
# Monitor
# ---------------------------------------------------------------------------

def _stats(rows):
    """(step, name, values) of `Monitor.toc` rows."""
    return [(s, n, json.loads(v)) for s, n, v in rows]


def _same_rows(got, want):
    assert [(s, n) for s, n, _ in got] == [(s, n) for s, n, _ in want]
    for (_, n, g), (_, _, w) in zip(got, want):
        scale = max(abs(float(np.max(np.abs(w)))), 1e-30)
        np.testing.assert_allclose(g, w, rtol=0, atol=STAT_TOL * scale,
                                   err_msg=n)


def _monitored_exe(m, pattern, sort, interval, x, params):
    with m.name.NameManager():
        data = m.sym.var("data")
        fc1 = m.sym.FullyConnected(data, num_hidden=8, name="fc1")
        act = m.sym.Activation(fc1, act_type="tanh", name="act1")
        fc2 = m.sym.FullyConnected(act, num_hidden=3, name="fc2")
        out = m.sym.Group([fc2, fc1, act])
    ctx = m.cpu()
    args = {k: m.nd.array(v, ctx=ctx) for k, v in params.items()}
    args["data"] = m.nd.array(x, ctx=ctx)
    exe = out.bind(ctx, args=args)
    mon = m.monitor.Monitor(interval, pattern=pattern, sort=sort)
    mon.install(exe)
    rows = []
    for _ in range(3):
        mon.tic()
        exe.forward()
        rows.append(_stats(mon.toc()))
    return rows


@pytest.mark.parametrize("pattern,sort,interval", [(".*", False, 1),
                                                  ("fc.*", True, 2)])
def test_monitor_rows_match_jax(pattern, sort, interval):
    x, _ = _data(1)
    shapes = {"data": x.shape}
    params = _jax_init(_mlp(jmx, head=False), shapes, seed=2)
    want = _monitored_exe(jmx, pattern, sort, interval, x, params)
    got = _monitored_exe(mx, pattern, sort, interval, x, params)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _same_rows(g, w)
    assert [len(r) > 0 for r in got] == [True, interval == 1, True]


class _Recorder:
    """A `Monitor` of either package whose `toc_print` keeps its rows."""

    def __init__(self, m, **kw):
        self.mon = m.monitor.Monitor(1, **kw)
        self.rows = []
        self.mon.toc_print = lambda: self.rows.extend(_stats(self.mon.toc()))


def test_fit_monitor_matches_jax():
    x, y = _data(3)
    params = _jax_init(_mlp(jmx), {"data": (BATCH, 6),
                                   "softmax_label": (BATCH,)}, seed=4)
    rows = {}
    for name, m in (("jax", jmx), ("port", mx)):
        rec = _Recorder(m, stat_func=lambda a: a.abs().max())
        it = m.io.NDArrayIter(x, y, batch_size=BATCH)
        mod = m.mod.Module(_mlp(m), context=m.cpu())
        mod.fit(it, num_epoch=1, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1},
                arg_params={k: m.nd.array(v, ctx=m.cpu())
                            for k, v in params.items()},
                monitor=rec.mon)
        rows[name] = rec.rows
    assert [n for _, n, _ in rows["port"]] == ["softmax_output"] * 2
    _same_rows(rows["port"], rows["jax"])
    # the rows are logged through the port's logger, at INFO
    assert mx.monitor._LOG.name == "mxnet_tpu_torch.monitor"
    assert mx.monitor._LOG.level == logging.INFO


# ---------------------------------------------------------------------------
# PythonLossModule and SequentialModule
# ---------------------------------------------------------------------------

def _softmax_ce_grad(scores, labels):
    s = scores.asnumpy()
    p = np.exp(s - s.max(axis=1, keepdims=True))
    p /= p.sum(axis=1, keepdims=True)
    p[np.arange(len(p)), labels.asnumpy().astype(int)] -= 1.0
    return p / len(p)


def _loss_module(m, x, y):
    mod = m.mod.PythonLossModule(grad_func=_softmax_ce_grad)
    mod.bind([("data", x.shape)], [("softmax_label", y.shape)])
    mod.init_params()
    mod.init_optimizer()
    batch = m.io.DataBatch([m.nd.array(x, ctx=m.cpu())],
                           [m.nd.array(y, ctx=m.cpu())])
    mod.forward(batch, is_train=True)
    out = mod.get_outputs()[0].asnumpy()
    mod.backward()
    return out, mod.get_input_grads()[0].asnumpy(), mod.output_shapes


def test_python_loss_module_matches_jax():
    x, y = _data(5, n=BATCH, dim=3)
    want = _loss_module(jmx, x, y)
    got = _loss_module(mx, x, y)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert [(n, tuple(s)) for n, s in got[2]] == \
        [(n, tuple(s)) for n, s in want[2]]
    with pytest.raises(NotImplementedError):
        mx.mod.PythonLossModule().install_monitor(None)


def _body(m):
    with m.name.NameManager():
        h = m.sym.FullyConnected(m.sym.var("data"), num_hidden=8, name="fc1")
        return m.sym.Activation(h, act_type="tanh", name="act1")


def _head(m):
    with m.name.NameManager():
        h = m.sym.FullyConnected(m.sym.var("data"), num_hidden=3, name="fc2")
        return m.sym.SoftmaxOutput(h, name="softmax")


def _chain(m, kind, x, y, params):
    ctx = m.cpu()
    seq = m.mod.SequentialModule()
    seq.add(m.mod.Module(_body(m), label_names=None, context=ctx))
    if kind == "module":
        seq.add(m.mod.Module(_head(m), context=ctx), take_labels=True,
                auto_wiring=True)
    else:
        with m.name.NameManager():
            fc2 = m.sym.FullyConnected(m.sym.var("data"), num_hidden=3,
                                       name="fc2")
        seq.add(m.mod.Module(fc2, label_names=None, context=ctx),
                auto_wiring=True)
        seq.add(m.mod.PythonLossModule(grad_func=_softmax_ce_grad),
                take_labels=True, auto_wiring=True)
    if m is jmx:
        # the JAX Module's output_shapes are empty until a forward, so the
        # JAX chain cannot wire itself at bind: its later modules are bound
        # here first (and its bind skips them); the port's chain wires
        # itself from the shapes inferred at bind
        widths = {"module": [8], "python_loss": [8, 3]}[kind]
        for mod, w in zip(seq._modules[1:], widths):
            labels = [("softmax_label", y.shape)] \
                if mod is seq._modules[-1] else None
            mod.bind([("data", (len(x), w))], labels, inputs_need_grad=True)
    seq.bind([("data", x.shape)], [("softmax_label", y.shape)],
             inputs_need_grad=True)
    seq.init_params(arg_params={k: m.nd.array(v, ctx=ctx)
                                for k, v in params.items()})
    seq.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1,
                                         "rescale_grad": 1.0})
    batch = m.io.DataBatch([m.nd.array(x, ctx=ctx)], [m.nd.array(y, ctx=ctx)])
    seq.forward(batch, is_train=True)
    out = seq.get_outputs()[0].asnumpy()
    seq.backward()
    grad = seq.get_input_grads()[0].asnumpy()
    seq.update()
    metric = m.metric.create("acc")
    seq.update_metric(metric, batch.label)
    after = {k: v.asnumpy() for k, v in seq.get_params()[0].items()}
    return out, grad, after, metric.get(), \
        [(n, tuple(s)) for n, s in seq.output_shapes]


@pytest.mark.parametrize("kind", ["module", "python_loss"])
def test_sequential_module_matches_jax(kind):
    x, y = _data(6, n=BATCH)
    params = _jax_init(_mlp(jmx), {"data": x.shape, "softmax_label": y.shape},
                       seed=7)
    want = _chain(jmx, kind, x, y, params)
    got = _chain(mx, kind, x, y, params)
    _close(got[0], want[0], "forward")
    _close(got[1], want[1], "input grads")
    assert sorted(got[2]) == sorted(want[2]) == sorted(params)
    for k in want[2]:
        _close(got[2][k], want[2][k], "after update: " + k)
    assert got[3] == want[3] and got[4] == want[4]


# ---------------------------------------------------------------------------
# FeedForward
# ---------------------------------------------------------------------------

def _feedforward(m, x, y, params, prefix):
    ctx = m.cpu()
    ff = m.model.FeedForward(
        _mlp(m), ctx=ctx, num_epoch=2, optimizer="sgd",
        arg_params={k: m.nd.array(v, ctx=ctx) for k, v in params.items()},
        optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
    ff.fit(m.io.NDArrayIter(x, y, batch_size=BATCH))
    pred = ff.predict(m.io.NDArrayIter(x, y, batch_size=BATCH))
    ff.save(prefix)
    return pred, {k: v.asnumpy() for k, v in ff.arg_params.items()}


def test_feedforward_fit_and_predict_match_jax(tmp_path):
    x, y = _data(8)
    params = _jax_init(_mlp(jmx), {"data": (BATCH, 6),
                                   "softmax_label": (BATCH,)}, seed=9)
    want = _feedforward(jmx, x, y, params, str(tmp_path / "jax"))
    got = _feedforward(mx, x, y, params, str(tmp_path / "port"))
    assert isinstance(got[0], np.ndarray) and got[0].shape == (len(x), 3)
    _close(got[0], want[0], "predict")
    for k in want[1]:
        _close(got[1][k], want[1][k], k)
    # the port's saved estimator loads into the JAX package's, and back
    for m, src in ((jmx, "port"), (mx, "jax")):
        ff = m.model.FeedForward.load(str(tmp_path / src), 2, ctx=m.cpu())
        assert ff.begin_epoch == 2
        pred = ff.predict(m.io.NDArrayIter(x, y, batch_size=BATCH))
        _close(pred, got[0] if src == "port" else want[0], "loaded " + src)


# ---------------------------------------------------------------------------
# mx.viz
# ---------------------------------------------------------------------------

def _viz_net(m):
    with m.name.NameManager():
        x = m.sym.var("data")
        c = m.sym.Convolution(x, kernel=(3, 3), num_filter=4, name="conv")
        b = m.sym.BatchNorm(c, name="bn")
        a = m.sym.Activation(b, act_type="relu", name="relu")
        p = m.sym.Pooling(a, kernel=(2, 2), stride=(2, 2), pool_type="max",
                          name="pool")
        f = m.sym.FullyConnected(m.sym.Flatten(p, name="flat"),
                                 num_hidden=3, name="fc")
        s = m.sym.elemwise_add(f, f, name="twice")
        return m.sym.SoftmaxOutput(s, name="softmax")


@pytest.mark.parametrize("shape", [None, {"data": (2, 3, 8, 8),
                                          "softmax_label": (2,)}])
def test_print_summary_prints_the_jax_text(capsys, shape):
    jmx.viz.print_summary(_viz_net(jmx), shape=shape)
    want = capsys.readouterr().out
    mx.viz.print_summary(_viz_net(mx), shape=shape)
    got = capsys.readouterr().out
    assert got == want
    assert "Total params: %d" % (112 + 16 + 111 if shape else 0) in got
    with pytest.raises(TypeError):
        mx.viz.print_summary("not a symbol")


def test_plot_network_matches_jax(monkeypatch):
    if "graphviz" in sys.modules and sys.modules["graphviz"] is None:
        pytest.skip("graphviz is blocked in this process")
    try:
        import graphviz  # noqa: F401
        have = True
    except ImportError:
        have = False
    if have:
        for hide in (True, False):
            want = jmx.viz.plot_network(_viz_net(jmx), hide_weights=hide)
            got = mx.viz.plot_network(_viz_net(mx), hide_weights=hide)
            assert got.source == want.source
    # without graphviz both raise the same ImportError
    monkeypatch.setitem(sys.modules, "graphviz", None)
    msgs = []
    for m in (jmx, mx):
        with pytest.raises(ImportError) as ei:
            m.viz.plot_network(_viz_net(m))
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_log_formats_as_the_jax_logger(tmp_path):
    records = {}
    for name, m in (("jax", jmx), ("port", mx)):
        path = str(tmp_path / (name + ".log"))
        logger = m.log.get_logger("extras_%s" % name, filename=path,
                                  level=m.log.INFO)
        logger.info("hello %d", 3)
        logger.warning("careful")
        for h in logger.handlers:
            h.flush()
        with open(path) as f:
            records[name] = [ln.split(" ", 3)[0][0] + ln.rsplit(" ", 1)[-1]
                             for ln in f.read().splitlines()]
    assert records["port"] == records["jax"] == ["I3", "Wcareful"]
    assert mx.log.getLogger is not None and mx.log.WARNING == jmx.log.WARNING
