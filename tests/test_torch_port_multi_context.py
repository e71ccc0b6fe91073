"""Data parallelism over several contexts in one process: `Context`,
`Parameter` / `Block` / `gluon.Trainer` over ``[cpu(0), cpu(1)]``,
`Module` over two contexts, `executor_manager` and the kvstore's
per-context compression residual, against the JAX package, on the CPU.

The same calls with the same seeded numpy values go to both packages.
Both compute in f32; values agree within rtol 1e-5 with an absolute floor
of 1e-5 x the largest magnitude of the compared tensor (``TOL``). The JAX
`Module` binds one executor over a ``dp`` mesh of its contexts (its graph
is the whole batch: a training BatchNorm takes the whole batch's moments),
and the port's binds one executor over the whole batch on the first
context: the LeNet with a BatchNorm is held to the JAX module, and to the
port's own one-context module exactly.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError

TOL = 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.context.scope(mx.cpu()):
        yield


def _close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    floor = TOL * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=floor, err_msg=what)


def _both(run):
    want, got = run(jmx), run(mx)
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], k)
    return got


def _ctxs(pkg):
    return [pkg.cpu(0), pkg.cpu(1)]


# -- Context ----------------------------------------------------------------

def test_context_identity_against_jax():
    for pkg in (jmx, mx):
        a, b = pkg.cpu(0), pkg.cpu(1)
        assert a != b and a == pkg.cpu() and hash(a) == hash(pkg.cpu(0))
        assert len({a, b, pkg.cpu(0)}) == 2
        assert a != pkg.gpu(0) and pkg.gpu(1) == pkg.Context("gpu", 1)
    for name, dev_id in (("cpu", 3), ("gpu", 1), ("cpu_pinned", 0),
                         ("tpu", 2)):
        want = jmx.context.Context(name, dev_id)
        got = mx.Context(name, dev_id)
        assert (repr(got), got.device_type, got.device_id,
                got.device_typeid) == (repr(want), want.device_type,
                                       want.device_id, want.device_typeid)
        assert mx.Context(got) == got
    assert mx.Context.devtype2id == jmx.context.Context.devtype2id
    with pytest.raises(MXNetError, match="unknown device type"):
        mx.Context("fpga")


def test_context_devices_and_with_blocks():
    import torch

    assert mx.cpu(1).torch_device() == torch.device("cpu")
    assert mx.context.resolve_device(mx.cpu(5)) == torch.device("cpu")
    assert mx.context.resolve_device("cpu") == torch.device("cpu")
    assert mx.Context(torch.device("cpu")) == mx.cpu(0)
    assert mx.Context("cuda:1") == mx.gpu(1)
    assert mx.cpu(0).memory_info() == (0, 0)
    mx.cpu(0).empty_cache()
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError, match="no CUDA device"):
            mx.gpu(0).torch_device()
    with mx.cpu(1):
        assert mx.current_context() == mx.cpu(1)
        assert mx.Context.default_ctx() == mx.cpu(1)
        assert mx.nd.zeros((2,)).context == mx.cpu(1)
        assert (mx.nd.ones((2,)) + 1).context == mx.cpu(1)
        with mx.cpu(2):
            assert mx.current_context() == mx.cpu(2)
        with torch.device("cpu"):   # a torch block inside is the inner one
            assert mx.current_context() == mx.cpu(0)
        assert mx.current_context() == mx.cpu(1)
        assert torch.zeros(1).device == torch.device("cpu")
    with mx.context.scope(mx.cpu(3)):
        assert mx.current_context() == mx.cpu(3)


def test_ndarray_keeps_the_context_it_was_placed_with():
    for pkg in (jmx, mx):
        a = pkg.nd.ones((2, 3), ctx=pkg.cpu(1))
        assert a.context == pkg.cpu(1)
        b = a.as_in_context(pkg.cpu(0))
        assert b.context == pkg.cpu(0) and a.as_in_context(pkg.cpu(1)) is a
        assert a.copyto(pkg.cpu(2)).context == pkg.cpu(2)
        assert pkg.nd.array(np.ones(3), ctx=pkg.cpu(1)).context \
            == pkg.cpu(1)
        assert pkg.nd.zeros((2,), ctx=pkg.cpu(1)).context == pkg.cpu(1)
    # an op's output takes its first input's context
    a = mx.nd.ones((2, 3), ctx=mx.cpu(1))
    assert (a * 2 + 1).context == mx.cpu(1)
    assert a[0].context == mx.cpu(1) and a.reshape((3, 2)).context \
        == mx.cpu(1)
    assert mx.nd.sparse.zeros("row_sparse", (3, 2), ctx=mx.cpu()).context \
        == mx.cpu(0)


# -- Parameter and Block ----------------------------------------------------

def test_parameter_over_two_contexts():
    def run(pkg):
        ctxs = _ctxs(pkg)
        p = pkg.gluon.Parameter("w", shape=(2, 3))
        p.initialize(ctx=ctxs, init="ones")
        assert p.list_ctx() == ctxs
        d0, d1 = p.data(ctxs[0]), p.data(ctxs[1])
        assert d0 is not d1 and d0.context == ctxs[0] \
            and d1.context == ctxs[1]
        assert p.data(ctxs[1]) is d1 and len(p.list_data()) == 2
        with pytest.raises(Exception, match="not initialized on context"):
            p.data(pkg.cpu(7))
        w = np.arange(6, dtype=np.float32).reshape(2, 3)
        p.set_data(pkg.nd.array(w))
        out = {"set0": d0.asnumpy(), "set1": d1.asnumpy()}
        for i, c in enumerate(ctxs):
            with pkg.autograd.record():
                loss = (p.data(c) * (i + 2)).sum()
            loss.backward()
        out["g0"], out["g1"] = (p.grad(c).asnumpy() for c in ctxs)
        assert len(p.list_grad()) == 2
        p.zero_grad()
        out["zeroed"] = np.stack([g.asnumpy() for g in p.list_grad()])
        p.reset_ctx([pkg.cpu(2), pkg.cpu(0), pkg.cpu(1)])
        assert p.list_ctx() == [pkg.cpu(2), pkg.cpu(0), pkg.cpu(1)]
        out["reset"] = np.stack([a.asnumpy() for a in p.list_data()])
        p.reset_ctx(pkg.cpu(1))
        assert p.list_ctx() == [pkg.cpu(1)]
        return out

    got = _both(run)
    np.testing.assert_array_equal(got["g1"], np.full((2, 3), 3.0))


def test_block_initialize_reset_and_save_over_contexts(tmp_path):
    def run(pkg):
        ctxs = _ctxs(pkg)
        net = pkg.gluon.nn.Dense(3)   # deferred: in_units at first call
        net.initialize(ctx=ctxs)
        assert net.weight.list_ctx() == ctxs
        x = pkg.nd.array(np.arange(8, dtype=np.float32).reshape(2, 4))
        net(x.as_in_context(ctxs[0]))
        assert net.weight.list_ctx() == ctxs
        w = np.linspace(-1, 1, 12, dtype=np.float32).reshape(3, 4)
        net.weight.set_data(pkg.nd.array(w))
        net.bias.set_data(pkg.nd.array([0.5, -0.5, 0.25]))
        outs = {"y%d" % i: net(x.as_in_context(c)).asnumpy()
                for i, c in enumerate(ctxs)}
        net.collect_params().reset_ctx([ctxs[1], ctxs[0]])
        assert net.weight.list_ctx() == [ctxs[1], ctxs[0]]
        f = str(tmp_path / ("%s.params" % pkg.__name__))
        net.save_parameters(f)
        other = pkg.gluon.nn.Dense(3, in_units=4)
        other.load_parameters(f, ctx=ctxs)
        outs["loaded"] = other.weight.data(ctxs[1]).asnumpy()
        net.collect_params().initialize(ctx=ctxs, force_reinit=True,
                                        init=pkg.init.One())
        outs["reinit"] = net.weight.data(ctxs[1]).asnumpy()
        return outs

    _both(run)


def test_split_and_load_onto_distinct_contexts():
    def run(pkg):
        x = pkg.nd.array(np.arange(24, dtype=np.float32).reshape(6, 4))
        parts = pkg.gluon.utils.split_and_load(x, _ctxs(pkg))
        assert [p.context for p in parts] == _ctxs(pkg)
        return {"p%d" % i: p.asnumpy() for i, p in enumerate(parts)}

    _both(run)


# -- gluon.Trainer ----------------------------------------------------------

def test_trainer_multi_device():
    """The JAX package's test_gluon.py::test_trainer_multi_device through
    both Trainers: the gradients 1 and 2 summed over the copies."""
    def run(pkg):
        ctxs = _ctxs(pkg)
        p = pkg.gluon.Parameter("w", shape=(3,))
        p.initialize(ctx=ctxs, init="ones")
        trainer = pkg.gluon.Trainer({"w": p}, "sgd", {"learning_rate": 1.0})
        for i, c in enumerate(ctxs):
            with pkg.autograd.record():
                loss = (p.data(c) * (i + 1)).sum()
            loss.backward()
        trainer.step(1)
        return {"w0": p.data(ctxs[0]).asnumpy(),
                "w1": p.data(ctxs[1]).asnumpy()}

    got = _both(run)
    np.testing.assert_array_equal(got["w0"], -2.0)


def _mlp(pkg):
    net = pkg.gluon.nn.HybridSequential(prefix="mlp_")
    with net.name_scope():
        net.add(pkg.gluon.nn.Dense(8, activation="relu", in_units=5),
                pkg.gluon.nn.Dense(3, in_units=8))
    return net


_RNG = np.random.RandomState(3)
_MLP_W = [_RNG.uniform(-0.5, 0.5, s).astype(np.float32)
          for s in ((8, 5), (8,), (3, 8), (3,))]
_X = _RNG.uniform(-1, 1, (4, 8, 5)).astype(np.float32)
_Y = _RNG.randint(0, 3, (4, 8)).astype(np.float32)


@pytest.mark.parametrize("kvstore,opt", [
    ("device", "sgd"), (None, "sgd"), ("local", "adam"),
    ("device", "sgd-update-on-kvstore")])
def test_gluon_training_over_two_contexts(kvstore, opt):
    """split_and_load, a forward and backward on each context's slice and
    `Trainer.step`, 4 steps of an MLP; momentum or Adam states per
    context; ``update_on_kvstore=True`` is taken by both Trainers and
    leaves the update with them."""
    on_kv = opt.endswith("update-on-kvstore")
    name = opt.split("-")[0]

    def run(pkg):
        ctxs = _ctxs(pkg)
        net = _mlp(pkg)
        net.initialize(ctx=ctxs)
        for p, w in zip(net.collect_params().values(), _MLP_W):
            p.set_data(pkg.nd.array(w))
        params = {"learning_rate": 0.1}
        if name == "sgd":
            params.update(momentum=0.9, wd=1e-3)
        kw = {"update_on_kvstore": True} if on_kv else {}
        trainer = pkg.gluon.Trainer(net.collect_params(), name, params,
                                    kvstore=kvstore, **kw)
        loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
        losses = []
        for x, y in zip(_X, _Y):
            xs = pkg.gluon.utils.split_and_load(pkg.nd.array(x), ctxs)
            ys = pkg.gluon.utils.split_and_load(pkg.nd.array(y), ctxs)
            with pkg.autograd.record():
                ls = [loss_fn(net(a), b) for a, b in zip(xs, ys)]
            for lval in ls:
                lval.backward()
            trainer.step(x.shape[0])
            losses.append(sum(float(lval.sum().asscalar()) for lval in ls))
        out = {"losses": np.array(losses)}
        for i, (k, p) in enumerate(sorted(net.collect_params().items())):
            for j, c in enumerate(ctxs):
                out["%s@%d" % (k, j)] = p.data(c).asnumpy()
        return out

    got = _both(run)
    if name == "sgd":
        # Adam's step count advances once a copy (one optimizer, an
        # updater a context, as in the JAX package), so its copies drift
        # apart alike in both packages; SGD's stay equal
        for k in got:
            if k.endswith("@1"):
                np.testing.assert_array_equal(got[k], got[k[:-1] + "0"])


def test_allreduce_then_update_equals_step():
    def train(split):
        net = _mlp(mx)
        net.initialize(ctx=_ctxs(mx))
        for p, w in zip(net.collect_params().values(), _MLP_W):
            p.set_data(mx.nd.array(w))
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.1, "momentum": 0.9})
        for x, y in zip(_X, _Y):
            xs = mx.gluon.utils.split_and_load(mx.nd.array(x), _ctxs(mx))
            with mx.autograd.record():
                ls = [net(a).sum() for a in xs]
            mx.autograd.backward(ls)
            if split:
                trainer.allreduce_grads()
                trainer.update(8)
            else:
                trainer.step(8)
        return [p.data(mx.cpu(1)).asnumpy()
                for p in net.collect_params().values()]

    for a, b in zip(train(True), train(False)):
        np.testing.assert_array_equal(a, b)


def test_trainer_contexts_must_agree_and_unported_parts_raise():
    a = mx.gluon.Parameter("a", shape=(2,))
    b = mx.gluon.Parameter("b", shape=(2,))
    a.initialize(ctx=_ctxs(mx))
    b.initialize(ctx=mx.cpu(0))
    with pytest.raises(MXNetError, match="same set of contexts"):
        mx.gluon.Trainer([a, b], "sgd")
    for call in (lambda: mx.gluon.Trainer([a], "sgd", sharded=True),
                 lambda: mx.gluon.Trainer([a], "sgd").step_batch(None),
                 lambda: mx.gluon.Trainer([a], "sgd").prefetch([])):
        with pytest.raises(MXNetError, match="item 2.*item 13"):
            call()


# -- the kvstore's per-context residual -------------------------------------

def test_compression_residual_is_kept_per_context():
    """0.3 pushed from cpu(0) and from cpu(1) twice with threshold 0.5:
    each context's residual reaches 0.6 at the second push, so the pulls
    read 0 then 1.0. One residual shared by the two contexts (the fault
    when every host context was one device) would send 0.5 at the first
    push."""
    def run(pkg):
        kv = pkg.kv.create("local")
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
        kv.init("k", pkg.nd.zeros((3,)))
        out, pulls = pkg.nd.zeros((3,)), []
        for _ in range(2):
            kv.push("k", [pkg.nd.full((3,), 0.3, ctx=c)
                          for c in _ctxs(pkg)])
            kv.pull("k", out=out)
            pulls.append(out.asnumpy())
        return {"pulls": np.stack(pulls)}

    got = _both(run)
    np.testing.assert_allclose(got["pulls"], [[0.0] * 3, [1.0] * 3],
                               atol=1e-7)


# -- Module over two contexts ---------------------------------------------

BATCH, NBATCH = 8, 3


def _mlp_sym(m):
    net = m.sym.FullyConnected(m.sym.var("data"), num_hidden=16, name="fc1")
    net = m.sym.Activation(net, act_type="relu")
    net = m.sym.FullyConnected(net, num_hidden=5, name="fc2")
    return m.sym.SoftmaxOutput(net, name="softmax")


def _bn_sym(m):
    net = m.sym.Convolution(m.sym.var("data"), kernel=(3, 3), num_filter=4,
                            no_bias=True, name="conv1")
    net = m.sym.BatchNorm(net, fix_gamma=False, name="bn1")
    net = m.sym.Activation(net, act_type="tanh")
    net = m.sym.Pooling(net, kernel=(2, 2), stride=(2, 2), pool_type="max")
    net = m.sym.Flatten(net)
    net = m.sym.FullyConnected(net, num_hidden=5, name="fc1")
    return m.sym.SoftmaxOutput(net, name="softmax")


_SYMS = {"mlp": (_mlp_sym, (7,)), "bn_conv": (_bn_sym, (2, 8, 8))}


def _fit(pkg, name, contexts, kvstore):
    build, shape = _SYMS[name]
    rng = np.random.RandomState(len(name))
    x = rng.randn(BATCH * NBATCH, *shape).astype(np.float32)
    y = rng.randint(0, 5, (BATCH * NBATCH,)).astype(np.float32)
    with pkg.name.NameManager():
        sym = build(pkg)
    it = pkg.io.NDArrayIter(x, y, batch_size=BATCH)
    mod = pkg.mod.Module(sym, context=contexts)
    mod.bind(it.provide_data, it.provide_label)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=(BATCH,) + shape,
                                                softmax_label=(BATCH,))
    prng = np.random.RandomState(7)
    arg = {n: pkg.nd.array(prng.uniform(-0.3, 0.3, s).astype(np.float32))
           for n, s in zip(sym.list_arguments(), arg_shapes)
           if n not in ("data", "softmax_label")}
    aux = {n: pkg.nd.array(np.ones(s, np.float32) if "var" in n
                           else np.zeros(s, np.float32))
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    mod.init_params(arg_params=arg, aux_params=aux)
    # plain SGD: the JAX Module's momentum states over a mesh of two
    # contexts meet its single-device weights and raise there
    mod.fit(it, optimizer="sgd", num_epoch=2, kvstore=kvstore,
            optimizer_params={"learning_rate": 0.1, "wd": 1e-4})
    got_arg, got_aux = mod.get_params()
    out = {k: v.asnumpy() for k, v in got_arg.items()}
    out.update((k, v.asnumpy()) for k, v in got_aux.items())
    it.reset()
    out["score"] = np.array(mod.score(it, "acc")[0][1])
    return out


@pytest.mark.parametrize("name", sorted(_SYMS))
@pytest.mark.parametrize("kvstore", ["device", "dist_sync", "dist_async"])
def test_module_fit_over_two_contexts(name, kvstore):
    """`Module.fit` over ``[cpu(0), cpu(1)]`` against the JAX Module over
    the same contexts (its dp mesh: whole-batch moments), with every
    kvstore name the JAX Module takes, each run as the ``device`` store."""
    got = _both(lambda pkg: _fit(pkg, name, _ctxs(pkg), kvstore))
    one = _fit(mx, name, [mx.cpu(0)], "device")
    for k in one:
        np.testing.assert_array_equal(got[k], one[k], err_msg=k)


def test_module_refuses_contexts_on_distinct_devices():
    import torch

    if torch.cuda.is_available():
        pytest.skip("needs a machine without a card: cpu and gpu contexts "
                    "there resolve to two devices on purpose")
    with pytest.raises(MXNetError, match="no CUDA device"):
        mx.mod.Module(_mlp_sym(mx), context=[mx.cpu(0), mx.gpu(0)])


# -- executor_manager -------------------------------------------------------

def test_data_parallel_executor_manager():
    """The JAX package's test_symbol_module.py case: one executor a
    context over its slice, the gradients per slice, their sum in context
    order, `copy_to`, the metric over both slices."""
    rng = np.random.RandomState(0)
    X = rng.randn(16, 6).astype(np.float32)
    Y = (X[:, :3].argmax(1)).astype(np.float32)
    init = None

    def run(pkg):
        nonlocal init
        from importlib import import_module

        em = import_module(pkg.__name__ + ".executor_manager")
        assert em._split_input_slice(10, [1, 1]) == [slice(0, 5),
                                                     slice(5, 10)]
        assert em._split_input_slice(9, [2, 1]) == [slice(0, 6),
                                                    slice(6, 9)]
        it = pkg.io.NDArrayIter(X, Y, batch_size=8,
                                label_name="softmax_label")
        data = pkg.sym.var("data")
        h = pkg.sym.relu(pkg.sym.FullyConnected(data=data, num_hidden=8,
                                                name="fc1"))
        out = pkg.sym.SoftmaxOutput(
            pkg.sym.FullyConnected(data=h, num_hidden=3, name="fc2"),
            pkg.sym.var("softmax_label"), name="softmax")
        names = ["fc1_weight", "fc1_bias", "fc2_weight", "fc2_bias"]
        mgr = em.DataParallelExecutorManager(out, _ctxs(pkg), it,
                                             param_names=names)
        shapes = dict(zip(out.list_arguments(), out.infer_shape(
            data=(8, 6), softmax_label=(8,))[0]))
        if init is None:
            prng = np.random.RandomState(1)
            init = {n: prng.uniform(-0.1, 0.1, shapes[n]).astype(np.float32)
                    for n in names}
        mgr.set_params({n: pkg.nd.array(v) for n, v in init.items()}, {})
        metric = pkg.metric.Accuracy()
        res = {}
        for i, batch in enumerate(it):
            mgr.load_data_batch(batch)
            mgr.forward(is_train=True)
            mgr.backward()
            mgr.update_metric(metric, batch.label)
            for n, grads in zip(names, mgr.grad_arrays):
                assert len(grads) == 2
                for j, g in enumerate(grads):
                    res["b%d %s@%d" % (i, n, j)] = g.asnumpy()
                total = grads[0].asnumpy()
                for g in grads[1:]:
                    total = total + g.asnumpy()
                res["b%d %s sum" % (i, n)] = total
        res["acc"] = np.array(metric.get()[1])
        args, auxs = {}, {}
        mgr.copy_to(args, auxs)
        res.update(("copy " + k, v.asnumpy()) for k, v in args.items())
        return res

    got = _both(run)
    np.testing.assert_allclose(got["copy fc1_weight"], init["fc1_weight"],
                               rtol=1e-6)
