"""The symbolic training loop of the PyTorch port (`mx.mod.Module`,
`mx.io`, `mx.model`, `mx.callback`, `convert.module_params_from_jax`)
against the JAX package's, on the CPU, at small sizes.

The same graph is composed in both packages (each under a fresh
`NameManager`); the JAX module is initialised (Xavier), its ``get_params()``
carried to the port by `convert.module_params_from_jax`, and both train
with `fit` (SGD with momentum) over an `NDArrayIter` of the same numpy
batches, made from a seed: an MLP and a LeNet (with a BatchNorm) for 3
batches. The weights and aux states after `fit`, then `score` and
`predict`, agree within rtol 1e-4 with an absolute floor of 1e-4 x the
largest magnitude of the compared tensor (both compute in f32 and sum in
other orders). Checkpoint files (``-symbol.json`` and ``.params``) cross
both ways. Also: the iterators against the JAX package's, the parts that
are not ported yet raising (and the ported file iterators raising on a
missing file), and the default device.
"""
import logging

import numpy as np
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.base import MXNetError

TOL = 1e-4
BATCH, NBATCH = 4, 3


@pytest.fixture
def cpu():
    with mx.context.scope(mx.cpu()):
        yield


def _close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    floor = TOL * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=floor, err_msg=what)


def mlp(m):
    net = m.sym.FullyConnected(m.sym.var("data"), num_hidden=16, name="fc1")
    net = m.sym.Activation(net, act_type="relu")
    net = m.sym.FullyConnected(net, num_hidden=5, name="fc2")
    return m.sym.SoftmaxOutput(net, name="softmax")


def lenet(m):
    net = m.sym.Convolution(m.sym.var("data"), kernel=(3, 3), num_filter=4,
                            no_bias=True, name="conv1")
    net = m.sym.BatchNorm(net, fix_gamma=False, name="bn1")
    net = m.sym.Activation(net, act_type="tanh")
    net = m.sym.Pooling(net, kernel=(2, 2), stride=(2, 2), pool_type="max")
    net = m.sym.Convolution(net, kernel=(3, 3), num_filter=6, name="conv2")
    net = m.sym.Activation(net, act_type="tanh")
    net = m.sym.Pooling(net, kernel=(2, 2), stride=(2, 2), pool_type="max")
    net = m.sym.Flatten(net)
    net = m.sym.FullyConnected(net, num_hidden=12, name="fc1")
    net = m.sym.Activation(net, act_type="tanh")
    net = m.sym.FullyConnected(net, num_hidden=5, name="fc2")
    return m.sym.SoftmaxOutput(net, name="softmax")


NETS = {"mlp": (mlp, (7,)), "lenet": (lenet, (1, 14, 14))}


def _data(shape, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(BATCH * NBATCH, *shape).astype(np.float32)
    y = rng.randint(0, 5, (BATCH * NBATCH,)).astype(np.float32)
    return x, y


def _build(m, name):
    with m.name.NameManager():
        return NETS[name][0](m)


def _jax_module(name, x, y, seed=0):
    """The JAX module bound to the iterator's shapes and Xavier-initialised
    (numpy's global generator, seeded)."""
    it = jmx.io.NDArrayIter(x, y, batch_size=BATCH)
    mod = jmx.mod.Module(_build(jmx, name), context=jmx.cpu())
    mod.bind(it.provide_data, it.provide_label)
    np.random.seed(seed)
    mod.init_params(jmx.init.Xavier())
    return mod, it


def _port_module(name, x, y, jmod):
    it = mx.io.NDArrayIter(x, y, batch_size=BATCH)
    mod = mx.mod.Module(_build(mx, name), context=mx.cpu())
    mod.bind(it.provide_data, it.provide_label)
    arg, aux = convert.module_params_from_jax(*jmod.get_params(), mx.cpu())
    mod.init_params(arg_params=arg, aux_params=aux)
    return mod, it


def _same_params(tmod, jmod, what):
    (targ, taux), (jarg, jaux) = tmod.get_params(), jmod.get_params()
    assert sorted(targ) == sorted(jarg) and sorted(taux) == sorted(jaux)
    for k in jarg:
        _close(targ[k].asnumpy(), jarg[k].asnumpy(), "%s: %s" % (what, k))
    for k in jaux:
        _close(taux[k].asnumpy(), jaux[k].asnumpy(), "%s: %s" % (what, k))


@pytest.mark.parametrize("name", sorted(NETS))
def test_fit_score_and_predict_match_jax(cpu, name):
    x, y = _data(NETS[name][1], seed=len(name))
    jmod, jit = _jax_module(name, x, y)
    tmod, tit = _port_module(name, x, y, jmod)
    _same_params(tmod, jmod, "before fit")
    opt = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
    jmod.fit(jit, optimizer="sgd", optimizer_params=opt, num_epoch=1)
    tmod.fit(tit, optimizer="sgd", optimizer_params=opt, num_epoch=1)
    _same_params(tmod, jmod, "after fit")
    assert tmod._optimizer.rescale_grad == jmod._optimizer.rescale_grad \
        == 1.0 / BATCH
    for metric in ("acc", "ce"):
        (jn, jv), = jmod.score(jit, metric)
        (tn, tv), = tmod.score(tit, metric)
        assert tn == jn
        _close(tv, jv, metric)
    _close(tmod.predict(tit).asnumpy(), jmod.predict(jit).asnumpy(),
           "predict")


def test_input_grads_and_reshape(cpu):
    """inputs_need_grad gives the data's gradient as the JAX module does;
    reshape keeps the parameters."""
    x, y = _data(NETS["mlp"][1], seed=3)
    batch_j = jmx.io.DataBatch([jmx.nd.array(x[:BATCH])],
                               [jmx.nd.array(y[:BATCH])])
    batch_t = mx.io.DataBatch([mx.nd.array(x[:BATCH])],
                              [mx.nd.array(y[:BATCH])])
    jmod, jit = _jax_module("mlp", x, y)
    jmod.bind(jit.provide_data, jit.provide_label, inputs_need_grad=True,
              force_rebind=True)
    jmod.init_params(jmx.init.Xavier(), force_init=True)
    tmod = mx.mod.Module(_build(mx, "mlp"), context=mx.cpu())
    tmod.bind([("data", (BATCH, 7))], [("softmax_label", (BATCH,))],
              inputs_need_grad=True)
    arg, aux = convert.module_params_from_jax(*jmod.get_params(), mx.cpu())
    tmod.init_params(arg_params=arg, aux_params=aux)
    jmod.forward_backward(batch_j)
    tmod.forward_backward(batch_t)
    _close(tmod.get_input_grads()[0].asnumpy(),
           jmod.get_input_grads()[0].asnumpy(), "input grads")
    before = tmod.get_params()[0]
    tmod.reshape([("data", (2, 7))], [("softmax_label", (2,))])
    tmod.forward(mx.io.DataBatch([mx.nd.array(x[:2])],
                                 [mx.nd.array(y[:2])]), is_train=False)
    assert tmod.get_outputs()[0].shape == (2, 5)
    for k, v in tmod.get_params()[0].items():
        np.testing.assert_array_equal(v.asnumpy(), before[k].asnumpy())


def test_module_params_from_jax_gives_the_same_score(cpu):
    x, y = _data(NETS["lenet"][1], seed=5)
    jmod, jit = _jax_module("lenet", x, y, seed=1)
    jmod.fit(jit, optimizer="sgd", optimizer_params={"learning_rate": 0.05},
             num_epoch=1)       # moves the BatchNorm's moving statistics
    arg, aux = convert.module_params_from_jax(*jmod.get_params(), mx.cpu())
    assert all(isinstance(v, mx.nd.NDArray) and v.context == mx.cpu()
               for v in list(arg.values()) + list(aux.values()))
    tit = mx.io.NDArrayIter(x, y, batch_size=BATCH)
    tmod = mx.mod.Module(_build(mx, "lenet"), context=mx.cpu())
    tmod.bind(tit.provide_data, tit.provide_label, for_training=False)
    tmod.set_params(arg, aux)
    (_, jv), = jmod.score(jit, "ce")
    (_, tv), = tmod.score(tit, "ce")
    _close(tv, jv, "score")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_files_cross_both_ways(cpu, tmp_path, writer):
    x, y = _data(NETS["lenet"][1], seed=7)
    jmod, jit = _jax_module("lenet", x, y, seed=2)
    jmod.fit(jit, optimizer="sgd", optimizer_params={"learning_rate": 0.05},
             num_epoch=1)
    tmod, tit = _port_module("lenet", x, y, jmod)
    prefix = str(tmp_path / "lenet")
    if writer == "jax":
        jmod.save_checkpoint(prefix, 3)
        loaded = mx.mod.Module.load(prefix, 3, context=mx.cpu())
        loaded.bind(tit.provide_data, tit.provide_label, for_training=False)
        loaded.init_params()
        got, want = loaded.predict(tit), jmod.predict(jit)
    else:
        tmod.save_checkpoint(prefix, 3)
        loaded = jmx.mod.Module.load(prefix, 3, context=jmx.cpu())
        loaded.bind(jit.provide_data, jit.provide_label, for_training=False)
        loaded.init_params()
        got, want = tmod.predict(tit), loaded.predict(jit)
    _close(got.asnumpy(), want.asnumpy(), "predict after the checkpoint")
    sym, arg, aux = mx.model.load_checkpoint(prefix, 3)
    jsym, jarg, jaux = jmx.model.load_checkpoint(prefix, 3)
    assert sym.tojson() == jsym.tojson()
    for k in jarg:
        np.testing.assert_array_equal(arg[k].asnumpy(), jarg[k].asnumpy())
    for k in jaux:
        np.testing.assert_array_equal(aux[k].asnumpy(), jaux[k].asnumpy())


def test_optimizer_states_and_callbacks(cpu, tmp_path, caplog):
    x, y = _data(NETS["mlp"][1], seed=9)
    it = mx.io.NDArrayIter(x, y, batch_size=BATCH)
    mod = mx.mod.Module(_build(mx, "mlp"), context=mx.cpu())
    prefix = str(tmp_path / "mlp")
    batches = []
    with caplog.at_level(logging.INFO, logger="mxnet_tpu_torch.callback"):
        mod.fit(it, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                num_epoch=2, initializer=mx.init.Xavier(),
                epoch_end_callback=mx.callback.do_checkpoint(prefix),
                batch_end_callback=[mx.callback.Speedometer(BATCH, 1),
                                    lambda p: batches.append(p.nbatch)])
    assert batches == [0, 1, 2] * 2
    assert any("samples/sec" in r.getMessage() for r in caplog.records)
    # epoch-end checkpoints, readable by the JAX package
    jsym, jarg, _ = jmx.model.load_checkpoint(prefix, 2)
    arg = mod.get_params()[0]
    for k, v in jarg.items():
        np.testing.assert_array_equal(v.asnumpy(), arg[k].asnumpy())
    states = str(tmp_path / "mlp.states")
    mod.save_optimizer_states(states)
    again = mx.mod.Module(_build(mx, "mlp"), context=mx.cpu())
    again.bind(it.provide_data, it.provide_label)
    again.init_params(mx.init.Xavier())
    again.init_optimizer(optimizer="sgd",
                         optimizer_params={"learning_rate": 0.1,
                                           "momentum": 0.9})
    again.load_optimizer_states(states)
    for i, s in mod._updater.states.items():
        np.testing.assert_array_equal(
            again._updater.states[i], s.cpu().numpy())


@pytest.mark.parametrize("handle", ["pad", "discard"])
def test_ndarray_iter_matches_jax(cpu, handle):
    rng = np.random.RandomState(4)
    x = rng.randn(10, 3).astype(np.float32)
    y = rng.randint(0, 5, (10,)).astype(np.float32)
    jit = jmx.io.NDArrayIter(x, y, batch_size=4, last_batch_handle=handle)
    tit = mx.io.NDArrayIter(x, y, batch_size=4, last_batch_handle=handle)
    assert [tuple(d) for d in tit.provide_data] == \
        [tuple(d) for d in jit.provide_data]
    for _ in range(2):   # two epochs
        jb, tb = list(jit), list(tit)
        assert len(tb) == len(jb)
        for j, t in zip(jb, tb):
            assert t.pad == j.pad
            np.testing.assert_array_equal(t.data[0].asnumpy(),
                                          j.data[0].asnumpy())
            np.testing.assert_array_equal(t.label[0].asnumpy(),
                                          j.label[0].asnumpy())
        jit.reset()
        tit.reset()
    resized = [b.data[0].asnumpy() for b in mx.io.ResizeIter(tit, 5)]
    want = [b.data[0].asnumpy() for b in jmx.io.ResizeIter(jit, 5)]
    assert len(resized) == 5
    for a, b in zip(resized, want):
        np.testing.assert_array_equal(a, b)


def test_unported_parts_raise(cpu, tmp_path):
    # the file iterators are ported (tests/test_torch_port_data.py); a
    # missing file raises naming it
    for name, kw in (("MNISTIter", {"image": str(tmp_path / "nope"),
                                    "label": str(tmp_path / "nope-l")}),
                     ("CSVIter", {"data_csv": str(tmp_path / "nope"),
                                  "data_shape": (1,)}),
                     ("LibSVMIter", {"data_libsvm": str(tmp_path / "nope"),
                                     "data_shape": (1,)}),
                     ("ImageRecordIter",
                      {"path_imgrec": str(tmp_path / "nope")})):
        with pytest.raises(MXNetError, match="nope"):
            getattr(mx.io, name)(**kw)
    x, y = _data(NETS["mlp"][1], seed=1)
    it = mx.io.NDArrayIter(x, y, batch_size=BATCH)
    mod = mx.mod.Module(_build(mx, "mlp"))
    with pytest.raises(MXNetError, match="item 13"):
        mod.fit(it, num_epoch=1, checkpoint_dir=str(tmp_path))
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(mx.init.Xavier())
    with pytest.raises(MXNetError, match="item 11"):
        mod.init_optimizer(kvstore="dist_sync")
    with pytest.raises(MXNetError, match="item 11"):
        mx.mod.Module(_build(mx, "mlp"), context=[mx.cpu(), mx.cpu()])


def test_module_defaults_to_the_card():
    """Module(context=None) takes current_context: the card unless a scope
    chose the CPU; without a card it raises."""
    sym = _build(mx, "mlp")
    with mx.context.scope(mx.cpu()):
        assert mx.mod.Module(sym)._context == mx.cpu()
    with pytest.raises(MXNetError, match="no CUDA device"):
        mx.mod.Module(sym)
    with pytest.raises(MXNetError, match="no CUDA device"):
        mx.mod.BucketingModule(lambda k: (sym, ("data",),
                                          ("softmax_label",)),
                               default_bucket_key=1).bind(
            [("data", (4, 7))], [("softmax_label", (4,))])
