"""The deployment path of the PyTorch port (`HybridBlock.export`,
`gluon.SymbolBlock`, `predict.Predictor` and its bucket clones) against the
JAX package's, on the CPU, at small sizes.

Three nets are built in both packages with the same full parameter names
and the same values (drawn from a seed with numpy): the MLP of
``examples/serving/serve_mlp.py`` (Dense(32, relu) -> Dense(4)), a conv
net (Conv2D -> BatchNorm with nonzero running statistics -> relu ->
MaxPool2D -> GlobalAvgPool2D -> Flatten -> Dense) and the same with the
fused BatchNorm(act_type="relu"). Each package exports its net; the
port's `SymbolBlock.imports` and `Predictor` load both artifacts and the
JAX package's load the port's; every output agrees with the JAX net's own forward within rtol 1e-5, atol 1e-6
(the deploy tests' tolerance). Around it: `reshape`, PartialOut, clones
binding the prototype's weight tensors with private inputs, the parts that
are not ported yet raising, and the shared unpad helper.
"""
import threading

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.base import unpad_outputs as jax_unpad
from mxnet_tpu.predict import Predictor as JaxPredictor

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import base as tbase
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.module import base_module
from mxnet_tpu_torch.predict import (CompiledPredictor, Predictor,
                                     _capi_create, _clone_with,
                                     load_ndarray_file)

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture
def cpu():
    with mx.context.scope(mx.cpu()):
        yield


def _mlp(m):
    net = m.gluon.nn.HybridSequential(prefix="mlp_")
    with net.name_scope():
        net.add(m.gluon.nn.Dense(32, activation="relu", in_units=16),
                m.gluon.nn.Dense(4, in_units=32))
    return net


def _conv(m, fused=False):
    nn = m.gluon.nn
    net = nn.HybridSequential(prefix="conv_")
    with net.name_scope():
        net.add(nn.Conv2D(4, 3, in_channels=2))
        if fused:
            net.add(nn.BatchNorm(in_channels=4, act_type="relu"))
        else:
            net.add(nn.BatchNorm(in_channels=4), nn.Activation("relu"))
        net.add(nn.MaxPool2D(2), nn.GlobalAvgPool2D(), nn.Flatten(),
                nn.Dense(5, in_units=4))
    return net


NETS = {"mlp": (_mlp, (16,)), "conv": (_conv, (2, 8, 8)),
        "conv_fused": (lambda m: _conv(m, fused=True), (2, 8, 8))}


def _pair(name, seed=0):
    """The net in both packages with the same values (running variances
    positive); returns (jax net, port net, input)."""
    build, shape = NETS[name]
    jnet, tnet = build(jmx), build(mx)
    jnet.initialize(ctx=jmx.cpu())
    tnet.initialize(ctx=mx.cpu())
    rng = np.random.RandomState(seed)
    jparams, tparams = jnet.collect_params(), tnet.collect_params()
    assert sorted(jparams.keys()) == sorted(tparams.keys())
    for k in sorted(jparams.keys()):
        v = rng.randn(*jparams[k].shape).astype(np.float32) * 0.5
        if k.endswith("running_var"):
            v = np.abs(v) + 0.5
        jparams[k].set_data(jmx.nd.array(v))
        tparams[k].set_data(v)
    x = rng.randn(3, *shape).astype(np.float32)
    return jnet, tnet, x


def _exported(tmp_path, name):
    jnet, tnet, x = _pair(name)
    want = jnet(jmx.nd.array(x)).asnumpy()
    prefixes = {"jax": str(tmp_path / "jax"), "port": str(tmp_path / "port")}
    jnet.export(prefixes["jax"])
    tnet.export(prefixes["port"])
    return prefixes, x, want


@pytest.mark.parametrize("name", sorted(NETS))
def test_exported_nets_load_and_predict_in_both_packages(cpu, tmp_path,
                                                         name):
    prefixes, x, want = _exported(tmp_path, name)
    shapes = {"data": x.shape}
    for writer, prefix in prefixes.items():
        sym, params = prefix + "-symbol.json", prefix + "-0000.params"
        what = "%s export of %s" % (writer, name)
        sb = mx.gluon.SymbolBlock.imports(sym, ["data"], params,
                                          ctx=mx.cpu())
        np.testing.assert_allclose(sb(mx.nd.array(x)).asnumpy(), want,
                                   rtol=RTOL, atol=ATOL, err_msg=what)
        got = Predictor(sym, params, input_shapes=shapes).forward(data=x)
        np.testing.assert_allclose(got.get_output(0).asnumpy(), want,
                                   rtol=RTOL, atol=ATOL, err_msg=what)
        assert got.get_output_shape(0) == want.shape
        if writer == "jax":
            continue   # the JAX package's own tests load its exports
        jsb = jmx.gluon.SymbolBlock.imports(sym, ["data"], params,
                                            ctx=jmx.cpu())
        np.testing.assert_allclose(jsb(jmx.nd.array(x)).asnumpy(), want,
                                   rtol=RTOL, atol=ATOL, err_msg=what)
        jgot = JaxPredictor(sym, params, input_shapes=shapes).forward(data=x)
        np.testing.assert_allclose(jgot.get_output(0).asnumpy(), want,
                                   rtol=RTOL, atol=ATOL, err_msg=what)


def test_export_writes_the_jax_packages_files(cpu, tmp_path):
    """The same node ops and arguments in both graphs; the params file's
    keys (``arg:`` weights, ``aux:`` running statistics) and values
    equal."""
    prefixes, _, _ = _exported(tmp_path, "conv")
    graphs = {w: jmx.sym.load(p + "-symbol.json")
              for w, p in prefixes.items()}
    for fn in ("list_arguments", "list_auxiliary_states"):
        assert getattr(graphs["jax"], fn)() == getattr(graphs["port"], fn)()
    files = {w: jmx.nd.load(p + "-0000.params")
             for w, p in prefixes.items()}
    assert sorted(files["jax"]) == sorted(files["port"])
    assert "aux:conv_batchnorm0_running_mean" in files["port"]
    for k, v in files["jax"].items():
        np.testing.assert_array_equal(files["port"][k].asnumpy(),
                                      v.asnumpy(), err_msg=k)


def test_predictor_reshape_partial_out_and_symbol_input(cpu, tmp_path):
    prefixes, x, _ = _exported(tmp_path, "mlp")
    sym, params = prefixes["jax"] + "-symbol.json", \
        prefixes["jax"] + "-0000.params"
    jnet, _, _ = _pair("mlp")
    x5 = np.random.RandomState(4).randn(5, 16).astype(np.float32)
    pred = Predictor(sym, params, input_shapes={"data": (3, 16)})
    weight = pred._args["mlp_dense0_weight"]._data
    pred.reshape({"data": (5, 16)})
    assert pred._args["mlp_dense0_weight"]._data is weight
    np.testing.assert_allclose(
        pred.forward(data=x5).get_output(0).asnumpy(),
        jnet(jmx.nd.array(x5)).asnumpy(), rtol=RTOL, atol=ATOL)
    with pytest.raises(MXNetError, match="declared"):
        pred.set_input("data", x)
    with pytest.raises(MXNetError, match="not inputs"):
        pred.reshape({"label": (5,)})
    # PartialOut: the relu's output, as the JAX predictor gives it
    relu = [n for n in mx.sym.load(sym).get_internals().list_outputs()
            if n.endswith("_output") and ("relu" in n or "activation" in n)]
    assert relu
    part = Predictor(sym, params, input_shapes={"data": (3, 16)},
                     output_names=[relu[-1]]).forward(data=x)
    jpart = JaxPredictor(sym, params, input_shapes={"data": (3, 16)},
                         output_names=[relu[-1]]).forward(data=x)
    assert part.num_outputs == 1
    np.testing.assert_allclose(part.get_output(0).asnumpy(),
                               jpart.get_output(0).asnumpy(), rtol=RTOL,
                               atol=ATOL)
    assert (part.get_output(0).asnumpy() >= 0).all()
    # a Symbol and JSON text load as the file does
    for src in (mx.sym.load(sym), open(sym).read()):
        got = Predictor(src, params, input_shapes={"data": (3, 16)})
        np.testing.assert_array_equal(
            got.forward(data=x).get_output(0).asnumpy(),
            Predictor(sym, params, input_shapes={"data": (3, 16)})
            .forward(data=x).get_output(0).asnumpy())
    with pytest.raises(MXNetError, match="not in graph"):
        Predictor(sym, params, input_shapes={"data": (3, 16)},
                  output_names=["nope_output"])
    with pytest.raises(MXNetError, match="input_shapes"):
        Predictor(sym, params)
    with pytest.raises(MXNetError, match="neither a param"):
        Predictor(sym, None, input_shapes={"data": (3, 16)})
    pred.free()
    with pytest.raises(MXNetError, match="forward"):
        pred.get_output(0)


def test_clones_share_weights_and_never_bleed(cpu, tmp_path):
    """Clones at other batch sizes bind the prototype's weight tensors (the
    same storage) and private input buffers; four threads driving four
    clones concurrently each get their own input's answer (the JAX
    package's no-bleed test)."""
    prefixes, _, _ = _exported(tmp_path, "conv")
    sym, params = prefixes["port"] + "-symbol.json", \
        prefixes["port"] + "-0000.params"
    proto = Predictor(sym, params, input_shapes={"data": (2, 2, 8, 8)})
    clones = [_clone_with(proto, {"data": (b, 2, 8, 8)}, shared=proto)
              for b in (1, 2, 2, 4)]
    for c in clones:
        for name, arr in proto._args.items():
            same = c._args[name]._data.data_ptr() == arr._data.data_ptr()
            assert same == (name != "data"), name
        for name, arr in proto._aux_bound.items():
            assert c._aux_bound[name]._data.data_ptr() == \
                arr._data.data_ptr()
    rng = np.random.RandomState(7)
    inputs = [rng.randn(c._input_shapes["data"][0], 2, 8, 8)
              .astype(np.float32) for c in clones]
    solo = Predictor(sym, params, input_shapes={"data": (1, 2, 8, 8)})
    want = []
    for x in inputs:
        want.append(np.concatenate([solo.forward(data=x[i:i + 1])
                                    .get_output(0).asnumpy()
                                    for i in range(len(x))]))
    proto_in = proto._args["data"]._data.clone()
    errors = []
    barrier = threading.Barrier(len(clones))

    def worker(i):
        try:
            with mx.context.scope(mx.cpu()):
                barrier.wait(timeout=30)
                for _ in range(10):
                    got = clones[i].forward(data=inputs[i]).get_output(0)
                    np.testing.assert_allclose(got.asnumpy(), want[i],
                                               rtol=RTOL, atol=ATOL)
        except Exception as e:   # reported on the main thread
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(clones))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors, errors[0]
    assert proto._args["data"]._data.equal(proto_in)


def test_int_inputs_are_cast_to_the_declared_dtype(cpu, tmp_path):
    """Token ids declared int32 are bound, and written by `set_input`, as
    int32 whatever the caller passes; params load from bytes too."""
    emb = mx.sym.Embedding(mx.sym.var("data"), input_dim=6, output_dim=3,
                           name="emb")
    w = np.arange(18, dtype=np.float32).reshape(6, 3)
    prefix = str(tmp_path / "emb")
    mx.model.save_checkpoint(prefix, 0, emb, {"emb_weight": mx.nd.array(w)},
                             {})
    with open(prefix + "-0000.params", "rb") as f:
        raw = f.read()
    pred = Predictor(emb.tojson(), raw, input_shapes={"data": (2, 2)},
                     input_dtypes={"data": "int32"})
    int32 = tbase.torch_dtype("int32")
    assert pred._args["data"]._data.dtype == int32
    out = pred.forward(data=[[1.0, 5.0], [0.0, 2.0]]).get_output(0)
    np.testing.assert_array_equal(out.asnumpy(), w[[[1, 5], [0, 2]]])
    assert pred._args["data"]._data.dtype == int32
    loaded = load_ndarray_file(raw)
    np.testing.assert_array_equal(loaded["arg:emb_weight"].asnumpy(), w)
    np.testing.assert_array_equal(
        jmx.predict.load_ndarray_file(raw)["arg:emb_weight"].asnumpy(), w)


def test_layers_without_a_symbol_form_and_unported_parts_raise(cpu,
                                                                tmp_path):
    net = mx.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(mx.gluon.nn.Dense(4, in_units=3),
                mx.gluon.nn.Lambda("relu"))
    net.initialize(ctx=mx.cpu())
    with pytest.raises(MXNetError, match="Lambda has no symbol form"):
        net.export(str(tmp_path / "ln"))
    lstm = mx.gluon.rnn.LSTM(4, input_size=3)
    lstm.initialize(ctx=mx.cpu())
    with pytest.raises(MXNetError, match="LSTM has no symbol form"):
        lstm(mx.sym.var("data"))
    prefixes, x, _ = _exported(tmp_path, "mlp")
    pred = Predictor(prefixes["port"] + "-symbol.json",
                     prefixes["port"] + "-0000.params",
                     input_shapes={"data": (3, 16)})
    for call in (pred.export_compiled, lambda: CompiledPredictor.load(b""),
                 lambda: _capi_create("{}", b"", 1, 0, {})):
        with pytest.raises(MXNetError, match="not ported yet"):
            call()


def test_unpad_outputs_is_one_helper_shared_with_module():
    """`Module.predict` and the batcher unpad through `base.unpad_outputs`,
    which matches the JAX package's helper."""
    assert base_module.unpad_outputs is tbase.unpad_outputs
    a = np.arange(12, dtype=np.float32).reshape(6, 2)
    for pad in (0, 2, 5):
        for copy in (False, True):
            got = tbase.unpad_outputs([a], pad, copy=copy)
            want = jax_unpad([a], pad, copy=copy)
            np.testing.assert_array_equal(got[0], want[0])
            assert (got[0] is a) == (want[0] is a)
    with mx.context.scope(mx.cpu()):
        (out,) = tbase.unpad_outputs([mx.nd.array(a)], 3, copy=True)
    assert out.shape == (3, 2)
