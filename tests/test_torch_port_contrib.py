"""The rest of the port's `contrib/` (not ONNX) against the JAX package's, on
the CPU: the ``mx.contrib.ndarray`` / ``symbol`` namespace aliases, the
legacy autograd API, `DataLoaderIter`, the SVRG trainer on one data set
(the losses within rtol 1e-5 of the JAX trainer's from the same weights:
the same float32 arithmetic in another order), `text` from files written
under ``tmp_path`` (vectors equal), the TensorRT surface, and
``mx.contrib.onnx`` exposed as the JAX package exposes it.
"""
import collections

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.contrib import autograd as jcag
from mxnet_tpu.contrib import text as jtext

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.contrib import autograd as cag
from mxnet_tpu_torch.contrib import ndarray as cnd
from mxnet_tpu_torch.contrib import symbol as csym
from mxnet_tpu_torch.contrib import text as ctext


@pytest.fixture(autouse=True)
def cpu():
    with mx.context.scope(mx.cpu()):
        yield


def test_contrib_op_namespace_aliases():
    for name in ("MultiBoxPrior", "quantize_v2", "quantized_conv",
                 "dequantize", "box_nms"):
        assert getattr(cnd, name) is getattr(mx.nd.contrib, name), name
        assert getattr(csym, name) is getattr(mx.sym.contrib, name), name
        assert name in dir(cnd) and name in dir(csym)
    assert mx.contrib.ndarray is cnd and mx.contrib.symbol is csym


def test_grad_and_loss_and_grad_equal_jax():
    def f(a, b):
        return a * b + a

    av = np.array([2.0, 3.0], np.float32)
    bv = np.array([4.0, 5.0], np.float32)
    out = {}
    for m, g in ((jmx, jcag), (mx, cag)):
        a, b = m.nd.array(av), m.nd.array(bv)
        grads, loss = g.grad_and_loss(f)(a, b)
        ga, = g.grad(f, argnum=0)(a, b)
        out[m] = [np.asarray(x.asnumpy()) for x in grads + [loss, ga]]
    for got, want in zip(out[mx], out[jmx]):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(out[mx][0], bv + 1)


def test_train_test_sections():
    with cag.train_section():
        assert mx.autograd.is_training()
        assert mx.autograd.is_recording()
        with cag.test_section():
            assert not mx.autograd.is_recording()
        assert mx.autograd.is_recording()
    assert not mx.autograd.is_recording()


def test_scope_restores_diverged_flags():
    with mx.autograd.train_mode():
        assert mx.autograd.is_training() and not mx.autograd.is_recording()
        with cag.train_section():
            pass
        assert mx.autograd.is_training()
        assert not mx.autograd.is_recording()


def test_mark_variables_and_compute_gradient():
    x = mx.nd.array(np.array([1.0, 2.0], np.float32))
    g = mx.nd.zeros((2,))
    cag.mark_variables([x], [g])
    prev = cag.set_is_training(True)
    try:
        y = (x * x).sum()
    finally:
        cag.set_is_training(prev)
    cag.compute_gradient([y])
    np.testing.assert_allclose(g.asnumpy(), 2 * x.asnumpy())


def test_dataloader_iter():
    from mxnet_tpu_torch.contrib.io import DataLoaderIter
    from mxnet_tpu_torch.gluon.data import ArrayDataset, DataLoader

    X = np.random.RandomState(0).uniform(size=(20, 4)).astype(np.float32)
    y = np.arange(20).astype(np.float32)
    loader = DataLoader(ArrayDataset(X, y), batch_size=5)
    it = DataLoaderIter(loader)
    assert it.provide_data[0].shape == (5, 4)
    assert it.provide_label[0].shape == (5,)
    batches = list(it)
    assert len(batches) == 4
    np.testing.assert_array_equal(
        np.concatenate([b.data[0].asnumpy() for b in batches]), X)
    np.testing.assert_array_equal(
        np.concatenate([b.label[0].asnumpy() for b in batches]), y)
    it.reset()
    assert len(list(it)) == 4


def _svrg_losses(m, ctx):
    """The JAX package's SVRG test, from weights drawn with numpy: 6
    epochs of 4 batches of 16, a snapshot every 2 epochs."""
    from importlib import import_module

    SVRGTrainer = import_module(
        m.__name__ + ".contrib.svrg_optimization").SVRGTrainer
    gluon, autograd = m.gluon, m.autograd
    rng = np.random.RandomState(0)
    X = rng.uniform(-1, 1, (64, 5)).astype(np.float32)
    w_true = rng.uniform(-1, 1, (5, 1)).astype(np.float32)
    w0 = rng.uniform(-0.5, 0.5, (1, 5)).astype(np.float32)
    Y = X @ w_true
    net = gluon.nn.Dense(1, use_bias=False, in_units=5)
    net.initialize(ctx=ctx)
    lossfn = gluon.loss.L2Loss()
    xs, ys = m.nd.array(X, ctx=ctx), m.nd.array(Y, ctx=ctx)
    net(xs)
    trainer = SVRGTrainer(net.collect_params(), learning_rate=0.2)
    trainer._params[0].data()._set_data(m.nd.array(w0, ctx=ctx)._data)

    def grads_on(snapshot_params, xb, yb, scale):
        saved = [p.data().asnumpy() for p in trainer._params]
        for p, s in zip(trainer._params, snapshot_params):
            p.data()._set_data(s._data)
        with autograd.record():
            L = lossfn(net(xb), yb)
        L.backward()
        out = [(p.grad() * scale).copy() for p in trainer._params]
        for p, s in zip(trainer._params, saved):
            p.data()._set_data(m.nd.array(s, ctx=ctx)._data)
        return out

    losses = []
    for epoch in range(6):
        if epoch % 2 == 0:
            trainer.take_snapshot(
                lambda snap: grads_on(snap, xs, ys, 1.0 / X.shape[0]))
        for i in range(0, 64, 16):
            xb, yb = xs[i:i + 16], ys[i:i + 16]
            with autograd.record():
                L = lossfn(net(xb), yb)
            L.backward()
            trainer.step(16, lambda snap, xb=xb, yb=yb:
                         grads_on(snap, xb, yb, 1.0))
            losses.append(float(L.mean().asscalar()))
    return np.asarray(losses), trainer._params[0].data().asnumpy()


def test_svrg_trainer_equals_jax():
    want, w_want = _svrg_losses(jmx, jmx.cpu())
    got, w_got = _svrg_losses(mx, mx.cpu())
    assert got[-1] < got[0] * 0.2, got
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(w_got, w_want, rtol=1e-5, atol=1e-7)


def test_svrg_trainer_refuses_without_parameters():
    from mxnet_tpu_torch.contrib.svrg_optimization import SVRGTrainer

    with pytest.raises(MXNetError, match="no trainable"):
        SVRGTrainer([])


# -- text ----------------------------------------------------------------------

def test_text_vocab_equals_jax():
    text = "a b b c c c\nd d d d\ne"
    for kw in ({}, {"min_freq": 2}, {"most_freq_count": 2},
               {"reserved_tokens": ["<pad>"]}):
        got = ctext.Vocabulary(ctext.count_tokens_from_str(text), **kw)
        want = jtext.Vocabulary(jtext.count_tokens_from_str(text), **kw)
        assert got.idx_to_token == want.idx_to_token, kw
        assert got.to_indices(["d", "zzz", "b"]) == \
            want.to_indices(["d", "zzz", "b"])
    with pytest.raises(MXNetError):
        ctext.Vocabulary(min_freq=0)


def test_text_embeddings_from_local_files_equal_jax(tmp_path):
    root = tmp_path / "embeddings"
    (root / "glove").mkdir(parents=True)
    (root / "glove" / "glove.6B.50d.txt").write_text(
        "the 0.1 0.2 0.3\nof 0.4 0.5 0.6\n<unk> 9 9 9\n")
    (root / "fasttext").mkdir()
    (root / "fasttext" / "wiki.simple.vec").write_text(
        "2 3\nhello 1 2 3\nworld 4 5 6\n")
    custom = tmp_path / "emb.txt"
    custom.write_text("x 1 2\ny 3 4\nhello 5 6\n")
    vocab_counter = collections.Counter("x y z hello".split())
    tokens = ["the", "of", "zzz", "hello", "world", "x", "HELLO"]

    def build(t):
        glove = t.create("glove", pretrained_file_name="glove.6B.50d.txt",
                         embedding_root=str(root))
        with pytest.warns(UserWarning):
            ft = t.FastText(pretrained_file_name="wiki.simple.vec",
                            embedding_root=str(root))
        cust = t.CustomEmbedding(str(custom))
        vocab = t.Vocabulary(vocab_counter)
        scoped = t.CustomEmbedding(str(custom), vocabulary=vocab)
        comp = t.CompositeEmbedding(vocab, [cust, ft])
        cust.update_token_vectors("x", np.array([7.0, 8.0], np.float32))
        return [e.get_vecs_by_tokens(tokens, lower_case_backup=True)
                .asnumpy() for e in (glove, ft, cust, scoped, comp)]

    for got, want in zip(build(ctext), build(jtext)):
        np.testing.assert_array_equal(got, np.asarray(want))
    assert ctext.get_pretrained_file_names() == \
        jtext.get_pretrained_file_names()
    with pytest.raises(MXNetError, match="never downloads"):
        ctext.GloVe(pretrained_file_name="glove.6B.100d.txt",
                    embedding_root=str(root))


# -- surfaces that redirect or wait ---------------------------------------------

def test_tensorrt_surface_redirects():
    from mxnet_tpu_torch.contrib import tensorrt as trt

    assert trt.get_use_tensorrt() is False
    trt.set_use_tensorrt(False)
    with pytest.raises(MXNetError, match="Predictor"):
        trt.set_use_tensorrt(True)
    with pytest.raises(MXNetError, match="Predictor"):
        trt.tensorrt_bind(None, None, {})


def test_onnx_is_not_ported_yet():
    """ONNX is ported now (`tests/test_torch_port_interop.py` holds it to
    the JAX package): ``mx.contrib.onnx`` is the module, as the JAX
    package's is, and the old "not ported" error is gone."""
    from mxnet_tpu_torch.contrib import onnx

    assert mx.contrib.onnx is onnx
    assert sorted(onnx.__all__) == ["export_model", "get_model_metadata",
                                    "import_model"]
    with pytest.raises(AttributeError):
        mx.contrib.no_such_module  # noqa: B018
