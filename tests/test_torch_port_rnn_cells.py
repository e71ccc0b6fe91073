"""The symbolic RNN API of the PyTorch port (`mx.rnn`: the cells,
`FusedRNNCell` over the ``RNN`` op, `BucketSentenceIter`, the checkpoint
helpers; `BucketingModule`; the ``FusedRNN`` initializer; the
``train_lstm_bucketing`` entry point) against the JAX package's, on the
CPU, at small sizes.

The bucketing LM: vocab 30, embedding 6, a FusedRNNCell of 2 x 8 LSTM
units (or a SequentialRNNCell of LSTMCells), buckets (4, 6), batch 4, over
48 sentences of 3 to 6 tokens from the JAX example's chain (12 batches);
Python's `random` and numpy's global generator, which the iterator
shuffles with, are seeded alike before each package's iterator and `fit`,
so both see the same batches. The JAX module is initialised (Xavier and
FusedRNN), its parameters carried to the port by
`convert.module_params_from_jax`, and both `fit` (SGD with momentum) for
one epoch. The JAX side runs its LSTM through its Pallas kernels in
interpret mode (``MXTPU_PALLAS_LSTM=1``, by monkeypatch); the port runs the
plain versions its kernel wrappers take for CPU tensors. Weights, the
training metric and the score agree within rtol 1e-4 with an absolute
floor of 1e-4 x the largest magnitude (f32 on both sides, summed in other
orders). Graph JSON is compared exactly.
"""
import json
import random

import numpy as np
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.train_lstm_bucketing import main as entry_point

TOL = 1e-4
VOCAB, EMBED, HIDDEN, LAYERS, BATCH, BUCKETS = 30, 6, 8, 2, 4, (4, 6)


@pytest.fixture
def cpu():
    with mx.context.scope(mx.cpu()):
        yield


@pytest.fixture
def pallas_lstm(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS_LSTM", "1")


def _close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    floor = TOL * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=floor, err_msg=what)


def _seed(seed):
    random.seed(seed)
    np.random.seed(seed)


def _sentences(seed, n):
    """``n`` sentences of 3 to 6 tokens (1 .. VOCAB - 1; 0 pads) from the
    JAX example's chain, so every one fits a bucket."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        tok = int(rng.randint(1, VOCAB))
        sent = []
        for _ in range(int(rng.randint(3, 7))):
            sent.append(tok)
            tok = (tok * 2 + int(rng.randint(0, 2))) % VOCAB or 1
        out.append(sent)
    return out


def sym_gen(m, fused=True, layout="NTC"):
    """The bucketing LM of the reference's cudnn_lstm_bucketing.py in
    package ``m``."""
    if fused:
        cell = m.rnn.FusedRNNCell(HIDDEN, num_layers=LAYERS, mode="lstm",
                                  prefix="lstm_")
    else:
        cell = m.rnn.SequentialRNNCell()
        for i in range(LAYERS):
            cell.add(m.rnn.LSTMCell(HIDDEN, prefix="lstm_l%d_" % i))

    def gen(seq_len):
        embed = m.sym.Embedding(m.sym.var("data"), input_dim=VOCAB,
                                output_dim=EMBED, name="embed")
        cell.reset()
        out, _ = cell.unroll(seq_len, inputs=embed, layout=layout,
                             merge_outputs=True)
        pred = m.sym.FullyConnected(m.sym.Reshape(out, shape=(-1, HIDDEN)),
                                    num_hidden=VOCAB, name="pred")
        label = m.sym.Reshape(m.sym.var("softmax_label"), shape=(-1,))
        return (m.sym.SoftmaxOutput(pred, label, name="softmax"),
                ("data",), ("softmax_label",))
    return gen


def _iters(m, seed):
    _seed(seed)
    train = m.rnn.BucketSentenceIter(_sentences(0, 48), BATCH,
                                     buckets=list(BUCKETS), invalid_label=0)
    val = m.rnn.BucketSentenceIter(_sentences(1, 16), BATCH,
                                   buckets=list(BUCKETS), invalid_label=0)
    assert sorted({b for b, _ in zip(train.buckets, train.data)}) == \
        list(BUCKETS) and len(train.idx) >= 10
    return train, val


def test_bucket_sentence_iter_batches_match_jax(cpu):
    jtrain, _ = _iters(jmx, 3)
    ttrain, _ = _iters(mx, 3)
    assert ttrain.buckets == jtrain.buckets
    assert ttrain.default_bucket_key == jtrain.default_bucket_key
    for epoch in range(2):
        _seed(10 + epoch)
        jtrain.reset()
        jb = list(jtrain)
        _seed(10 + epoch)
        ttrain.reset()
        tb = list(ttrain)
        assert [b.bucket_key for b in tb] == [b.bucket_key for b in jb]
        for j, t in zip(jb, tb):
            np.testing.assert_array_equal(t.data[0].asnumpy(),
                                          j.data[0].asnumpy())
            np.testing.assert_array_equal(t.label[0].asnumpy(),
                                          j.label[0].asnumpy())
            assert [tuple(d) for d in t.provide_data] == \
                [tuple(d) for d in j.provide_data]


@pytest.mark.parametrize("fused", [True, False])
def test_bucketing_module_fit_matches_jax(cpu, pallas_lstm, fused):
    jtrain, jval = _iters(jmx, 0)
    ttrain, tval = _iters(mx, 0)
    key = jtrain.default_bucket_key
    jbm = jmx.mod.BucketingModule(sym_gen(jmx, fused), default_bucket_key=key,
                                  context=jmx.cpu())
    tbm = mx.mod.BucketingModule(sym_gen(mx, fused), default_bucket_key=key,
                                 context=mx.cpu())
    jbm.bind(jtrain.provide_data, jtrain.provide_label)
    _seed(1)
    jbm.init_params(jmx.init.Xavier())
    tbm.bind(ttrain.provide_data, ttrain.provide_label)
    arg, aux = convert.module_params_from_jax(*jbm.get_params(), mx.cpu())
    tbm.init_params(arg_params=arg, aux_params=aux)
    opt = {"learning_rate": 0.1, "momentum": 0.9}
    metrics = []
    for bm, train, m in ((jbm, jtrain, jmx), (tbm, ttrain, mx)):
        metric = m.metric.Perplexity(0)
        _seed(2)
        bm.fit(train, eval_metric=metric, optimizer="sgd",
               optimizer_params=opt, num_epoch=1)
        metrics.append(metric.get()[1])
    _close(metrics[1], metrics[0], "training perplexity")
    jarg, targ = jbm.get_params()[0], tbm.get_params()[0]
    assert sorted(targ) == sorted(jarg)
    for k in jarg:
        _close(targ[k].asnumpy(), jarg[k].asnumpy(), "after fit: " + k)
    _seed(3)
    (_, jppl), = jbm.score(jval, jmx.metric.Perplexity(0))
    _seed(3)
    (_, tppl), = tbm.score(tval, mx.metric.Perplexity(0))
    _close(tppl, jppl, "score")
    # every bucket's executor holds the default bucket's arrays
    default = tbm._buckets[key]._exec
    for k, module in tbm._buckets.items():
        assert module._exec._graph is None
        for name in module._param_names:
            assert module._exec.arg_dict[name] is default.arg_dict[name]
            assert module._exec.grad_dict[name] is default.grad_dict[name]


def test_switching_buckets_drops_the_kept_graph(cpu):
    train, _ = _iters(mx, 4)
    bm = mx.mod.BucketingModule(sym_gen(mx), default_bucket_key=6,
                                context=mx.cpu())
    bm.bind(train.provide_data, train.provide_label)
    bm.init_params(mx.init.Xavier())
    batches = {b.bucket_key: b for b in train}
    bm.forward(batches[6], is_train=True)
    first = bm._curr_module._exec
    assert first._graph is not None
    bm.forward(batches[4], is_train=True)
    assert first._graph is None and bm._curr_module._exec._graph is not None


def _fused_pair(mode="lstm", bidirectional=False):
    cells = []
    for m in (jmx, mx):
        with m.name.NameManager():
            cells.append(m.rnn.FusedRNNCell(HIDDEN, num_layers=LAYERS,
                                            mode=mode, prefix="rnn_",
                                            bidirectional=bidirectional))
    return cells


@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh"])
def test_fused_cell_unpack_pack_and_unfuse_match_jax(cpu, mode):
    jcell, tcell = _fused_pair(mode)
    outs = []
    for m, cell in ((jmx, jcell), (mx, tcell)):
        with m.name.NameManager():
            outs.append(cell.unroll(5, m.sym.var("data"), layout="NTC",
                                    merge_outputs=True)[0])
    assert json.loads(outs[1].tojson()) == json.loads(outs[0].tojson())
    size = outs[1].infer_shape(data=(3, 5, 4))[0][1][0]
    flat = np.random.RandomState(2).randn(size).astype(np.float32)
    jun = jcell.unpack_weights({"rnn_parameters": jmx.nd.array(flat)})
    tun = tcell.unpack_weights({"rnn_parameters": mx.nd.array(flat)})
    assert sorted(tun) == sorted(jun)
    for k in jun:
        np.testing.assert_array_equal(tun[k].asnumpy(), jun[k].asnumpy())
    packed = tcell.pack_weights(tun)["rnn_parameters"].asnumpy()
    np.testing.assert_array_equal(packed, flat)
    junf, tunf = jcell.unfuse(), tcell.unfuse()
    graphs = []
    for m, cell in ((jmx, junf), (mx, tunf)):
        with m.name.NameManager():
            graphs.append(cell.unroll(5, m.sym.var("data"), layout="NTC",
                                      merge_outputs=True)[0])
    assert json.loads(graphs[1].tojson()) == json.loads(graphs[0].tojson())
    # the unfused stack computes what the fused op does
    fused_ex = outs[1].simple_bind(data=(3, 5, 4))
    fused_ex.arg_dict["rnn_parameters"][:] = mx.nd.array(flat)
    unf_ex = graphs[1].simple_bind(data=(3, 5, 4))
    for k, v in tunf.pack_weights(tun).items():
        unf_ex.arg_dict[k][:] = v
    x = np.random.RandomState(3).randn(3, 5, 4).astype(np.float32)
    np.testing.assert_allclose(unf_ex.forward(data=x)[0].asnumpy(),
                               fused_ex.forward(data=x)[0].asnumpy(),
                               rtol=1e-5, atol=1e-6)
    # a bidirectional stack unfuses into the JAX package's graph too
    bi = []
    for m, cell in zip((jmx, mx), _fused_pair(mode, bidirectional=True)):
        with m.name.NameManager():
            bi.append(cell.unfuse().unroll(5, m.sym.var("data"),
                                           layout="NTC",
                                           merge_outputs=True)[0])
    assert json.loads(bi[1].tojson()) == json.loads(bi[0].tojson())


@pytest.mark.parametrize("cell", ["RNNCell", "LSTMCell", "GRUCell"])
def test_unrolled_cells_match_jax(cpu, cell):
    syms = []
    for m in (jmx, mx):
        with m.name.NameManager():
            stack = m.rnn.SequentialRNNCell()
            for i in range(2):
                stack.add(getattr(m.rnn, cell)(HIDDEN, prefix="c%d_" % i))
            syms.append(stack.unroll(4, m.sym.var("data"), layout="NTC",
                                     merge_outputs=True)[0])
    js, ts = syms
    assert json.loads(ts.tojson()) == json.loads(js.tojson())
    shapes = {"data": (3, 4, 5)}
    rng = np.random.RandomState(4)
    values = {n: rng.uniform(-0.5, 0.5, s).astype(np.float32)
              for n, s in zip(ts.list_arguments(),
                              ts.infer_shape(**shapes)[0])}
    jex = js.simple_bind(ctx=jmx.cpu(), **shapes)
    tex = ts.simple_bind(**shapes)
    jex.copy_params_from({k: jmx.nd.array(v) for k, v in values.items()})
    tex.copy_params_from({k: mx.nd.array(v) for k, v in values.items()})
    np.testing.assert_allclose(tex.forward()[0].asnumpy(),
                               jex.forward()[0].asnumpy(),
                               rtol=1e-5, atol=1e-6)


def test_fused_rnn_initializer(cpu):
    """The forget-gate biases are exactly forget_bias, every other bias 0,
    and the weights are the JAX package's Uniform(0.07) by distribution."""
    _, tcell = _fused_pair()
    size = 4 * HIDDEN * (EMBED + HIDDEN + 2) + 4 * HIDDEN * (2 * HIDDEN + 2)
    init = mx.init.FusedRNN(None, HIDDEN, LAYERS, "lstm", forget_bias=1.5)
    arr = mx.nd.zeros((size,))
    mx.random.seed(0)
    init(mx.init.InitDesc("rnn_parameters"), arr)
    jarr = np.zeros((size,), np.float32)
    np.random.seed(0)
    jmx.init.FusedRNN(None, HIDDEN, LAYERS, "lstm", forget_bias=1.5)._init_weight(
        jmx.init.InitDesc("rnn_parameters"), jarr)
    parts = {}
    for name, flat in (("port", arr), ("jax", mx.nd.array(jarr))):
        parts[name] = {k: v.asnumpy() for k, v in tcell.unpack_weights(
            {"rnn_parameters": flat}).items()}
    for k, v in parts["port"].items():
        if k.endswith("_f_bias") and "i2h" in k:
            assert (v == 1.5).all() and (parts["jax"][k] == 1.5).all(), k
        elif k.endswith("_f_bias"):
            assert (v == 1.5).all(), k
        elif k.endswith("bias"):
            assert (v == 0).all() and (parts["jax"][k] == 0).all(), k
    w = np.concatenate([v.ravel() for k, v in parts["port"].items()
                        if k.endswith("weight")])
    jw = np.concatenate([v.ravel() for k, v in parts["jax"].items()
                         if k.endswith("weight")])
    assert np.abs(w).max() <= 0.07 and np.abs(jw).max() <= 0.07
    assert abs(w.std() - jw.std()) < 0.1 * jw.std()
    assert abs(w.mean()) < 0.01 and abs(jw.mean()) < 0.01
    # the symbol's __init__ attr is the JAX package's
    jcell, _ = _fused_pair()
    assert tcell._parameter.attr("__init__") == \
        jcell._parameter.attr("__init__")


def test_rnn_checkpoints_cross_both_ways(cpu, tmp_path):
    jcell, tcell = _fused_pair()
    with mx.name.NameManager():
        out = tcell.unroll(3, mx.sym.var("data"), layout="NTC",
                           merge_outputs=True)[0]
    size = out.infer_shape(data=(2, 3, 5))[0][1][0]
    flat = np.random.RandomState(6).randn(size).astype(np.float32)
    prefix = str(tmp_path / "rnn")
    mx.rnn.save_rnn_checkpoint(tcell, prefix, 1, out,
                               {"rnn_parameters": mx.nd.array(flat)}, {})
    _, jargs, _ = jmx.rnn.load_rnn_checkpoint(jcell, prefix, 1)
    np.testing.assert_array_equal(jargs["rnn_parameters"].asnumpy(), flat)
    _, targs, _ = mx.rnn.load_rnn_checkpoint(tcell, prefix, 1)
    np.testing.assert_array_equal(targs["rnn_parameters"].asnumpy(), flat)
    raw = mx.model.load_params("%s-0001.params" % prefix)[0]
    assert "rnn_l0_i2h_f_weight" in raw and "rnn_parameters" not in raw


def test_entry_point_runs_on_the_cpu_and_needs_a_card_by_default():
    ppl = entry_point(["--device", "cpu", "--fused", "--num-epochs", "1",
                       "--sentences", "40", "--buckets", "8,12",
                       "--num-hidden", "8", "--num-embed", "6"])
    assert np.isfinite(ppl)
    with pytest.raises(MXNetError, match="no CUDA device"):
        entry_point(["--num-epochs", "1"])
