"""The word-LM path of the PyTorch port against the JAX package, on the CPU:
the RNN op, the gluon recurrent layers, `RNNModel` and one
`DistributedTrainer` SGD step, as bench.py's ``bench_lstm`` drives them.

The JAX side runs its LSTM layers through its Pallas kernels in interpret
mode (``MXTPU_PALLAS_LSTM=1``, set by monkeypatch, as
tests/test_pallas.py does); GRU and vanilla RNN layers run its lax.scan.
The port runs the plain versions its kernel wrappers take for CPU tensors,
and its step loop for the other modes. Inputs and weights are made with
numpy from a seed and handed to both (the JAX models' weights are carried
over by `convert.word_lm_params_from_jax`). The card-only tests are in
tests/test_torch_port_cuda.py.

Tolerances: f32 rtol 1e-4 with an absolute floor of 1e-4 x the largest
magnitude of the compared tensor (both sides compute in f32 and sum in
other orders); bf16 2e-2 the same way (one bf16 rounding step is 2^-8
relative, and the two frameworks round the bf16 products of the input
projection, the decoder and the loss at places that differ by a step or
two).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.gluon.model_zoo.word_lm import RNNModel as JRNNModel

from mxnet_tpu_torch import convert, nd, rtc
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon import rnn as trnn
from mxnet_tpu_torch.gluon.model_zoo.word_lm import RNNModel
from mxnet_tpu_torch.ops import pallas_kernels as tpk
from mxnet_tpu_torch.ops import rnn as tops
from mxnet_tpu_torch.parallel import DistributedTrainer

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
VOCAB, EMBED, HIDDEN, LAYERS, SEQ, BATCH = 50, 16, 24, 2, 6, 3


@pytest.fixture
def pallas_lstm(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS_LSTM", "1")


def _close(got, want, tol, what="", scale=0.0):
    """|got - want| <= tol * |want| + tol * max(max|want|, scale)."""
    got = np.asarray(torch.as_tensor(got).detach().float(), np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    floor = tol * max(float(np.max(np.abs(want))), scale, 1e-30)
    np.testing.assert_allclose(got, want, rtol=tol, atol=floor,
                               err_msg=what)


def _jparams(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


@pytest.mark.parametrize("mode,layers,bidir", [
    ("lstm", 2, False), ("lstm", 2, True), ("lstm", 1, False),
    ("gru", 2, True), ("rnn_relu", 2, False), ("rnn_tanh", 1, True)])
@pytest.mark.parametrize("state_outputs", [True, False])
def test_rnn_op_matches_jax(pallas_lstm, mode, layers, bidir,
                            state_outputs):
    """The op over one flat parameter vector (the cuDNN layout) against
    ``mx.nd.RNN``: LSTM through the kernel route on both sides, the other
    modes through the step loop / lax.scan; the output, and hN (and cN)."""
    rng = np.random.RandomState(4)
    t, b, i, h = 5, 3, 4, 7
    dirs = 2 if bidir else 1
    size = tops.rnn_param_size(layers, i, h, bidir, mode)
    data = rng.randn(t, b, i).astype(np.float32)
    par = (rng.randn(size) * 0.3).astype(np.float32)
    h0 = (rng.randn(layers * dirs, b, h) * 0.5).astype(np.float32)
    c0 = (rng.randn(layers * dirs, b, h) * 0.5).astype(np.float32)
    kw = dict(state_size=h, num_layers=layers, mode=mode,
              bidirectional=bidir, state_outputs=state_outputs)
    jin = [mx.nd.array(a) for a in (data, par, h0)]
    tin = [torch.from_numpy(a) for a in (data, par, h0)]
    if mode == "lstm":
        jin.append(mx.nd.array(c0))
        tin.append(torch.from_numpy(c0))
    want = mx.nd.RNN(*jin, **kw)
    want = want if isinstance(want, (list, tuple)) else [want]
    got = tops.rnn(*tin, **kw)
    n_out = 1 + (state_outputs and (2 if mode == "lstm" else 1))
    assert len(got) == len(want) == n_out
    for name, a, w in zip(("out", "hN", "cN"), got, want):
        _close(a, w.asnumpy(), TOL["float32"], name)


def test_rnn_op_parameter_size_and_state_zeros():
    assert tops.rnn_param_size(2, 650, 650, False, "lstm") == 6770400
    with pytest.raises(MXNetError, match="flat vector"):
        tops.rnn(torch.zeros(2, 1, 3), torch.zeros(10), torch.zeros(1, 1, 4),
                 torch.zeros(1, 1, 4), state_size=4)
    with pytest.raises(MXNetError, match="mode"):
        tops.rnn_param_size(1, 3, 4, False, "lstmp")
    z = tops.rnn_state_zeros(torch.zeros(3, 7, dtype=torch.bfloat16), (2, 5))
    assert z.shape == (3, 2, 5) and z.dtype == torch.bfloat16
    assert not z.any()


def test_inter_layer_dropout_keep_rate_and_scaling(monkeypatch):
    """Dropout between layers in training only, by its distribution (the
    JAX package's threefry bits cannot be matched): about 1 - p of the
    first layer's outputs kept, each scaled by 1 / (1 - p), drawn from the
    generator passed in; none after the last layer."""
    seen = []
    real = tops._nn.dropout

    def spy(x, p, is_train=False, generator=None):
        y = real(x, p, is_train=is_train, generator=generator)
        seen.append((x, y, generator))
        return y

    monkeypatch.setattr(tops._nn, "dropout", spy)
    rng = np.random.RandomState(0)
    t, b, i, h = 20, 16, 8, 64
    size = tops.rnn_param_size(2, i, h, False, "lstm")
    args = (torch.from_numpy(rng.randn(t, b, i).astype(np.float32)),
            torch.from_numpy((rng.randn(size) * 0.3).astype(np.float32)),
            torch.zeros(2, b, h), torch.zeros(2, b, h))
    gen = torch.Generator().manual_seed(1)
    tops.rnn(*args, state_size=h, num_layers=2, p=0.3, is_train=True,
             generator=gen)
    assert len(seen) == 1 and seen[0][2] is gen
    x, y, _ = seen[0]
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.02
    torch.testing.assert_close(y[kept], x[kept] / 0.7)
    tops.rnn(*args, state_size=h, num_layers=2, p=0.3, is_train=False)
    assert len(seen) == 1


def _jax_layer(cls, bidir, layout, **kw):
    layer = cls(HIDDEN, num_layers=2, bidirectional=bidir, layout=layout,
                input_size=EMBED, **kw)
    layer.initialize(mx.init.Xavier())
    return layer


@pytest.mark.parametrize("kind,bidir,layout", [
    ("LSTM", False, "TNC"), ("LSTM", True, "NTC"), ("GRU", True, "TNC"),
    ("RNN", False, "NTC")])
def test_gluon_layers_match_jax(pallas_lstm, kind, bidir, layout):
    """The port's RNN / LSTM / GRU layers against the JAX layers, from the
    same weights (same parameter names): with and without states, in both
    layouts."""
    np.random.seed(2)
    jlayer = _jax_layer(getattr(jgluon.rnn, kind), bidir, layout)
    tlayer = getattr(trnn, kind)(HIDDEN, num_layers=2, bidirectional=bidir,
                                 layout=layout, input_size=EMBED,
                                 device="cpu")
    jp = {k.split("_", 1)[1]: v for k, v in _jparams(jlayer).items()}
    tlayer.load_state_dict({k: torch.tensor(v) for k, v in jp.items()},
                           strict=True)
    rng = np.random.RandomState(3)
    shape = (SEQ, BATCH, EMBED) if layout == "TNC" else (BATCH, SEQ, EMBED)
    x = rng.randn(*shape).astype(np.float32)
    _close(tlayer(torch.from_numpy(x)), jlayer(mx.nd.array(x)).asnumpy(),
           TOL["float32"], "out")
    states = [(rng.randn(2 * (2 if bidir else 1), BATCH, HIDDEN) * 0.5)
              .astype(np.float32)
              for _ in range(2 if kind == "LSTM" else 1)]
    jout, jst = jlayer(mx.nd.array(x), [mx.nd.array(s) for s in states])
    tout, tst = tlayer(torch.from_numpy(x),
                       [torch.from_numpy(s) for s in states])
    _close(tout, jout.asnumpy(), TOL["float32"], "out with states")
    assert len(tst) == len(jst) == len(states)
    for i, (a, w) in enumerate(zip(tst, jst)):
        _close(a, w.asnumpy(), TOL["float32"], "state %d" % i)
    assert [s.shape for s in tlayer.begin_state(4)] == \
        [(2 * (2 if bidir else 1), 4, HIDDEN)] * len(states)


def test_gluon_layer_contract():
    # input_size 0 is taken from the first input (deferred initialisation)
    layer = trnn.LSTM(8, device="cpu")
    assert layer._held("l0_i2h_weight") is None \
        and layer.l0_h2h_weight.shape == (32, 8)
    layer.initialize(ctx="cpu")
    layer(torch.zeros(3, 2, 5))
    assert layer._held("l0_i2h_weight").shape == (32, 5)
    # each parameter's own initializer wins over initialize's
    layer = trnn.LSTM(8, input_size=4, i2h_weight_initializer="uniform",
                      h2h_bias_initializer="lstmbias", device="cpu")
    layer.initialize("xavier", seed=0)
    with torch.no_grad():
        assert float(layer._held("l0_i2h_weight").abs().max()) <= 0.07
        assert float(layer._held("l0_h2h_weight").abs().max()) > 0.07
        np.testing.assert_array_equal(
            layer._held("l0_h2h_bias").numpy(), np.repeat([0.0, 1.0, 0.0, 0.0], 8))
    with pytest.raises(MXNetError, match="layout"):
        trnn.GRU(8, input_size=4, layout="NCT", device="cpu")
    layer = trnn.LSTM(8, num_layers=2, input_size=4, device="cpu")
    assert [n for n, _ in layer.named_parameters()][:4] == [
        "l0_i2h_weight", "l0_h2h_weight", "l0_i2h_bias", "l0_h2h_bias"]
    assert layer._held("l1_i2h_weight").shape == (32, 8)


def _model_pair(seed, tie=False, hidden=HIDDEN):
    np.random.seed(seed)
    jnet = JRNNModel(VOCAB, EMBED, hidden, LAYERS, dropout=0.0,
                     tie_weights=tie)
    jnet.initialize(mx.init.Xavier())
    jnet(mx.nd.zeros((1, 1), dtype="int32"))
    tnet = RNNModel(VOCAB, EMBED, hidden, LAYERS, dropout=0.0,
                    tie_weights=tie, device="cpu")
    before = convert.word_lm_params_from_jax(_jparams(jnet))
    tnet.load_state_dict(before, strict=True)
    return jnet, tnet, before


@pytest.mark.parametrize("tie", [False, True])
def test_word_lm_forward_matches_jax(pallas_lstm, tie):
    """`RNNModel` (vocab 50, embed 16, hidden 24 or tied 16, 2 layers) on
    (6, 3) token ids: logits without a state, then logits and the final
    (h, c) with a state carried from the first call, as truncated-BPTT
    evaluation runs it; the LSTM's infer route on the port's side."""
    jnet, tnet, _ = _model_pair(5, tie=tie, hidden=EMBED if tie else HIDDEN)
    if tie:
        assert tnet.decoder.weight is tnet.embedding.weight
    rng = np.random.RandomState(6)
    tokens = rng.randint(0, VOCAB, (2, SEQ, BATCH)).astype(np.int32)
    launched = tpk.lstm_infer.launches
    with torch.no_grad():
        tlogits = tnet(torch.from_numpy(tokens[0]))
        tstate = tnet.begin_state(BATCH)
        for w in tokens:
            tout, tstate = tnet(torch.from_numpy(w), tstate)
    assert tpk.lstm_infer.launches == launched   # CPU: plain versions
    _close(tlogits, jnet(mx.nd.array(tokens[0], dtype="int32")).asnumpy(),
           TOL["float32"], "logits")
    jstate = jnet.begin_state(BATCH)
    for w in tokens:
        jout, jstate = jnet(mx.nd.array(w, dtype="int32"), jstate)
    _close(tout, jout.asnumpy(), TOL["float32"], "logits with state")
    for name, a, w in zip(("h", "c"), tstate, jstate):
        _close(a, w.asnumpy(), TOL["float32"], name)


@pytest.mark.parametrize("amp", [None, "bfloat16"])
def test_word_lm_trainer_step_matches_jax(pallas_lstm, amp):
    """One SGD step (lr 1.0, bench_lstm's optimizer) of the small word LM
    through each package's DistributedTrainer, on (T, B) token ids with
    (T, B) labels and bench_lstm's softmax cross-entropy over (-1, vocab):
    the loss, every parameter after the step and the change the step made
    (each held to tol x the step's largest change as well); under bf16 AMP
    the f32 master weights, at the bf16 tolerance."""
    from mxnet_tpu.parallel import DistributedTrainer as JTrainer
    from mxnet_tpu.parallel import make_mesh

    class SeqCE(jgluon.loss.SoftmaxCrossEntropyLoss):
        def hybrid_forward(self, F, pred, label):
            return super().hybrid_forward(
                F, pred.reshape((-1, VOCAB)), label.reshape((-1,)))

    jnet, tnet, before = _model_pair(7)
    mesh = make_mesh([("dp", 1)], devices=jax.devices()[:1])
    jtr = JTrainer(jnet, "sgd", {"learning_rate": 1.0}, loss=SeqCE(),
                   mesh=mesh, amp_dtype=amp)
    ce = tloss.SoftmaxCrossEntropyLoss()
    ttr = DistributedTrainer(
        tnet, "sgd", {"learning_rate": 1.0},
        loss=lambda p, y: ce(p.reshape(-1, VOCAB), y.reshape(-1)),
        amp_dtype=amp)
    rng = np.random.RandomState(8)
    tokens = rng.randint(0, VOCAB, (SEQ, BATCH)).astype(np.int32)
    labels = rng.randint(0, VOCAB, (SEQ, BATCH)).astype(np.float32)
    jl = float(jtr.step(mx.nd.array(tokens, dtype="int32"),
                        mx.nd.array(labels)).asnumpy())
    launched = tpk.lstm_fwd.launches
    tl = ttr.step(torch.from_numpy(tokens), torch.from_numpy(labels))
    assert tpk.lstm_fwd.launches == launched   # CPU: plain versions
    tol = TOL[amp or "float32"]
    _close(float(tl), jl, tol, "loss")
    jtr.sync_params()
    want = convert.word_lm_params_from_jax(_jparams(jnet))
    state = tnet.state_dict()
    assert sorted(state) == sorted(want)
    assert all(v.dtype == torch.float32 for v in state.values())
    big = max(float((want[k] - before[k]).abs().max()) for k in want)
    for k in want:
        _close(state[k], want[k], tol, k, big)
        _close(state[k] - before[k], want[k] - before[k], tol,
               "change of " + k, big)


def test_word_lm_params_from_jax_raises_on_what_it_cannot_place():
    np.random.seed(0)
    jnet = JRNNModel(VOCAB, EMBED, HIDDEN, LAYERS, dropout=0.0)
    jnet.initialize(mx.init.Xavier())
    jnet(mx.nd.zeros((1, 1), dtype="int32"))
    params = _jparams(jnet)
    assert len(convert.word_lm_params_from_jax(params)) == len(params) == 11
    key = next(k for k in params if k.endswith("decoder_bias"))
    for bad in ({**params, key.replace("decoder", "encoder"): 0},
                {k: v for k, v in params.items() if k != key},
                {**params, "rnnmodel9_embed_weight": 0},
                {**params, key.replace("decoder_bias", "embed_bias"): 0}):
        with pytest.raises(MXNetError):
            convert.word_lm_params_from_jax(bad)


def test_full_width_word_lm_counts_as_the_jax_model():
    """bench_lstm's RNNModel(10000, 650, 650, 2): 19,780,400 parameters in
    both packages, under the same names."""
    jnet = JRNNModel(10000, 650, 650, 2, dropout=0.0)
    jnet.initialize(mx.init.Xavier())
    jnet(mx.nd.zeros((1, 1), dtype="int32"))
    params = _jparams(jnet)
    tnet = RNNModel(10000, 650, 650, 2, dropout=0.0, device="cpu")
    assert sum(p.numel() for p in tnet.parameters()) == 19780400
    assert sum(v.size for v in params.values()) == 19780400
    state = convert.word_lm_params_from_jax(params)
    assert sorted(state) == sorted(tnet.state_dict())
    tnet.initialize(seed=0)
    with torch.no_grad():
        assert float(tnet.rnn._held("l1_h2h_bias").abs().max()) == 0.0
        bound = np.sqrt(3.0 / ((650 + 2600) / 2.0))   # Xavier on (4H, H)
        assert 0.9 * bound < float(
            tnet.rnn._held("l1_h2h_weight").abs().max()) \
            <= bound


def test_entry_points_need_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="device='cpu'"):
        RNNModel(VOCAB, EMBED, HIDDEN, LAYERS)
    with pytest.raises(MXNetError, match="device='cpu'"):
        trnn.LSTM(HIDDEN, input_size=EMBED)
    for make in (lambda: nd.zeros((2,)), lambda: nd.array([1.0])):
        with pytest.raises(MXNetError, match="device='cpu'"):
            make()
    with pytest.raises(MXNetError, match="needs a CUDA card"):
        rtc.CudaModule('extern "C" __global__ void k(float *y) {}')
