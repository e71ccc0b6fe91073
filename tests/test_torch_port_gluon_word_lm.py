"""The JAX package's word-LM example loop (``examples/rnn/word_lm.py``:
truncated BPTT, the state carried and detached from window to window,
``autograd.record()`` / ``loss.backward()`` / ``trainer.step()`` with
Adam) against the port's `train_word_lm.train_epoch`, on the CPU, at small
width: vocab 50, embedding 16, 2 LSTM layers of 24, bptt 6, batch 3, 3
windows. The JAX side runs its LSTM through its Pallas kernels in
interpret mode (``MXTPU_PALLAS_LSTM=1``, set by monkeypatch, as
tests/test_torch_port_word_lm.py does); the port runs the plain versions
its kernel wrappers take for CPU tensors. The port's model gets the JAX
model's weights by `Parameter.set_data`, by structural name.

Each window's loss, the final state and every final weight must agree:
f32 rtol 1e-4 with an absolute floor of 1e-4 x max|want| (both compute in
f32 and sum in other orders, through 3 Adam steps). Also: the façade
routes the LSTM layers to the training path inside ``record()`` and to
the inference path outside it, and the command-line entry point runs.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.gluon.model_zoo.word_lm import RNNModel as JRNNModel

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import gluon, nd
from mxnet_tpu_torch.gluon.model_zoo.word_lm import RNNModel
from mxnet_tpu_torch.ops import pallas_kernels as tpk
from mxnet_tpu_torch.train_word_lm import batchify, synth_corpus, train_epoch

TOL = 1e-4
VOCAB, EMBED, HIDDEN, LAYERS, BPTT, BATCH, WINDOWS = 50, 16, 24, 2, 6, 3, 3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def pallas_lstm(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS_LSTM", "1")


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.context.scope(mx.cpu()):
        yield


def _close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    floor = TOL * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=TOL, atol=floor, err_msg=what)


def _pair(seed):
    np.random.seed(seed)
    jnet = JRNNModel(VOCAB, EMBED, HIDDEN, LAYERS, dropout=0.0)
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.zeros((2, BATCH), dtype="int32"))   # its deferred decoder
    tnet = RNNModel(VOCAB, EMBED, HIDDEN, LAYERS, dropout=0.0)
    tnet.initialize()
    jp = jnet._collect_params_with_prefix()
    tp = tnet._collect_params_with_prefix()
    assert sorted(jp) == sorted(tp)
    for k, p in jp.items():
        tp[k].set_data(p.data().asnumpy())
    return jnet, tnet


def _jax_epoch(net, corpus, clip, flat):
    """The JAX example's loop, as examples/rnn/word_lm.py writes it (plus
    the reference's gradient clipping when ``clip`` is set, and with
    ``flat`` the reference's loss a token and ``trainer.step(batch)``)."""
    trainer = jmx.gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": 1e-2})
    ce = jmx.gluon.loss.SoftmaxCrossEntropyLoss()
    state = net.begin_state(BATCH)
    losses = []
    steps = list(range(0, corpus.shape[0] - BPTT - 1, BPTT))[:WINDOWS]
    for t in steps:
        x = jmx.nd.array(corpus[t:t + BPTT], dtype="int32")
        y = jmx.nd.array(corpus[t + 1:t + BPTT + 1].astype(np.float32))
        state = [s.detach() for s in state]
        with jmx.autograd.record():
            out, state = net(x, state)
            if flat:
                loss = ce(out.reshape((-1, VOCAB)), y.reshape((-1,)))
            else:
                loss = ce(out, y)
        loss.backward()
        if clip:
            jmx.gluon.utils.clip_global_norm(
                [p.grad() for p in net.collect_params().values()],
                clip * BPTT * BATCH)
        trainer.step(BATCH if flat else BATCH * BPTT)
        losses.append(float(loss.asnumpy().mean()))
    return losses, state


@pytest.mark.parametrize("clip,flat", [(None, False), (0.25, False),
                                       (0.25, True)])
def test_truncated_bptt_loop_matches_jax(pallas_lstm, clip, flat):
    corpus = batchify(synth_corpus(VOCAB, BATCH * (BPTT * WINDOWS + 8),
                                   seed=1), BATCH)
    jnet, tnet = _pair(2)
    want_losses, want_state = _jax_epoch(jnet, corpus, clip, flat)
    trainer = gluon.Trainer(tnet.collect_params(), "adam",
                            {"learning_rate": 1e-2})
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    losses, state = train_epoch(tnet, trainer, ce, corpus, BPTT, BATCH,
                                ctx=mx.cpu(), limit_batches=WINDOWS,
                                clip=clip, flat_loss=flat)
    assert len(losses) == WINDOWS
    for i, (g, w) in enumerate(zip(losses, want_losses)):
        _close(g, w, "window %d loss" % i)
    for name, g, w in zip(("h", "c"), state, want_state):
        assert isinstance(g, nd.NDArray)
        _close(g.asnumpy(), w.asnumpy(), "final " + name)
    jp = jnet._collect_params_with_prefix()
    for k, p in tnet._collect_params_with_prefix().items():
        _close(p.data().asnumpy(), jp[k].data().asnumpy(), k)
    assert trainer.step_count == WINDOWS


def test_state_is_carried_and_detached():
    """Two calls of train_epoch, the second from the first's state, give
    the same windows as one call over both (the state carries, and each
    window's backward stops at its own first step)."""
    corpus = batchify(synth_corpus(VOCAB, BATCH * (BPTT * 4 + 8), seed=3),
                      BATCH)
    nets = []
    for _ in range(2):
        net = RNNModel(VOCAB, EMBED, HIDDEN, LAYERS, dropout=0.0,
                       prefix="lm_")
        net.initialize(seed=4)
        nets.append(net)
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    trainers = [gluon.Trainer(n.collect_params(), "sgd",
                              {"learning_rate": 0.5}) for n in nets]
    whole, _ = train_epoch(nets[0], trainers[0], ce, corpus, BPTT, BATCH,
                           limit_batches=4)
    first, state = train_epoch(nets[1], trainers[1], ce, corpus, BPTT,
                               BATCH, limit_batches=2)
    assert not any(s._data.requires_grad for s in
                   [s.detach() for s in state])
    rest, _ = train_epoch(nets[1], trainers[1], ce, corpus, BPTT, BATCH,
                          state=state, start=2, limit_batches=2)
    np.testing.assert_allclose(first + rest, whole, rtol=1e-6)


def test_facade_routes_the_lstm_by_recording(monkeypatch):
    """Inside record() each LSTM layer takes the training path (forward
    kernel, backward kernel in the backward); outside it the inference
    kernel. Counted here on their CPU routes."""
    calls = {"infer": 0, "train": 0}
    infer, apply = tpk.lstm_infer, tpk._LSTMLayer.apply

    def spy_infer(*a):
        calls["infer"] += 1
        return infer(*a)

    def spy_apply(*a):
        calls["train"] += 1
        return apply(*a)

    monkeypatch.setattr(tpk, "lstm_infer", spy_infer)
    monkeypatch.setattr(tpk._LSTMLayer, "apply", spy_apply)
    net = RNNModel(VOCAB, EMBED, HIDDEN, LAYERS, dropout=0.0)
    net.initialize(seed=0)
    x = nd.array(np.arange(BPTT * BATCH).reshape(BPTT, BATCH) % VOCAB,
                 dtype="int32")
    state = net.begin_state(BATCH, ctx=mx.cpu())
    with mx.autograd.record():
        out, state = net(x, state)
    assert calls == {"infer": 0, "train": LAYERS}
    assert out._data.requires_grad
    out, state = net(x, [s.detach() for s in state])
    assert calls == {"infer": LAYERS, "train": LAYERS}
    assert not out._data.requires_grad
    # the tensor path keeps torch's own grad mode
    logits = net(torch.from_numpy(x.asnumpy().astype(np.int64)))
    assert logits.requires_grad and calls["train"] == 2 * LAYERS


def test_entry_point_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.train_word_lm", "--device",
         "cpu", "--epochs", "1", "--limit-batches", "2"],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    line = out.stdout.strip().splitlines()[-1]
    assert line.startswith("epoch 0: perplexity")
    assert float(line.split()[3]) < 200 * 1.05
