"""Word-LM training with the port's Gluon façade: the counterpart of the JAX
package's ``examples/rnn/word_lm.py`` (reference: example/rnn/word_lm),
with its flags and defaults, plus ``--device`` and ``--seed``.

    python -m mxnet_tpu_torch.train_word_lm [--vocab 200] [--batch-size 16]
        [--bptt 32] [--epochs 2] [--lr 0.01] [--limit-batches N]
        [--device cuda|cpu] [--seed 0]

It trains `gluon.model_zoo.word_lm.RNNModel` (embedding 64, one LSTM layer
of 128, no dropout; Xavier weights from ``--seed``) with truncated BPTT on
the example's synthetic second-order Markov corpus: each window runs
forward under ``autograd.record()`` with the state carried (detached) from
the window before, then ``loss.backward()`` and ``trainer.step`` (Adam).
On the card the LSTM layers run the forward and backward kernels of
``csrc/lstm.cu``. ``--device`` defaults to the card; a run on the host
must ask for ``--device cpu``.
"""
from __future__ import annotations

import argparse

import numpy as np

from . import autograd, context
from . import initializer as init
from . import ndarray as nd
from .gluon import Trainer, loss as gloss, utils as gutils
from .gluon.model_zoo.word_lm import RNNModel

__all__ = ["synth_corpus", "batchify", "train_epoch", "main"]


def synth_corpus(vocab=200, length=20000, seed=0):
    """Second-order Markov text: learnable structure, perplexity well
    below the vocabulary (the JAX example's generator)."""
    rng = np.random.RandomState(seed)
    trans = rng.dirichlet(np.ones(vocab) * 0.05, size=vocab)
    data = [0]
    for _ in range(length - 1):
        data.append(rng.choice(vocab, p=trans[data[-1]]))
    return np.asarray(data, np.int32)


def batchify(data, batch_size):
    """(T, B) columns of the stream."""
    n = len(data) // batch_size
    return data[:n * batch_size].reshape(batch_size, n).T


def train_epoch(model, trainer, loss, corpus, bptt, batch_size, ctx=None,
                state=None, start=0, limit_batches=0, clip=None,
                flat_loss=False):
    """Truncated-BPTT training over the windows of ``corpus`` (T, B): each
    window of ``bptt`` steps (from the ``start``-th, at most
    ``limit_batches`` of them when nonzero) runs the model under
    ``autograd.record()`` on the state of the window before, detached, then
    ``backward`` of the loss and a ``trainer.step``. As the JAX example
    does it, the loss is (bptt,) over the (bptt, batch, vocab) output and
    the step ``trainer.step(batch_size * bptt)``; with ``flat_loss``, as
    the reference's word_lm ``train()`` does it, the loss is one a token
    over the output flattened to (bptt x batch, vocab) and the step
    ``trainer.step(batch_size)``. ``clip`` clips the gradients' global norm
    at ``clip * bptt * batch_size`` (the reference's rule for gradients
    summed over the tokens). Returns the windows' mean losses (floats)
    and the last state."""
    ctx = context.current_context() if ctx is None else ctx
    if state is None:
        state = model.begin_state(batch_size, ctx=ctx)
    steps = list(range(0, corpus.shape[0] - bptt - 1, bptt))[start:]
    if limit_batches:
        steps = steps[:limit_batches]
    grads = None
    losses = []
    for t in steps:
        x = nd.array(corpus[t:t + bptt], ctx=ctx, dtype="int32")
        y = nd.array(corpus[t + 1:t + bptt + 1].astype(np.float32), ctx=ctx)
        state = [s.detach() for s in state]
        with autograd.record():
            out, state = model(x, state)
            if flat_loss:
                lval = loss(out.reshape((-1, out.shape[-1])),
                            y.reshape((-1,)))
            else:
                lval = loss(out, y)
        lval.backward()
        if clip:
            if grads is None:
                grads = [p.grad() for p in model.collect_params().values()
                         if p.grad_req != "null"]
            gutils.clip_global_norm(grads, clip * bptt * batch_size)
        trainer.step(batch_size if flat_loss else batch_size * bptt)
        losses.append(float(lval.asnumpy().mean()))
    return losses, state


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--vocab", type=int, default=200)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--bptt", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--limit-batches", type=int, default=0,
                    help="cap bptt windows per epoch (CI smoke configs)")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights")
    args = ap.parse_args(argv)

    dev = context.resolve_device(args.device)
    corpus = batchify(synth_corpus(args.vocab), args.batch_size)
    with context.scope(dev):
        model = RNNModel(vocab_size=args.vocab, embed_size=64,
                         hidden_size=128, num_layers=1, dropout=0.0)
        model.initialize(init.Xavier(), ctx=dev, seed=args.seed)
        trainer = Trainer(model.collect_params(), "adam",
                          {"learning_rate": args.lr})
        ce = gloss.SoftmaxCrossEntropyLoss()
        ppls = []
        for epoch in range(args.epochs):
            losses, _ = train_epoch(model, trainer, ce, corpus, args.bptt,
                                    args.batch_size, ctx=dev,
                                    limit_batches=args.limit_batches)
            ppls.append(float(np.exp(np.mean(losses))))
            print("epoch %d: perplexity %.1f (uniform would be %d)"
                  % (epoch, ppls[-1], args.vocab))
    return ppls


if __name__ == "__main__":
    main()
