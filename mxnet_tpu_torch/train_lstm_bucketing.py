"""LSTM language model with bucketing through the symbolic API: the
counterpart of the JAX package's ``examples/rnn/lstm_bucketing.py``
(reference: example/rnn/bucketing/lstm_bucketing.py), with its flags and
defaults, plus the reference's ``cudnn_lstm_bucketing.py`` choice of cell
(``--fused``), ``--device`` and ``--seed``.

    python -m mxnet_tpu_torch.train_lstm_bucketing [--fused]
        [--num-layers 2] [--num-hidden 32] [--num-embed 16]
        [--num-epochs 3] [--lr 0.01] [--optimizer adam]
        [--batch-size 8] [--buckets 8,12,16,20] [--sentences 200]
        [--vocab-size 40] [--device cuda|cpu] [--seed 0]

`mx.rnn.encode_sentences` -> `BucketSentenceIter` -> ``sym_gen(seq_len)``
(Embedding -> a `SequentialRNNCell` of `LSTMCell`s, or with ``--fused`` one
`FusedRNNCell` over the ``RNN`` op -> FullyConnected -> SoftmaxOutput) ->
`BucketingModule.fit` with `metric.Perplexity`, then `score` on the
validation sentences. The corpus is the example's synthetic one (``--data``
reads a token file instead); nothing is downloaded. With ``--fused`` on the
card each LSTM layer runs the ``lstm_fwd`` / ``lstm_bwd`` kernels of
``csrc/lstm.cu`` in training and ``lstm_infer`` in `score`. ``--device``
defaults to the card; a run on the host must ask for ``--device cpu``.
"""
from __future__ import annotations

import argparse
import os
import random

import numpy as np

from . import callback, context
from . import initializer as init
from . import metric
from . import module as mod
from . import random as mx_random
from . import rnn
from . import symbol as sym

__all__ = ["synthetic_corpus", "lm_sym_gen", "main"]


def synthetic_corpus(rs, n_sentences, vocab_size):
    """Markov-ish token sequences so perplexity has structure to learn (the
    JAX example's generator)."""
    sents = []
    for _ in range(n_sentences):
        length = int(rs.randint(4, 18))
        tok = int(rs.randint(1, vocab_size))
        sent = []
        for _ in range(length):
            sent.append("w%d" % tok)
            tok = (tok * 2 + int(rs.randint(0, 2))) % vocab_size or 1
        sents.append(sent)
    return sents


def tokenize_text(fname, vocab=None, invalid_label=-1, start_label=0):
    if not os.path.isfile(fname):
        raise IOError("data file %s not found" % fname)
    with open(fname) as f:
        lines = [list(filter(None, line.split(" ")))
                 for line in f.read().splitlines()]
    return rnn.encode_sentences(lines, vocab=vocab,
                                invalid_label=invalid_label,
                                start_label=start_label)


def lm_sym_gen(vocab, num_embed, num_hidden, num_layers, fused=False,
               layout="NTC"):
    """``sym_gen(seq_len) -> (symbol, data names, label names)`` of the
    bucketing LM: Embedding -> the LSTM stack unrolled over ``seq_len`` in
    ``layout`` ("NTC" for batch-major data, "TNC" for time-major) ->
    Reshape (-1, num_hidden) -> FullyConnected(vocab) -> SoftmaxOutput
    against the labels reshaped to (-1,). ``fused`` takes one
    `FusedRNNCell` (the ``RNN`` op) instead of a `SequentialRNNCell` of
    `LSTMCell`s."""
    if fused:
        cell = rnn.FusedRNNCell(num_hidden, num_layers=num_layers,
                                mode="lstm", prefix="lstm_")
    else:
        cell = rnn.SequentialRNNCell()
        for i in range(num_layers):
            cell.add(rnn.LSTMCell(num_hidden=num_hidden,
                                  prefix="lstm_l%d_" % i))

    def sym_gen(seq_len):
        data = sym.Variable("data")
        label = sym.Variable("softmax_label")
        embed = sym.Embedding(data=data, input_dim=vocab,
                              output_dim=num_embed, name="embed")
        cell.reset()
        outputs = cell.unroll(seq_len, inputs=embed, layout=layout,
                              merge_outputs=True)[0]
        pred = sym.Reshape(outputs, shape=(-1, num_hidden))
        pred = sym.FullyConnected(data=pred, num_hidden=vocab, name="pred")
        label = sym.Reshape(label, shape=(-1,))
        pred = sym.SoftmaxOutput(data=pred, label=label, name="softmax")
        return pred, ("data",), ("softmax_label",)

    return sym_gen


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--num-layers", type=int, default=2)
    ap.add_argument("--num-hidden", type=int, default=32)
    ap.add_argument("--num-embed", type=int, default=16)
    ap.add_argument("--num-epochs", type=int, default=3)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--optimizer", type=str, default="adam")
    ap.add_argument("--mom", type=float, default=0.0)
    ap.add_argument("--wd", type=float, default=1e-5)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--disp-batches", type=int, default=10)
    ap.add_argument("--data", type=str, default=None,
                    help="tokenized text file (one sentence per line); "
                         "synthetic corpus when omitted")
    ap.add_argument("--vocab-size", type=int, default=40,
                    help="synthetic corpus vocabulary size")
    ap.add_argument("--sentences", type=int, default=200,
                    help="synthetic corpus size")
    ap.add_argument("--buckets", type=str, default="8,12,16,20",
                    help="comma-separated bucket lengths")
    ap.add_argument("--fused", action="store_true",
                    help="one FusedRNNCell (the RNN op; the LSTM kernels on "
                         "the card) instead of a stack of LSTMCells")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights and of the batch order")
    args = ap.parse_args(argv)

    dev = context.resolve_device(args.device)
    mx_random.seed(args.seed)
    random.seed(args.seed)
    np.random.seed(args.seed)
    buckets = [int(b) for b in args.buckets.split(",")]
    start_label = 1
    invalid_label = 0
    with context.scope(dev):
        if args.data:
            train_sent, vocab = tokenize_text(
                args.data, start_label=start_label,
                invalid_label=invalid_label)
            val_sent = train_sent
        else:
            raw = synthetic_corpus(np.random.RandomState(0), args.sentences,
                                   args.vocab_size)
            train_sent, vocab = rnn.encode_sentences(
                raw, invalid_label=invalid_label, start_label=start_label)
            val_raw = synthetic_corpus(np.random.RandomState(1), 40,
                                       args.vocab_size)
            val_sent, _ = rnn.encode_sentences(
                val_raw, vocab=vocab, invalid_label=invalid_label)

        data_train = rnn.BucketSentenceIter(train_sent, args.batch_size,
                                            buckets=buckets,
                                            invalid_label=invalid_label)
        data_val = rnn.BucketSentenceIter(val_sent, args.batch_size,
                                          buckets=buckets,
                                          invalid_label=invalid_label)
        model = mod.BucketingModule(
            sym_gen=lm_sym_gen(len(vocab), args.num_embed, args.num_hidden,
                               args.num_layers, fused=args.fused),
            default_bucket_key=data_train.default_bucket_key, context=dev)
        model.fit(
            train_data=data_train,
            eval_data=data_val,
            eval_metric=metric.Perplexity(invalid_label),
            optimizer=args.optimizer,
            optimizer_params=dict(
                {"learning_rate": args.lr, "wd": args.wd},
                **({"momentum": args.mom} if args.optimizer == "sgd"
                   else {})),
            initializer=init.Xavier(factor_type="in", magnitude=2.34),
            num_epoch=args.num_epochs,
            batch_end_callback=callback.Speedometer(args.batch_size,
                                                    args.disp_batches))
        score = dict(model.score(data_val, metric.Perplexity(invalid_label)))
    ppl = score["perplexity"]
    print("final val perplexity: %.2f (vocab %d)" % (ppl, len(vocab)))
    return ppl


if __name__ == "__main__":
    main()
